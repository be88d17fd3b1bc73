"""Data and tensor parallelism on ``torch.distributed`` (port of
speechclip_tpu/parallel/): the ``(data, model)`` world (``mesh.py``), the
collectives JAX's partitioner inserts (``collectives.py``), their inventory
(``inventory.py``, in ``hlo_inspect.py``'s place) and the model axis's
parameter layout and layers (``tensor.py``)."""

from .mesh import DataMesh, Mesh, join_env_world, make_mesh, shard_batch, spawn

__all__ = ["DataMesh", "Mesh", "join_env_world", "make_mesh", "shard_batch", "spawn"]
