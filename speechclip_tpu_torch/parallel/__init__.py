"""Data parallelism on ``torch.distributed`` (port of speechclip_tpu/parallel/):
the world (``mesh.py``), the collectives JAX's partitioner inserts
(``collectives.py``) and their inventory (``inventory.py``, in
``hlo_inspect.py``'s place)."""

from .mesh import DataMesh, TP_ITEM, join_env_world, make_mesh, shard_batch, spawn

__all__ = ["DataMesh", "TP_ITEM", "join_env_world", "make_mesh", "shard_batch", "spawn"]
