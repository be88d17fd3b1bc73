"""The data-parallel world (port of speechclip_tpu/parallel/mesh.py).

JAX lays its devices out as a ``("data", "model")`` mesh and lets GSPMD
insert the collectives. The port's counterpart of the ``data`` axis is a
``torch.distributed`` world: one process a rank, one device a process. A
rank holds its contiguous rows of the global batch (``shard_batch``: rows
``[r*n, (r+1)*n)``, JAX's ``P("data")`` split), runs its own kernels on them,
and joins the other ranks only where JAX's partitioner puts a collective
(``parallel/collectives.py``): the loss's feature all-gather, the global
kw-BN and VQ statistics, the trainable gradients' reduction.

    mesh = make_mesh()                         # world 1 unless a group exists
    mesh = make_mesh(devices=["cuda:0", "cuda:1"])  # inside a world of 2

A process group comes from PyTorch's own idiom: ``torch.distributed.
init_process_group`` over the ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` /
``MASTER_PORT`` environment that ``torchrun`` sets (``join_env_world``), or
over a ``file://`` rendezvous that ``spawn`` makes for N processes of its
own. The backend is NCCL for CUDA devices and gloo for the CPU (or where
asked: gloo also takes CUDA tensors for the collectives used here). One
device and no group is world 1: nothing is initialized and the collectives
are the identity. No fallback: a world larger than the devices given
raises, and a CUDA mesh stays on its card whatever the backend.

The ``model`` axis (tensor parallelism of the frozen towers, JAX's
``param_partition_specs``) is not ported: ``model > 1`` raises, naming its
ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

TP_ITEM = "the ROADMAP item 'the model axis' (Queue 1 item 9: tensor parallelism of the frozen towers)"
ENV_KEYS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass
class DataMesh:
    """One rank's view of the data-parallel world."""

    rank: int
    world_size: int
    device: torch.device  # this rank's device
    group: Any = None  # the process group; None: world 1, no collectives
    backend: Optional[str] = None
    # active CollectiveInventory recorders (parallel/inventory.py)
    inventories: List[Any] = dataclasses.field(default_factory=list, repr=False)

    @property
    def distributed(self) -> bool:
        return self.group is not None

    def rows(self, n_global: int) -> slice:
        """This rank's rows of a global batch of ``n_global`` rows."""
        if n_global % self.world_size:
            raise ValueError(f"a batch of {n_global} rows does not split over "
                             f"{self.world_size} ranks")
        n = n_global // self.world_size
        return slice(self.rank * n, (self.rank + 1) * n)


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _own_card() -> torch.device:
    """``cuda:{LOCAL_RANK}`` (the rank when unset); raises without that card."""
    index = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if index >= found:
        raise RuntimeError(f"rank device cuda:{index} requested, {found} CUDA device(s) found: "
                           "pass devices=['cpu', ...] to run on the CPU")
    return torch.device("cuda", index)


def make_mesh(devices: Optional[Sequence] = None, data: Optional[int] = None,
              model: int = 1) -> DataMesh:
    """This process's ``DataMesh``. With an initialized process group the
    world is the group's (``data``, where given, must equal its size);
    without one it is world 1. ``devices``: the devices by rank (JAX's
    device list; rank r takes ``devices[r]``); None: this rank's card
    (``cuda:{LOCAL_RANK}``)."""
    if int(model) > 1:
        raise NotImplementedError(f"model={model}: the port's mesh has no model axis; "
                                  f"it waits for {TP_ITEM}")
    joined = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if joined else 1
    rank = dist.get_rank() if joined else 0
    if data is not None and int(data) != world:
        raise ValueError(f"data={data} but the world has {world} rank(s): start {data} "
                         "processes (torchrun, or the CLI's --devices)")
    if devices is None:
        device = _own_card()
    else:
        devices = list(devices)
        if len(devices) < world:
            raise ValueError(f"a world of {world} ranks needs {world} devices, "
                             f"{len(devices)} given")
        device = torch.device(devices[rank])
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices=['cpu'] to run on the CPU")
        if device.index is not None:
            torch.cuda.set_device(device)  # "cuda" means this rank's card from here on
    if not joined:
        return DataMesh(rank=0, world_size=1, device=device)
    backend = dist.get_backend()
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the NCCL group cannot serve {device}")
    return DataMesh(rank=rank, world_size=world, device=device, group=dist.group.WORLD,
                    backend=backend)


def join_env_world(backend: str) -> bool:
    """Initialize the default process group from a ``torchrun``
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``)
    where one is set and no group exists yet; -> whether it initialized one
    (the caller then ends it with ``dist.destroy_process_group``)."""
    if dist.is_initialized() or not all(k in os.environ for k in ENV_KEYS):
        return False
    dist.init_process_group(backend, init_method="env://")
    return True


def shard_batch(batch: Dict[str, Any], mesh: DataMesh) -> Dict[str, Any]:
    """This rank's contiguous rows of every array of a global batch (numpy
    arrays or tensors); world 1 returns the batch itself."""
    if mesh.world_size == 1:
        return batch
    return {k: v[mesh.rows(len(v))] for k, v in batch.items()}


def _rank_main(rank: int, world: int, backend: str, init_method: str, fn: Callable,
               args: tuple) -> None:
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    torch.set_num_threads(max(1, torch.get_num_threads() // world))  # the ranks share the cores
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, backend: str, args: tuple = ()) -> None:
    """Run ``fn(rank, *args)`` in ``world`` new processes (the ``spawn``
    start method), each a rank of one process group over a ``file://``
    rendezvous in a fresh temporary directory (no port to clash over), and
    wait for them; a rank's exception is raised here. ``fn`` must be
    importable by name."""
    tmp = tempfile.mkdtemp(prefix="scl_world_")
    try:
        torch.multiprocessing.spawn(
            _rank_main, args=(world, backend, f"file://{os.path.join(tmp, 'rendezvous')}", fn,
                              tuple(args)), nprocs=world, join=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
