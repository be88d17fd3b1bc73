"""The ``(data, model)`` world (port of speechclip_tpu/parallel/mesh.py).

JAX lays its devices out as a ``("data", "model")`` grid and lets GSPMD
insert the collectives. The port's counterpart is a ``torch.distributed``
world of ``data * model`` ranks: one process a rank, one device a process,
in JAX's grid order (``reshape(data, model)``: world rank ``r`` is data
rank ``r // model`` and model rank ``r % model``). The ranks of one data
rank (a model group) hold the same rows of the global batch and split the
big towers' matrices between them (``parallel/tensor.py``); the ranks of
one model rank (a data group) hold different rows (``shard_batch``: rows
``[d*n, (d+1)*n)``, JAX's ``P("data")`` split), run their own kernels on
them, and join only where JAX's partitioner puts a collective
(``parallel/collectives.py``): the loss's feature all-gather, the global
kw-BN and VQ statistics, the trainable gradients' reduction.

    mesh = make_mesh()                         # world 1 unless a group exists
    mesh = make_mesh(devices=["cuda:0", "cuda:1"])  # inside a world of 2
    mesh = make_mesh(devices=["cpu"] * 4, model=2)  # (data 2, model 2)

A process group comes from PyTorch's own idiom: ``torch.distributed.
init_process_group`` over the ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` /
``MASTER_PORT`` environment that ``torchrun`` sets (``join_env_world``), or
over a ``file://`` rendezvous that ``spawn`` makes for N processes of its
own. The backend is NCCL for CUDA devices and gloo for the CPU (or where
asked: gloo also takes CUDA tensors for the collectives used here). One
device and no group is world 1: nothing is initialized and the collectives
are the identity. No fallback: a world larger than the devices given, a
world that does not divide by ``model``, or a model axis without a world
raises, and a CUDA mesh stays on its card whatever the backend.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

ENV_KEYS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


@dataclasses.dataclass
class Mesh:
    """One rank's view of the ``(data, model)`` world."""

    rank: int  # the world rank
    world_size: int
    device: torch.device  # this rank's device
    group: Any = None  # the world's process group; None: world 1, no collectives
    backend: Optional[str] = None
    # active CollectiveInventory recorders (parallel/inventory.py)
    inventories: List[Any] = dataclasses.field(default_factory=list, repr=False)
    model_size: int = 1  # the model axis; the data axis is world_size // model_size
    data_group: Any = None  # the ranks of this model rank (default: the world's group)
    model_group: Any = None  # the ranks of this data rank; None at model_size 1

    def __post_init__(self):
        if self.world_size % self.model_size:
            raise ValueError(f"a world of {self.world_size} rank(s) does not split into "
                             f"model groups of {self.model_size}")
        if self.data_group is None and self.model_size == 1:
            self.data_group = self.group

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def data_size(self) -> int:
        return self.world_size // self.model_size

    @property
    def data_rank(self) -> int:
        return self.rank // self.model_size

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_size

    def rows(self, n_global: int) -> slice:
        """This rank's rows of a global batch of ``n_global`` rows (its data
        rank's: the ranks of a model group hold the same rows)."""
        if n_global % self.data_size:
            raise ValueError(f"a batch of {n_global} rows does not split over "
                             f"{self.data_size} ranks")
        n = n_global // self.data_size
        return slice(self.data_rank * n, (self.data_rank + 1) * n)


DataMesh = Mesh  # the name the data-parallel callers use


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


def _subgroups(world: int, model: int) -> Tuple[Any, Any]:
    """-> (this rank's data group, its model group). Every rank creates
    every subgroup, in one order (the data groups, then the model groups),
    as ``dist.new_group`` requires; a rank keeps the two it belongs to."""
    rank = dist.get_rank()
    data_group = model_group = None
    for m in range(model):
        g = dist.new_group(list(range(m, world, model)))
        if rank % model == m:
            data_group = g
    for d in range(world // model):
        g = dist.new_group(list(range(d * model, (d + 1) * model)))
        if rank // model == d:
            model_group = g
    return data_group, model_group


def make_mesh(devices: Optional[Sequence] = None, data: Optional[int] = None,
              model: int = 1) -> Mesh:
    """This process's ``Mesh``. With an initialized process group the world
    is the group's, laid out as ``(world // model, model)`` (``data``, where
    given, must equal ``world // model``); without one it is world 1, where
    ``model`` must be 1. ``devices``: the devices by world rank (JAX's
    device list; rank r takes ``devices[r]``); None: this rank's card
    (``cuda:{LOCAL_RANK}``). Under ``model > 1`` every rank must call this
    together: it creates the subgroups."""
    model = int(model)
    if model < 1:
        raise ValueError(f"model={model}: the model axis has at least one rank")
    joined = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if joined else 1
    rank = dist.get_rank() if joined else 0
    if world % model:
        raise ValueError(f"model={model} does not divide the world of {world} rank(s) "
                         "(start a multiple of model processes: torchrun, or the CLI's "
                         "--devices)")
    if data is not None and int(data) != world // model:
        raise ValueError(f"data={data} but the world has {world} rank(s) at model={model}: "
                         f"start {int(data) * model} processes (torchrun, or the CLI's "
                         "--devices)")
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
        return Mesh(rank=0, world_size=1, device=device)
    backend = dist.get_backend()
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the NCCL group cannot serve {device}")
    data_group, model_group = (_subgroups(world, model) if model > 1
                               else (dist.group.WORLD, None))
    return Mesh(rank=rank, world_size=world, device=device, group=dist.group.WORLD,
                backend=backend, model_size=model, data_group=data_group,
                model_group=model_group)


def join_env_world(backend: str) -> bool:
    """Initialize the default process group from a ``torchrun``
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``)
    where one is set and no group exists yet; -> whether it initialized one
    (the caller then ends it with ``dist.destroy_process_group``)."""
    if dist.is_initialized() or not all(k in os.environ for k in ENV_KEYS):
        return False
    dist.init_process_group(backend, init_method="env://")
    return True


def shard_batch(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's contiguous rows of every array of a global batch (numpy
    arrays or tensors: its data rank's); one data rank returns the batch
    itself."""
    if mesh.data_size == 1:
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
