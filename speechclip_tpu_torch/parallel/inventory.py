"""The collectives a step issues, recorded where they are called (the
port's counterpart of speechclip_tpu/parallel/hlo_inspect.py).

JAX reads its collectives out of the compiled HLO; torch has no HLO, so
each collective of ``parallel/collectives.py`` reports ``(op, dtype,
result dims)`` to the inventories open on its mesh:

    with recording(mesh) as inv:
        state, metrics = train_step(state, batch)
    inv.collective_bytes()   # {"all-gather": (count, bytes), "all-reduce": ...}

in JAX's forms and names (``all-gather``, ``all-reduce``; dtype names
``f32``, ``bf16``, ``s32``...), and each entry also carries what was moved
(``features``, ``gradients``, ``kw_bn``...). The collectives run in
backward passes too, so the recording spans the whole step.

``kernels/_dispatch.py`` (JAX's ``shard_map`` of each Pallas kernel over
the mesh, ``mesh_plan``) has no counterpart either: each rank calls its own
kernels on its own rows, as ``mesh_plan`` does per shard.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Tuple

import torch

DTYPE_NAMES = {
    torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
    torch.int64: "s64", torch.int32: "s32", torch.int16: "s16", torch.int8: "s8",
    torch.uint8: "u8", torch.bool: "pred",
}
DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "s32": 4, "u32": 4, "s16": 2,
               "u16": 2, "s8": 1, "u8": 1, "pred": 1}

Entry = Tuple[str, str, Tuple[int, ...], str]  # (op, dtype, result dims, what)


class CollectiveInventory:
    def __init__(self):
        self.entries: List[Entry] = []

    def add(self, op: str, dtype: torch.dtype, dims, what: str) -> None:
        self.entries.append((op, DTYPE_NAMES[dtype], tuple(int(d) for d in dims), what))

    def collective_results(self) -> List[Tuple[str, str, Tuple[int, ...]]]:
        """[(op, dtype, result dims)] in call order (JAX's form)."""
        return [(op, dt, dims) for op, dt, dims, _ in self.entries]

    def collective_bytes(self) -> Dict[str, Tuple[int, int]]:
        """{op: (count, total result bytes)} (JAX's form)."""
        inv: Dict[str, Tuple[int, int]] = {}
        for op, dt, dims, _ in self.entries:
            n = 1
            for d in dims:
                n *= d
            cnt, byt = inv.get(op, (0, 0))
            inv[op] = (cnt + 1, byt + n * DTYPE_BYTES[dt])
        return inv


@contextlib.contextmanager
def recording(mesh) -> Iterator[CollectiveInventory]:
    """An inventory of every collective ``mesh`` issues inside the block."""
    inv = CollectiveInventory()
    mesh.inventories.append(inv)
    try:
        yield inv
    finally:
        mesh.inventories.remove(inv)
