"""The collectives JAX's partitioner inserts, written out for a
``DataMesh`` (``parallel/mesh.py``). Each is the identity on a mesh
without a process group (world 1, nothing initialized), and runs as a real
collective on any group, a world of one included. Every call reports
``(op, dtype, result dims)`` to the mesh's open inventories
(``parallel/inventory.py``). Only all-gather, all-reduce and broadcast are
used: gloo implements those for CPU and CUDA tensors alike (it has no CUDA
reduce-scatter).

Which reduction makes the gradients exact. Every rank computes the same
global loss L from the gathered features, so the ranks together
differentiate sum_r L = N * L. ``all_gather_rows``'s backward is the
gather's transpose on that sum: the gathered gradient summed over ranks,
then this rank's rows (an all-reduce and a slice); ``all_reduce_sum``'s
backward is an all-reduce too. A trainable leaf's gradients on the N ranks
then sum to N times the world-1 gradient, and ``all_reduce_mean`` (the
train step's one flat reduction) divides by N. The other pairing, a gather
whose backward is a plain slice with a summing gradient reduction, counts
every leaf that is used after the gather on every rank N times (the
loss's trainable temperature, the VQ's), so it is not used;
tests/test_torch_data_parallel.py plants it and sees it fail.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

from .mesh import DataMesh


def _record(mesh: DataMesh, op: str, dtype: torch.dtype, dims, what: str) -> None:
    for inv in mesh.inventories:
        inv.add(op, dtype, dims, what)


def _on_backend(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """``t``, or its copy on the rank's card where NCCL cannot take it."""
    return t.to(mesh.device) if mesh.backend == "nccl" and t.device.type != "cuda" else t


def _all_reduce_(t: torch.Tensor, mesh: DataMesh, what: str) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place; -> ``t``."""
    buf = _on_backend(t, mesh)
    dist.all_reduce(buf, group=mesh.group)
    if buf is not t:
        t.copy_(buf)
    _record(mesh, "all-reduce", t.dtype, t.shape, what)
    return t


def _gather(x: torch.Tensor, mesh: DataMesh, what: str) -> torch.Tensor:
    x = _on_backend(x.contiguous(), mesh)
    parts = [torch.empty_like(x) for _ in range(mesh.world_size)]
    dist.all_gather(parts, x, group=mesh.group)
    out = torch.cat(parts)
    _record(mesh, "all-gather", out.dtype, out.shape, what)
    return out


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, what):
        ctx.mesh, ctx.what = mesh, what
        return _gather(x, mesh, what)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce_(g.contiguous().clone(), ctx.mesh, f"{ctx.what} gradient")
        return g[ctx.mesh.rows(g.shape[0])], None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, what):
        ctx.mesh, ctx.what = mesh, what
        return _all_reduce_(x.clone(), mesh, what)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.contiguous().clone(), ctx.mesh, f"{ctx.what} gradient"), None, None


def all_gather_rows(x: torch.Tensor, mesh: DataMesh, what: str = "features") -> torch.Tensor:
    """The ranks' (n, ...) rows stacked in rank order -> (N * n, ...)
    (JAX's tiled ``all_gather``). The gradient flows back through the
    gather when ``x`` requires one (see the module docstring)."""
    if mesh is None or not mesh.distributed:
        return x
    if x.requires_grad:
        return _AllGatherRows.apply(x, mesh, what)
    return _gather(x, mesh, what)


def all_reduce_sum(x: torch.Tensor, mesh: DataMesh, what: str) -> torch.Tensor:
    """The sum of ``x`` over the ranks (a new tensor); differentiable when
    ``x`` requires a gradient, whose backward sums over the ranks too."""
    if mesh is None or not mesh.distributed:
        return x
    if x.requires_grad:
        return _AllReduceSum.apply(x, mesh, what)
    return _all_reduce_(x.clone(), mesh, what)


def all_reduce_mean(tensors: Sequence[torch.Tensor], mesh: DataMesh,
                    what: str = "gradients") -> List[torch.Tensor]:
    """The mean over the ranks of each of ``tensors`` (f32), through one
    flat all-reduce of them all; every rank gets the same values."""
    if mesh is None or not mesh.distributed or not tensors:
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    _all_reduce_(flat, mesh, what).div_(mesh.world_size)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def broadcast_tree(tree, mesh: DataMesh, what: str, src: int = 0):
    """Every tensor of ``tree`` overwritten in place with rank ``src``'s
    values (one broadcast per dtype and device, over a flat copy); -> the
    tree."""
    if mesh is None or not mesh.distributed:
        return tree
    groups = {}
    for t in _tensors(tree):
        groups.setdefault((t.dtype, t.device), []).append(t)
    for (dtype, _), ts in groups.items():
        flat = _on_backend(torch.cat([t.detach().reshape(-1) for t in ts]), mesh)
        dist.broadcast(flat, src=src, group=mesh.group)
        _record(mesh, "broadcast", dtype, flat.shape, what)
        at = 0
        with torch.no_grad():
            for t in ts:
                t.copy_(flat[at:at + t.numel()].view(t.shape))
                at += t.numel()
    return tree


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif torch.is_tensor(tree):
        yield tree


def agree(values: Sequence[int], mesh: DataMesh, what: str) -> None:
    """Raise on every rank unless every rank passed the same ``values``."""
    if mesh is None or not mesh.distributed:
        return
    t = torch.tensor(list(values), dtype=torch.int64)
    t = _on_backend(t, mesh)
    lo, hi = t.clone(), t.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=mesh.group)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=mesh.group)
    if not torch.equal(lo, hi):
        raise RuntimeError(f"the ranks disagree on {what}: {t.tolist()} on rank {mesh.rank}, "
                           f"range {lo.tolist()} .. {hi.tolist()}")


def barrier(mesh: DataMesh) -> None:
    """Wait until every rank gets here."""
    if mesh is not None and mesh.distributed:
        dist.all_reduce(torch.zeros(1, device=mesh.device), group=mesh.group)
