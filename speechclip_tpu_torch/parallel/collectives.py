"""The collectives JAX's partitioner inserts, written out for a ``Mesh``
(``parallel/mesh.py``). Each is the identity on a mesh without a process
group (world 1, nothing initialized), and runs as a real collective on any
group, a group of one included. Every call reports ``(op, dtype, result
dims, what, axis)`` to the mesh's open inventories
(``parallel/inventory.py``). Only all-gather, all-reduce and broadcast are
used: gloo implements those for CPU and CUDA tensors alike (it has no CUDA
reduce-scatter).

The data axis. The batch's collectives (the loss's feature gather, kw-BN's
and the VQ's statistics, the gradients' mean) run over the rank's data
group: the ranks of one model rank, which hold different rows. A model
group's ranks hold the same rows, so a gather over the whole world would
repeat every row ``model`` times.

Which reduction makes the gradients exact. Every rank computes the same
global loss L from the gathered features, so the data ranks together
differentiate sum_r L = N * L. ``all_gather_rows``'s backward is the
gather's transpose on that sum: the gathered gradient summed over the data
ranks, then this rank's rows (an all-reduce and a slice);
``all_reduce_sum``'s backward is an all-reduce too. A trainable leaf's
gradients on the N data ranks then sum to N times the world-1 gradient, and
``all_reduce_mean`` (the train step's one flat reduction) divides by N.
The other pairing, a gather whose backward is a plain slice with a summing
gradient reduction, counts every leaf that is used after the gather on
every rank N times (the loss's trainable temperature, the VQ's), so it is
not used; tests/test_torch_data_parallel.py plants it and sees it fail.

The model axis (Megatron's four regions, each an autograd.Function and a
plain call under ``no_grad``): ``copy_to_model`` (identity; its backward
sums the input's gradient over the model group) at a column-parallel
layer's input, ``reduce_from_model`` (the f32 partial products summed over
the model group; backward identity) at a row-parallel layer's output,
``gather_from_model`` (the last axis's shards concatenated in model-rank
order; backward this rank's slice) for the attention heads before the
replicated out-projection, and ``scatter_to_model`` (this rank's slice of
the last axis; backward the gather) at a row-parallel layer whose input is
replicated (the RN50 attention pool's ``c_proj``). Every model rank
computes the same loss from the same replicated activations, so each
backward hands every rank the whole cotangent, and these four transposes
give each rank's shard its exact gradient with no division.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

from .mesh import Mesh


def _record(mesh: Mesh, op: str, dtype: torch.dtype, dims, what: str, axis: str) -> None:
    for inv in mesh.inventories:
        inv.add(op, dtype, dims, what, axis)


def _group(mesh: Mesh, axis: str):
    return {"data": mesh.data_group, "model": mesh.model_group, "world": mesh.group}[axis]


def _size(mesh: Mesh, axis: str) -> int:
    return {"data": mesh.data_size, "model": mesh.model_size, "world": mesh.world_size}[axis]


def _on_backend(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``t``, or its copy on the rank's card where NCCL cannot take it."""
    return t.to(mesh.device) if mesh.backend == "nccl" and t.device.type != "cuda" else t


def _all_reduce_(t: torch.Tensor, mesh: Mesh, what: str, axis: str = "data") -> torch.Tensor:
    """Sum ``t`` over the ranks of ``axis``, in place; -> ``t``."""
    buf = _on_backend(t, mesh)
    dist.all_reduce(buf, group=_group(mesh, axis))
    if buf is not t:
        t.copy_(buf)
    _record(mesh, "all-reduce", t.dtype, t.shape, what, axis)
    return t


def _gather(x: torch.Tensor, mesh: Mesh, what: str, axis: str = "data",
            dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    x = _on_backend(x.contiguous(), mesh)
    parts = [torch.empty_like(x) for _ in range(_size(mesh, axis))]
    dist.all_gather(parts, x, group=_group(mesh, axis))
    out = torch.cat(parts, dim=dim)
    _record(mesh, "all-gather", out.dtype, out.shape, what, axis)
    return out


def _own_slice(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This model rank's 1/M of the last axis."""
    n = x.shape[-1] // mesh.model_size
    return x.narrow(-1, mesh.model_rank * n, n)


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


def all_gather_rows(x: torch.Tensor, mesh: Mesh, what: str = "features") -> torch.Tensor:
    """The data ranks' (n, ...) rows stacked in rank order -> (N * n, ...)
    (JAX's tiled ``all_gather``). The gradient flows back through the
    gather when ``x`` requires one (see the module docstring)."""
    if mesh is None or not mesh.distributed:
        return x
    if x.requires_grad:
        return _AllGatherRows.apply(x, mesh, what)
    return _gather(x, mesh, what)


def all_reduce_sum(x: torch.Tensor, mesh: Mesh, what: str) -> torch.Tensor:
    """The sum of ``x`` over the data ranks (a new tensor); differentiable
    when ``x`` requires a gradient, whose backward sums over them too."""
    if mesh is None or not mesh.distributed:
        return x
    if x.requires_grad:
        return _AllReduceSum.apply(x, mesh, what)
    return _all_reduce_(x.clone(), mesh, what)


def all_reduce_mean(tensors: Sequence[torch.Tensor], mesh: Mesh,
                    what: str = "gradients") -> List[torch.Tensor]:
    """The mean over the data ranks of each of ``tensors`` (f32), through
    one flat all-reduce of them all; every rank gets the same values."""
    if mesh is None or not mesh.distributed or not tensors:
        return list(tensors)
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    _all_reduce_(flat, mesh, what).div_(mesh.data_size)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, what):
        ctx.mesh, ctx.what = mesh, what
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.contiguous().clone(), ctx.mesh, f"{ctx.what} gradient",
                            "model"), None, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, what):
        return _all_reduce_(x.clone(), mesh, what, "model")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, what):
        ctx.mesh = mesh
        return _gather(x, mesh, what, "model", dim=-1)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, ctx.mesh), None, None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, what):
        ctx.mesh, ctx.what = mesh, what
        return _own_slice(x, mesh).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mesh, f"{ctx.what} gradient", "model", dim=-1), None, None


def _differentiable(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def copy_to_model(x: torch.Tensor, mesh: Mesh, what: str = "activations") -> torch.Tensor:
    """A column-parallel layer's replicated input: ``x`` itself; its
    gradient is summed over the model group."""
    return _CopyToModel.apply(x, mesh, what) if _differentiable(x) else x


def reduce_from_model(x: torch.Tensor, mesh: Mesh, what: str = "activations") -> torch.Tensor:
    """A row-parallel layer's partial products summed over the model group
    (a new tensor, in ``x``'s dtype: the callers pass f32)."""
    if _differentiable(x):
        return _ReduceFromModel.apply(x, mesh, what)
    return _all_reduce_(x.contiguous(), mesh, what, "model")


def gather_from_model(x: torch.Tensor, mesh: Mesh, what: str = "heads") -> torch.Tensor:
    """The model ranks' shards of the last axis concatenated in rank order."""
    if _differentiable(x):
        return _GatherFromModel.apply(x, mesh, what)
    return _gather(x, mesh, what, "model", dim=-1)


def scatter_to_model(x: torch.Tensor, mesh: Mesh, what: str = "activations") -> torch.Tensor:
    """This model rank's 1/M of a replicated input's last axis."""
    if _differentiable(x):
        return _ScatterToModel.apply(x, mesh, what)
    return _own_slice(x, mesh)


def broadcast_tree(tree, mesh: Mesh, what: str, src: int = 0):
    """Every tensor of ``tree`` overwritten in place with world rank
    ``src``'s values (one broadcast per dtype and device, over a flat copy); -> the
    tree."""
    if mesh is None or not mesh.distributed:
        return tree
    groups = {}
    for t in _tensors(tree):
        groups.setdefault((t.dtype, t.device), []).append(t)
    for (dtype, _), ts in groups.items():
        flat = _on_backend(torch.cat([t.detach().reshape(-1) for t in ts]), mesh)
        dist.broadcast(flat, src=src, group=mesh.group)
        _record(mesh, "broadcast", dtype, flat.shape, what, "world")
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


def agree(values: Sequence[int], mesh: Mesh, what: str) -> None:
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


def barrier(mesh: Mesh) -> None:
    """Wait until every rank gets here."""
    if mesh is not None and mesh.distributed:
        dist.all_reduce(torch.zeros(1, device=mesh.device), group=mesh.group)
