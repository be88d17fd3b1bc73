"""Keyword BatchNorm (port of speechclip_tpu/ops/kw_bn.py): the keywords
are normalized, then scaled and shifted; the scale and shift start from the
CLIP token-embedding table's std and mean. At eval the running statistics
normalize; in train mode the f32 batch statistics do (the biased variance,
optionally over 0/1 row weights), and the running statistics move by
momentum 0.1 toward the batch mean and the unbiased batch variance, as
torch's BatchNorm. ``replica_groups = G`` splits the batch into G
contiguous groups normalized with their own statistics (torch-DP's
replicas); the running statistics follow group 0's (the replica whose
buffers persist).

Under data parallelism (a ``DataMesh``) the statistics are the global
batch's, as JAX's sharded step computes them, with JAX's two passes: the
f32 sums (and the row counts) are all-reduced for the mean, then the
squared deviations from it for the variance. Each rank sums its rows into a
(G, C) buffer, one row a group, holding the groups its rows fall in, so one
all-reduce a pass serves every G that divides the global batch, whether a
group lies inside a rank or spans ranks. Every rank ends with the same
running statistics.

Layouts (``batchnorm_type``):
- ``eachKw`` + ``parallel``: one BN over the (B, D, K) -> (B, D*K) view,
  feature index ``d*K + k``. The scale is initialized by tiling the std
  vector K times, so feature ``d*K + k`` starts at ``std[(d*K + k) % D]``,
  not ``std[d]`` (speechclip_tpu/ops/kw_bn.py:32); kept as the reference
  has it.
- ``eachKw``: K independent BNs over D, parameters (K, D).
- ``same``: one BN over D shared by every keyword; with ``seq_lens`` the
  statistics count only each row's valid keywords (the reference's
  variable-length path).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from ..parallel.collectives import all_reduce_sum
from .basic import Params
from .masking import valid_mask

EPS = 1e-5
MOMENTUM = 0.1


def kw_bn_init(
    kw_num: int,
    kw_dim: int,
    batchnorm_type: str,
    init_bias: torch.Tensor,  # (D,) token-embedding mean
    init_scale: torch.Tensor,  # (D,) token-embedding std (unbiased)
    std_scale: Union[float, Sequence[float]] = 1.0,
    parallel: bool = False,
) -> Tuple[Params, Params]:
    """-> (params {scale, bias}, state {mean, var}), f32."""
    if not isinstance(std_scale, (list, tuple)):
        std_scale = [std_scale] * kw_num
    init_bias, init_scale = init_bias.float(), init_scale.float()
    if batchnorm_type == "eachKw" and parallel:
        scale = (init_scale * std_scale[0]).repeat(kw_num)  # (D*K,)
        bias = init_bias.repeat(kw_num)
    elif batchnorm_type == "eachKw":
        scale = torch.stack([init_scale * std_scale[i] for i in range(kw_num)])  # (K, D)
        bias = init_bias.expand(kw_num, kw_dim).clone()
    elif batchnorm_type == "same":
        scale, bias = init_scale * std_scale[0], init_bias.clone()
    else:
        raise NotImplementedError(batchnorm_type)
    return {"scale": scale, "bias": bias}, {
        "mean": torch.zeros_like(scale), "var": torch.ones_like(scale),
    }


class _Groups:
    """Rows ``start .. start + m`` of a ``total``-row batch split into
    ``groups`` contiguous groups: which groups they fall in, and per-group
    reductions and broadcasts over them (slices, reshapes and expands only,
    so the sums and their gradients add in a fixed order)."""

    def __init__(self, start: int, m: int, total: int, groups: int):
        self.size = size = total // groups
        self.groups = groups
        self.first, self.last = start // size, (start + m - 1) // size
        self.whole = start % size == 0 and m % size == 0  # whole groups only
        self.segments = [(g, max(g * size, start) - start, min((g + 1) * size, start + m) - start)
                         for g in range(self.first, self.last + 1)]

    def sums(self, v: torch.Tensor) -> torch.Tensor:
        """(m, C) -> (groups, C): each group's sum over these rows, zeros
        for the groups they miss."""
        if self.whole:
            part = v.reshape(-1, self.size, v.shape[1]).sum(dim=1)
        else:
            part = torch.stack([v[lo:hi].sum(dim=0) for _, lo, hi in self.segments])
        return torch.nn.functional.pad(part, (0, 0, self.first, self.groups - 1 - self.last))

    def apply(self, op, v: torch.Tensor, stat: torch.Tensor) -> torch.Tensor:
        """(m, C) rows combined by ``op`` with their group's (C,) row of
        ``stat`` (groups, C)."""
        if self.whole:
            rows = v.reshape(-1, self.size, v.shape[1])
            return op(rows, stat[self.first:self.last + 1, None]).reshape(v.shape)
        return torch.cat([op(v[lo:hi], stat[g]) for g, lo, hi in self.segments])


def _bn(x: torch.Tensor, params: Params, state: Params, train: bool,
        weights: Optional[torch.Tensor] = None, groups: int = 0,
        mesh=None) -> Tuple[torch.Tensor, Params]:
    """(N, C) -> ((N, C) in ``x.dtype``, the new state), computed in f32.
    ``weights``: (N,) 0/1 row weights for the batch statistics; ``groups``:
    per-group batch statistics over G contiguous groups of rows; ``mesh``:
    ``x`` is this rank's shard of the global batch."""
    x32 = x.float()
    if not train:
        y = (x32 - state["mean"].float()) / torch.sqrt(state["var"].float() + EPS)
        return (y * params["scale"].float() + params["bias"].float()).to(x.dtype), state
    g = max(groups, 1)
    m = x.shape[0]
    world, rank = (mesh.data_size, mesh.data_rank) if mesh is not None else (1, 0)
    if (m * world) % g:
        raise ValueError(f"{m * world} rows not divisible by replica_groups {groups}")
    part = _Groups(m * rank, m, m * world, g)
    w = torch.ones((m, 1), device=x.device) if weights is None else weights.float()[:, None]
    # pass 1: the sums and the row counts; a fully padded group normalizes to zeros, not NaN
    sums = all_reduce_sum(part.sums(torch.cat([x32 * w, w], dim=1)), mesh, "kw_bn")
    n = sums[:, -1:].clamp(min=1.0)  # (G, 1)
    mean = sums[:, :-1] / n
    centered = part.apply(torch.sub, x32, mean)
    # pass 2: the squared deviations from the global mean
    var = all_reduce_sum(part.sums(centered.square() * w), mesh, "kw_bn") / n
    n0 = n[0, 0]
    unbiased0 = var[0] * (n0 / (n0 - 1).clamp(min=1.0))
    new_state = {
        "mean": (1 - MOMENTUM) * state["mean"] + MOMENTUM * mean[0].detach(),
        "var": (1 - MOMENTUM) * state["var"] + MOMENTUM * unbiased0.detach(),
    }
    y = part.apply(torch.mul, centered, torch.rsqrt(var + EPS))
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype), new_state


def kw_bn_apply(
    params: Params,
    state: Params,
    keywords: torch.Tensor,  # (B, K, D)
    *,
    batchnorm_type: str,
    parallel: bool = False,
    train: bool = False,
    replica_groups: int = 0,
    seq_lens: Optional[torch.Tensor] = None,
    mesh=None,
) -> Tuple[torch.Tensor, Params]:
    """kw-BN -> ((B, K, D) in ``keywords.dtype``, the new state: the running
    statistics updated in train mode, ``state`` itself at eval).
    ``seq_lens`` (B,), ``same`` only: the statistics over each row's first
    ``seq_lens`` keywords, counted over the global batch; the others pass
    through unchanged. ``mesh``: ``keywords`` is this rank's shard, the
    statistics the global batch's."""
    b, k, d = keywords.shape
    groups = replica_groups if train else 0
    world = mesh.data_size if mesh is not None else 1
    if groups > 1 and (b * world) % groups:
        raise ValueError(f"batch {b * world} not divisible by replica_groups {groups}")
    if batchnorm_type == "eachKw" and parallel:
        flat = keywords.transpose(1, 2).reshape(b, d * k)
        out, new_state = _bn(flat, params, state, train, groups=groups, mesh=mesh)
        return out.reshape(b, d, k).transpose(1, 2), new_state
    if batchnorm_type == "eachKw":
        # K independent BNs over D: one BN over the K * D columns of the
        # (B, K * D) view, row i of the (K, D) parameters at columns i * D ..
        flat = lambda tree: {n: t.reshape(k * d) for n, t in tree.items()}
        out, new_state = _bn(keywords.reshape(b, k * d), flat(params), flat(state), train,
                             groups=groups, mesh=mesh)
        if not train:
            new_state = state
        else:
            new_state = {n: t.reshape(k, d) for n, t in new_state.items()}
        return out.reshape(b, k, d), new_state
    if batchnorm_type == "same":
        mask = None if seq_lens is None else valid_mask(seq_lens, k)  # (B, K)
        out, new_state = _bn(keywords.reshape(b * k, d), params, state, train,
                             weights=None if mask is None else mask.reshape(-1), groups=groups,
                             mesh=mesh)
        out = out.reshape(b, k, d)
        if mask is not None:
            out = torch.where(mask[..., None], out, keywords)
        return out, new_state
    raise NotImplementedError(batchnorm_type)
