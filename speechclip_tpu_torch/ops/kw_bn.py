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

Layouts (``batchnorm_type``):
- ``eachKw`` + ``parallel``: one BN over the (B, D, K) -> (B, D*K) view,
  feature index ``d*K + k``. The scale is initialized by tiling the std
  vector K times, so feature ``d*K + k`` starts at ``std[(d*K + k) % D]``,
  not ``std[d]`` (speechclip_tpu/ops/kw_bn.py:32); kept as the reference
  has it.
- ``eachKw``: K independent BNs over D, parameters (K, D).
- ``same``: one BN over D shared by every keyword.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from .basic import Params

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


def _bn(x: torch.Tensor, params: Params, state: Params, train: bool,
        weights: Optional[torch.Tensor] = None, groups: int = 0) -> Tuple[torch.Tensor, Params]:
    """(N, C) -> ((N, C) in ``x.dtype``, the new state), computed in f32.
    ``weights``: (N,) 0/1 row weights for the batch statistics; ``groups``:
    per-group batch statistics over G contiguous groups of rows."""
    x32 = x.float()
    if not train:
        y = (x32 - state["mean"].float()) / torch.sqrt(state["var"].float() + EPS)
        return (y * params["scale"].float() + params["bias"].float()).to(x.dtype), state
    g = max(groups, 1)
    if x.shape[0] % g:
        raise ValueError(f"{x.shape[0]} rows not divisible by replica_groups {groups}")
    xg = x32.reshape(g, x.shape[0] // g, -1)  # (G, n, C)
    if weights is None:
        n = torch.full((g, 1), float(xg.shape[1]), device=x.device)
        mean = xg.mean(dim=1)
        var = (xg - mean[:, None]).square().mean(dim=1)
    else:
        w = weights.float().reshape(g, -1, 1)
        # a fully padded group normalizes to zeros, not NaN
        n = w.sum(dim=1).clamp(min=1.0)  # (G, 1)
        mean = (xg * w).sum(dim=1) / n
        var = ((xg - mean[:, None]).square() * w).sum(dim=1) / n
    n0 = n[0, 0]
    unbiased0 = var[0] * (n0 / (n0 - 1).clamp(min=1.0))
    new_state = {
        "mean": (1 - MOMENTUM) * state["mean"] + MOMENTUM * mean[0].detach(),
        "var": (1 - MOMENTUM) * state["var"] + MOMENTUM * unbiased0.detach(),
    }
    y = (xg - mean[:, None]) * torch.rsqrt(var[:, None] + EPS)
    y = y.reshape(x.shape) * params["scale"].float() + params["bias"].float()
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
) -> Tuple[torch.Tensor, Params]:
    """kw-BN -> ((B, K, D) in ``keywords.dtype``, the new state: the running
    statistics updated in train mode, ``state`` itself at eval)."""
    b, k, d = keywords.shape
    groups = replica_groups if train else 0
    if groups > 1 and b % groups:
        raise ValueError(f"batch {b} not divisible by replica_groups {groups}")
    if batchnorm_type == "eachKw" and parallel:
        flat = keywords.transpose(1, 2).reshape(b, d * k)
        out, new_state = _bn(flat, params, state, train, groups=groups)
        return out.reshape(b, d, k).transpose(1, 2), new_state
    if batchnorm_type == "eachKw":
        # K independent BNs: keyword i reads row i of the (K, D) parameters
        outs, states = [], []
        for i in range(k):
            out, st = _bn(keywords[:, i], {n: t[i] for n, t in params.items()},
                          {n: t[i] for n, t in state.items()}, train, groups=groups)
            outs.append(out)
            states.append(st)
        new_state = state if not train else {
            n: torch.stack([st[n] for st in states]) for n in state}
        return torch.stack(outs, dim=1), new_state
    if batchnorm_type == "same":
        out, new_state = _bn(keywords.reshape(b * k, d), params, state, train, groups=groups)
        return out.reshape(b, k, d), new_state
    raise NotImplementedError(batchnorm_type)
