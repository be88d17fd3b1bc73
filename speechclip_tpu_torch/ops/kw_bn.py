"""Keyword BatchNorm at eval (port of speechclip_tpu/ops/kw_bn.py): the
keywords are normalized with the running statistics, then scaled and
shifted; the scale and shift start from the CLIP token-embedding table's
std and mean. Batch statistics (training) wait for the training slice.

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

from typing import Sequence, Tuple, Union

import torch

from .basic import Params

EPS = 1e-5


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


def _bn_eval(x: torch.Tensor, params: Params, state: Params) -> torch.Tensor:
    """(N, C) or (K, N, C) -> same shape: f32 ``(x - mean) / sqrt(var +
    eps) * scale + bias``, returned in ``x.dtype``."""
    y = (x.float() - state["mean"].float()) / torch.sqrt(state["var"].float() + EPS)
    return (y * params["scale"].float() + params["bias"].float()).to(x.dtype)


def kw_bn_apply(
    params: Params,
    state: Params,
    keywords: torch.Tensor,  # (B, K, D)
    *,
    batchnorm_type: str,
    parallel: bool = False,
) -> torch.Tensor:
    """Eval-mode kw-BN -> (B, K, D) in ``keywords.dtype``."""
    b, k, d = keywords.shape
    if batchnorm_type == "eachKw" and parallel:
        flat = keywords.transpose(1, 2).reshape(b, d * k)
        return _bn_eval(flat, params, state).reshape(b, d, k).transpose(1, 2)
    if batchnorm_type == "eachKw":
        st = {n: t[:, None, :] for n, t in state.items()}
        pr = {n: t[:, None, :] for n, t in params.items()}
        return _bn_eval(keywords.transpose(0, 1), pr, st).transpose(0, 1)
    if batchnorm_type == "same":
        return _bn_eval(keywords.reshape(b * k, d), params, state).reshape(b, k, d)
    raise NotImplementedError(batchnorm_type)
