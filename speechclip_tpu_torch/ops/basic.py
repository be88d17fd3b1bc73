"""Elementwise / affine building blocks (port of speechclip_tpu/ops/basic.py).

Parameters are plain dicts of tensors in the JAX layout ``y = x @ w + b``
(``w: (in, out)``), so weights carried over from the JAX package need no
transpose.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

Params = dict


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU for bf16, exact erf otherwise — the JAX
    package's parity contract (speechclip_tpu/ops/basic.py:22-36)."""
    if x.dtype == torch.bfloat16:
        return F.gelu(x, approximate="tanh")
    return F.gelu(x)


def linear(params: Params, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` in the activation dtype (the JAX package casts both
    the weight and the bias to ``x.dtype``)."""
    y = x @ params["w"].to(x.dtype)
    if params.get("b") is not None:
        y = y + params["b"].to(x.dtype)
    return y


def uniform(shape, bound: float, generator: torch.Generator) -> torch.Tensor:
    """U(-bound, bound) f32 on the generator's device."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u * (2.0 * bound) - bound


def normal(shape, std: float, generator: torch.Generator) -> torch.Tensor:
    """N(0, std^2) f32 on the generator's device."""
    return torch.randn(shape, generator=generator, device=generator.device) * std


def linear_init(generator: torch.Generator, in_dim: int, out_dim: int) -> Params:
    """torch.nn.Linear default init in the JAX layout: weight and bias
    U(-1/sqrt(in), 1/sqrt(in)), weight of shape (in, out)."""
    bound = 1.0 / math.sqrt(in_dim)
    w = uniform((in_dim, out_dim), bound, generator)
    return {"w": w, "b": uniform((out_dim,), bound, generator)}


def layer_norm_init(dim: int, device) -> Params:
    return {
        "scale": torch.ones(dim, dtype=torch.float32, device=device),
        "bias": torch.zeros(dim, dtype=torch.float32, device=device),
    }


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated and returned in f32 — JAX's
    ``preferred_element_type=f32``. Upcasting first keeps every product of
    bf16 inputs exact, so only the summation order can differ from an
    f32-accumulating bf16 GEMM."""
    return a.float() @ b.float()


def layer_norm(
    params: Optional[Params], x: torch.Tensor, eps: float = 1e-5
) -> torch.Tensor:
    """LayerNorm over the trailing axis, computed in f32, returned in
    ``x.dtype``."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    if params is not None:
        y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """x / ||x|| over the trailing axis, computed in f32 and returned in
    ``x.dtype``."""
    x32 = x.float()
    return (x32 / torch.linalg.vector_norm(x32, dim=-1, keepdim=True)).to(x.dtype)
