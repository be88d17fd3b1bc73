"""Elementwise / affine building blocks (port of speechclip_tpu/ops/basic.py).

Parameters are plain dicts of tensors in the JAX layout ``y = x @ w + b``
(``w: (in, out)``), so weights carried over from the JAX package need no
transpose.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

Params = dict


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU for bf16, exact erf otherwise — the JAX
    package's parity contract (speechclip_tpu/ops/basic.py:22-36)."""
    if x.dtype == torch.bfloat16:
        return F.gelu(x, approximate="tanh")
    return F.gelu(x)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """QuickGELU ``x * sigmoid(1.702 x)`` of the CLIP towers, in the
    activation dtype (speechclip_tpu/ops/basic.py:39-42)."""
    return x * torch.sigmoid(1.702 * x)


def linear(params: Params, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` in the activation dtype (the JAX package casts both
    the weight and the bias to ``x.dtype``)."""
    y = x @ params["w"].to(x.dtype)
    if params.get("b") is not None:
        y = y + params["b"].to(x.dtype)
    return y


class RowShardGenerator(torch.Generator):
    """A generator of one data rank of ``world`` equal batch shards: a
    batch-shaped draw (``rand_rows``) covers the global batch and keeps this
    rank's rows, so each rank's dropout masks and Gumbel noise are the
    single-device draw's rows, as JAX's sharded step draws its noise over
    the global shape. ``rank`` and ``world`` are the data axis's (the ranks
    of a model group hold the same rows and draw the same noise). Every
    rank holds the same seed, so the ranks stay in step; the cost is
    ``world`` times the draws."""

    def __new__(cls, device, rank: int, world: int):
        return super().__new__(cls, device)

    def __init__(self, device, rank: int, world: int):
        self.rank, self.world = rank, world


def seeded_generator(seed: Optional[int], device,
                     like: Optional[torch.Generator] = None) -> Optional[torch.Generator]:
    """A generator on ``device`` seeded with ``seed`` (None for None), of
    ``like``'s rank shard where ``like`` is a ``RowShardGenerator``."""
    if seed is None:
        return None
    if isinstance(like, RowShardGenerator):
        return RowShardGenerator(device, like.rank, like.world).manual_seed(seed)
    return torch.Generator(device=device).manual_seed(seed)


def rand_rows(shape, generator: torch.Generator, device,
              split: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """f32 U[0, 1) of ``shape`` (batch first) from ``generator``; from a
    ``RowShardGenerator``, this rank's rows of the global batch's draw.
    ``split`` = (axis, part, parts): ``shape[axis]`` is part ``part`` of
    ``parts`` equal parts of the drawn axis (a model-axis shard: a
    column-parallel layer's columns, the local heads), so the full axis is
    drawn and this part kept: the single-device draw's elements."""
    world = getattr(generator, "world", 1)
    full = list(shape)
    if world > 1:
        full[0] *= world
    if split is not None:
        axis, part, parts = split
        axis %= len(full)
        if axis == 0:
            raise ValueError("the batch axis is the data axis's to split")
        full[axis] *= parts
    u = torch.rand(full, generator=generator, device=device)
    if world > 1:
        n = shape[0]
        u = u[generator.rank * n:(generator.rank + 1) * n]
    if split is not None:
        u = u.narrow(axis, part * shape[axis], shape[axis])
    return u


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


_DEVICE_BRANCHES = threading.local()


@contextlib.contextmanager
def recording_device_branches():
    """Yield a set that collects, while the block runs on this thread, the
    ``where`` of every call that took a branch depending on its device
    (``conv_f32``'s upcast). A traced graph keeps the branch of the device
    it was traced on, so such a graph computes on another device what no
    direct call there computes."""
    prev = getattr(_DEVICE_BRANCHES, "log", None)
    _DEVICE_BRANCHES.log = log = set()
    try:
        yield log
    finally:
        _DEVICE_BRANCHES.log = prev


def conv_f32(conv, x: torch.Tensor, w: torch.Tensor, where: str, **kwargs) -> torch.Tensor:
    """``conv(x, w, **kwargs)`` with JAX's ``preferred_element_type=f32``:
    the operands in ``x.dtype``, the sums in f32, the output rounded to
    ``x.dtype``. cuDNN's bf16 convolution accumulates in f32 already;
    PyTorch's CPU bf16 convolution does not (its grouped form errs by more
    than the output's own magnitude), so on the CPU non-f32 operands are
    upcast first. That choice depends on the device: it is noted under
    ``where`` for ``recording_device_branches``."""
    w = w.to(x.dtype)
    if x.dtype == torch.float32:
        return conv(x, w, **kwargs)
    log = getattr(_DEVICE_BRANCHES, "log", None)
    if log is not None:
        log.add(where)
    if x.device.type == "cpu":
        return conv(x.float(), w.float(), **kwargs).to(x.dtype)
    return conv(x, w, **kwargs)


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


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator],
            split: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """Inverted dropout (speechclip_tpu/ops/basic.py ``dropout``): each
    element kept with probability ``1 - rate`` and scaled by ``1 / (1 -
    rate)`` in ``x.dtype``, the mask drawn from ``generator`` (``rand_rows``:
    under data parallelism the global batch's mask, under a ``split`` the
    full axis's). The identity when not training or at rate 0."""
    if not train or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs a generator when train=True and rate > 0")
    keep = 1.0 - rate
    mask = rand_rows(x.shape, generator, x.device, split) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """x / ||x|| over the trailing axis, computed in f32 and returned in
    ``x.dtype``."""
    x32 = x.float()
    return (x32 / torch.linalg.vector_norm(x32, dim=-1, keepdim=True)).to(x.dtype)
