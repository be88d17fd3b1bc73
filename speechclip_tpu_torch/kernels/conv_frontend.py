"""HuBERT's stride-2 conv chain with an exact-erf GELU after each layer (port
of speechclip_tpu/kernels/conv_frontend.py ``fused_conv_chain``).

What it computes, on x (B, T, C) in the JAX NWC layout (the output of
conv0 + GroupNorm + GELU) and per-layer weights (k, C_in, C_out) in the
JAX WIO layout, every layer stride 2 and VALID: the sums in f32, GELU with
the exact erf on the f32 sum, one rounding to x's dtype per layer. It is
not HuBERT's own bf16 chain, which rounds each conv before a tanh GELU
(``models/hubert.py``); like the JAX kernel, it lies on no model path.

On a CUDA bf16 tensor it launches ``csrc/conv_chain.cu`` once per layer
(one GEMM over a strided view of the input, no im2col); on a CPU tensor,
or with ``plain=True``, it runs ``fused_conv_chain_plain``. Anything else
raises.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from . import _build

# Agreement of the kernel with its plain version. The products are exact
# and the sums f32 on both sides, so one layer's outputs differ only where
# another summation order flips a bf16 rounding: about 0.02 % of elements
# (CPU, f32 against a float64 re-summation at C = 512). GELU computed
# another way (tanh instead of erf, ~3e-4 apart) flips about 3 %. So each
# layer, fed the same input on both sides, may differ in at most
# MAX_LAYER_MISMATCH of its elements; the whole chain, where flips
# propagate, is held to the layer-output limits of the other kernels.
MAX_LAYER_MISMATCH = 0.005


def layer_out_len(t_in: int, k: int) -> int:
    return (t_in - k) // 2 + 1


def chain_out_len(t: int, kernels: Sequence[int]) -> int:
    for k in kernels:
        t = layer_out_len(t, k)
    return t


def window_for(out_block: int, kernels: Sequence[int]) -> int:
    """Input rows needed to produce ``out_block`` output rows through the
    chain (stride 2 each layer), rounded up to even: the TPU kernel's
    per-block VMEM window (4112 rows for 64 frames of HuBERT's chain)."""
    need = out_block
    for k in reversed(kernels):
        need = (need - 1) * 2 + k
    return need + (need % 2)


def fused_conv_chain_plain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                           kernels: Sequence[int]) -> torch.Tensor:
    """The plain PyTorch version: each layer an f32 ``conv1d`` of the
    upcast operands (exact products, f32 sums; TF32 off), erf GELU in f32,
    one rounding to x's dtype."""
    dtype = x.dtype
    cudnn = torch.backends.cudnn
    for w, k in zip(weights, kernels):
        if w.shape[0] != k:
            raise ValueError(f"weight of shape {tuple(w.shape)} for kernel size {k}")
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            y = F.conv1d(x.float().transpose(1, 2), w.float().permute(2, 1, 0), stride=2)
        x = F.gelu(y).transpose(1, 2).to(dtype)
    return x


def fused_conv_chain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                     kernels: Sequence[int], plain: bool = False) -> torch.Tensor:
    """x (B, T, C) -> (B, T_out, C_out), T_out by VALID conv arithmetic.
    CPU tensor or ``plain``: the plain version. CUDA tensor: the kernel, or
    an exception."""
    kernels = tuple(kernels)
    if len(weights) != len(kernels):
        raise ValueError(f"{len(weights)} weights for {len(kernels)} kernel sizes")
    if plain or x.device.type == "cpu":
        return fused_conv_chain_plain(x, weights, kernels)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_chain: kernel path needs CUDA tensors, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"fused_conv_chain: kernel path runs bf16, got {x.dtype}")
    if x.requires_grad:
        raise RuntimeError("fused_conv_chain: kernel path is forward-only: x requires grad")
    b, t, c = x.shape
    if chain_out_len(t, kernels) < 1:
        raise ValueError(f"fused_conv_chain: T = {t} is shorter than the chain's window")
    lib = _build.load()
    stream = _build.stream(x.device)
    h = x.contiguous()
    for w, k in zip(weights, kernels):
        if w.shape[:2] != (k, h.shape[2]) or w.shape[2] % 8 or h.shape[2] % 8:
            raise ValueError(
                f"fused_conv_chain: weight {tuple(w.shape)} for a (k={k}, C_in={h.shape[2]}) "
                "layer; channels must be multiples of 8"
            )
        w2 = w.to(device=x.device, dtype=torch.bfloat16).reshape(k * h.shape[2], -1).contiguous()
        out = torch.empty((b, layer_out_len(h.shape[1], k), w.shape[2]),
                          dtype=torch.bfloat16, device=x.device)
        _build.check(
            lib.scl_conv_chain_layer(h.data_ptr(), w2.data_ptr(), out.data_ptr(), b,
                                     h.shape[1], h.shape[2], w.shape[2], k, stream),
            "scl_conv_chain_layer",
        )
        h = out
    fused_conv_chain.launches += 1
    return h


fused_conv_chain.launches = 0


def conv_chain_agreement(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Max abs error, smallest row cosine, share of elements that differ."""
    g = got.float().reshape(-1, got.shape[-1])
    w = want.float().reshape(-1, want.shape[-1])
    diff = (g - w).abs()
    cos = F.cosine_similarity(g, w, dim=-1, eps=1e-30)
    cos = torch.where((g == w).all(dim=-1), torch.ones_like(cos), cos)
    return dict(max_abs_err=float(diff.max()), min_cosine=float(cos.min()),
                mismatch=float((diff > 0).float().mean()),
                finite=bool(torch.isfinite(g).all()))
