"""Fused FFN half-layer (port of speechclip_tpu/kernels/ffn_block.py
``ffn_block``): fc1 -> GELU -> fc2 with the residual and LayerNorm folded in.

``ln_mode`` "post": LN(x + ffn(x)); "pre": x + ffn(LN(x)); "none": ffn(x).

On a CUDA bf16 tensor: [row LN for "pre"] -> fc1 GEMM with a bias + GELU
epilogue writing the (B*T, F) activation in bf16 -> fc2 GEMM with a bias +
residual epilogue [-> row LN for "post"] (csrc/gemm_epilogue.cu). On a CPU
tensor: ``ffn_block_plain``, with the TPU kernel's rounding points — the
fc1 pre-activation is f32 accumulator + f32 bias rounded to the activation
dtype, then GELU (tanh for bf16, erf for f32), fc2 in f32 + f32 bias, f32
residual and LayerNorm.
"""

from __future__ import annotations

import torch

from .mha_block import (
    EPI_BIAS,
    EPI_BIAS_GELU,
    EPI_BIAS_RESID,
    EPI_BIAS_RESID_F32,
    LN_MODES,
    check_cuda_operands,
    gemm,
    layer_norm_rows,
    ln_rows,
)
from ..ops.basic import gelu, matmul_f32


def ffn_block_plain(x, w1, b1, w2, b2, ln_g, ln_b, ln_mode: str,
                    eps: float) -> torch.Tensor:
    """The plain PyTorch version: (B, T, D) -> (B, T, D) in ``x.dtype``."""
    dt = x.dtype
    h_in = ln_rows(x.float(), ln_g, ln_b, eps).to(dt) if ln_mode == "pre" else x
    mid = gelu((matmul_f32(h_in, w1.to(dt)) + b1.float()).to(dt))
    out32 = matmul_f32(mid, w2.to(dt)) + b2.float()
    if ln_mode == "post":
        out32 = ln_rows(out32 + x.float(), ln_g, ln_b, eps)
    elif ln_mode == "pre":
        out32 = out32 + x.float()
    return out32.to(dt)


def ffn_block(x, w1, b1, w2, b2, ln_g, ln_b, ln_mode: str,
              eps: float) -> torch.Tensor:
    """(B, T, D) -> (B, T, D). CPU tensor: the plain version. CUDA tensor:
    the hand-written kernels, or an exception."""
    if ln_mode not in LN_MODES:
        raise ValueError(f"ln_mode {ln_mode!r} not in {LN_MODES}")
    if x.device.type == "cpu":
        return ffn_block_plain(x, w1, b1, w2, b2, ln_g, ln_b, ln_mode, eps)
    check_cuda_operands(x, w1, b1, w2, b2, ln_g, ln_b)
    bsz, t, d = x.shape
    x2 = x.contiguous().view(bsz * t, d)
    h_in = layer_norm_rows(x2, ln_g, ln_b, eps) if ln_mode == "pre" else x2
    mid = gemm(h_in, w1, b1, EPI_BIAS_GELU)
    if ln_mode == "post":
        out = layer_norm_rows(
            gemm(mid, w2, b2, EPI_BIAS_RESID_F32, resid=x2), ln_g, ln_b, eps
        )
    elif ln_mode == "pre":
        out = gemm(mid, w2, b2, EPI_BIAS_RESID, resid=x2)
    else:
        out = gemm(mid, w2, b2, EPI_BIAS)
    ffn_block.launches += 1
    return out.view(bsz, t, d)


ffn_block.launches = 0
