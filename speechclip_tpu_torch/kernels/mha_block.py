"""Fused self-attention half-layer (port of speechclip_tpu/kernels/mha_block.py
``mha_layer_block``).

``ln_mode`` picks the layer form:
- "post": LN(x + MHA(x))  (HuBERT-base, torch post-norm encoder layers)
- "pre":  x + MHA(LN(x))  (HuBERT-large)
- "none": MHA(x)

MHA is torch ``nn.MultiheadAttention`` self-attention: fused QKV projection,
per-head scaled dot product with a key-length mask, out-projection.

On a CUDA bf16 tensor it runs as three or four launches of the hand-written
kernels in ``csrc/``: [row LN for "pre"] -> QKV GEMM + f32 bias ->
attention core -> out-proj GEMM with bias + residual epilogue [-> row LN for
"post"]. On a CPU tensor it runs ``mha_layer_block_plain``, which keeps the
TPU kernel's rounding points: f32 accumulation, f32 bias added before
rounding qkv to the activation dtype, f32 masked softmax, f32 residual and
LayerNorm.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from ._sdpa_ref import masked_sdpa
from ..ops.basic import matmul_f32

# Epilogue ids of scl_gemm_bf16 (csrc/gemm_epilogue.cu).
EPI_BIAS, EPI_BIAS_GELU, EPI_BIAS_RESID_F32, EPI_BIAS_RESID = 0, 1, 2, 3
SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
LN_MODES = ("post", "pre", "none")


def ln_rows(y32: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float):
    """Row LayerNorm in f32 (the TPU kernels' ``_ln_rows``)."""
    mean = y32.mean(dim=-1, keepdim=True)
    var = (y32 - mean).square().mean(dim=-1, keepdim=True)
    return (y32 - mean) * torch.rsqrt(var + eps) * g.float() + b.float()


def mha_layer_block_plain(x, w_in, b_in, w_out, b_out, ln_g, ln_b, lens,
                          heads: int, ln_mode: str, eps: float) -> torch.Tensor:
    """The plain PyTorch version: (B, T, D) -> (B, T, D) in ``x.dtype``."""
    dt = x.dtype
    bsz, t, d = x.shape
    dh = d // heads
    h_in = ln_rows(x.float(), ln_g, ln_b, eps).to(dt) if ln_mode == "pre" else x
    qkv = (matmul_f32(h_in, w_in.to(dt)) + b_in.float()).to(dt)
    split = lambda z: z.reshape(bsz, t, heads, dh).transpose(1, 2)
    q, k, v = qkv.split(d, dim=-1)
    att = masked_sdpa(split(q), split(k), split(v), lens)
    att = att.transpose(1, 2).reshape(bsz, t, d)
    out32 = matmul_f32(att, w_out.to(dt)) + b_out.float()
    if ln_mode == "post":
        out32 = ln_rows(out32 + x.float(), ln_g, ln_b, eps)
    elif ln_mode == "pre":
        out32 = out32 + x.float()
    return out32.to(dt)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def check_cuda_operands(x: torch.Tensor, *params: Optional[torch.Tensor]):
    """What the CUDA kernels accept; anything else raises (never a silent
    detour to the plain version)."""
    if x.device.type != "cuda":
        raise ValueError(f"kernel path needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"kernel path runs bf16 activations, got {x.dtype}")
    if x.requires_grad or any(p is not None and p.requires_grad for p in params):
        raise RuntimeError(
            "kernel path is forward-only: an input requires grad (the "
            "backward kernels are not ported yet)"
        )
    for p in params:
        if p is not None and p.device != x.device:
            raise ValueError(f"operand on {p.device}, activations on {x.device}")


def gemm(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, epilogue: int,
         resid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(M, K) bf16 @ (K, N) bf16 + f32 bias, with the chosen epilogue."""
    m, k = a.shape
    n = w.shape[1]
    if k % 8 or n % 8 or w.shape[0] != k or bias.shape != (n,):
        raise ValueError(
            f"GEMM needs (M, K) @ (K, N) + (N,) with K % 8 == 0 and N % 8 == 0, "
            f"got {tuple(a.shape)} @ {tuple(w.shape)} + {tuple(bias.shape)}"
        )
    w = w.to(torch.bfloat16).contiguous()
    bias = bias.float().contiguous()
    operands = [a, w, bias] + ([] if resid is None else [resid])
    if resid is not None and (resid.shape != (m, n) or resid.dtype != torch.bfloat16):
        raise ValueError(f"residual must be ({m}, {n}) bf16, got {tuple(resid.shape)} {resid.dtype}")
    if a.dtype != torch.bfloat16 or any(
        not t.is_contiguous() or t.data_ptr() % 16 for t in operands
    ):
        raise ValueError("GEMM operands must be bf16 activations, contiguous and 16-byte aligned")
    out_dtype = torch.float32 if epilogue == EPI_BIAS_RESID_F32 else torch.bfloat16
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    lib = _build.load()
    _build.check(
        lib.scl_gemm_bf16(
            a.data_ptr(), w.data_ptr(), bias.data_ptr(), _ptr(resid),
            out.data_ptr(), m, n, k, epilogue,
            torch.cuda.current_stream(a.device).cuda_stream,
        ),
        "scl_gemm_bf16",
    )
    return out


def layer_norm_rows(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """Row LN of (M, D) f32 or bf16 -> bf16 (csrc/gemm_epilogue.cu)."""
    rows, d = x.shape
    g, b = g.float().contiguous(), b.float().contiguous()
    out = torch.empty((rows, d), dtype=torch.bfloat16, device=x.device)
    lib = _build.load()
    _build.check(
        lib.scl_layer_norm(
            x.data_ptr(), int(x.dtype == torch.float32), g.data_ptr(),
            b.data_ptr(), out.data_ptr(), rows, d, float(eps),
            torch.cuda.current_stream(x.device).cuda_stream,
        ),
        "scl_layer_norm",
    )
    return out


def attention_core(qkv: torch.Tensor, lens: Optional[torch.Tensor], bsz: int,
                   t: int, d: int, heads: int) -> torch.Tensor:
    """(B*T, 3D) bf16 qkv -> (B*T, D) bf16 head outputs (csrc/attention_core.cu)."""
    dh = d // heads
    lib = _build.load()
    smem = lib.scl_attention_smem_bytes(t, dh)
    if dh % 16 or d % 8 or (t + 15) // 16 * 16 > 512 or smem > SMEM_LIMIT:
        raise ValueError(
            f"attention core does not take T={t}, Dh={dh} (needs Dh % 16 == 0, "
            f"T <= 512 and {smem} <= {SMEM_LIMIT} bytes of shared memory)"
        )
    if lens is not None:
        lens = lens.to(device=qkv.device, dtype=torch.int32).contiguous()
    out = torch.empty((bsz * t, d), dtype=torch.bfloat16, device=qkv.device)
    _build.check(
        lib.scl_attention(
            qkv.data_ptr(), _ptr(lens), out.data_ptr(), bsz, t, d, heads,
            torch.cuda.current_stream(qkv.device).cuda_stream,
        ),
        "scl_attention",
    )
    return out


def mha_layer_block(x, w_in, b_in, w_out, b_out, ln_g, ln_b, lens,
                    heads: int, ln_mode: str, eps: float) -> torch.Tensor:
    """(B, T, D) -> (B, T, D). CPU tensor: the plain version. CUDA tensor:
    the hand-written kernels, or an exception."""
    if ln_mode not in LN_MODES:
        raise ValueError(f"ln_mode {ln_mode!r} not in {LN_MODES}")
    if x.device.type == "cpu":
        return mha_layer_block_plain(
            x, w_in, b_in, w_out, b_out, ln_g, ln_b, lens, heads, ln_mode, eps
        )
    check_cuda_operands(x, w_in, b_in, w_out, b_out, ln_g, ln_b)
    bsz, t, d = x.shape
    x2 = x.contiguous().view(bsz * t, d)
    h_in = layer_norm_rows(x2, ln_g, ln_b, eps) if ln_mode == "pre" else x2
    qkv = gemm(h_in, w_in, b_in, EPI_BIAS)
    att = attention_core(qkv, lens, bsz, t, d, heads)
    if ln_mode == "post":
        out = layer_norm_rows(
            gemm(att, w_out, b_out, EPI_BIAS_RESID_F32, resid=x2), ln_g, ln_b, eps
        )
    elif ln_mode == "pre":
        out = gemm(att, w_out, b_out, EPI_BIAS_RESID, resid=x2)
    else:
        out = gemm(att, w_out, b_out, EPI_BIAS)
    mha_layer_block.launches += 1
    return out.view(bsz, t, d)


mha_layer_block.launches = 0
