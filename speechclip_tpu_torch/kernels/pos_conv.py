"""HuBERT's grouped positional convolution with its residual:
``x + GELU(trim(conv1d_grouped(x) + b))`` over (B, T, D) channels-last hidden
states (``models/hubert.py`` ``pos_conv_apply`` and the add after it).

No TPU kernel corresponds: the JAX package leaves this conv to XLA. The
port's own op ``speechclip::pos_conv`` (``_ops``) takes the place of cuDNN's
grouped conv, whose generic ``implicit_convolve_sgemm`` ran this k = 128,
16-group conv at ~1 % of its bound. On a CUDA bf16 tensor it launches
``csrc/pos_conv.cu`` once: a shifted-tap implicit GEMM (per group M = B T,
N = C = D / 16, K = 128 taps x C) whose epilogue adds the bias, applies
GELU and adds the residual, each step rounded to bf16 where the model
rounds. On a CPU tensor it runs ``pos_conv_plain``, which is the model's
own code. Where an input requires grad, the call goes through
``PosConvFn``: the kernel forward, the gradient from a recompute through
the plain version (``_plain_grad``).

``kernel_takes`` is the route: ``models/hubert.py`` calls the op only where
it holds, and keeps its own code for every other case (f32, another width,
another kernel size or group count).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build, _ops
from ._plain_grad import needs_grad, plain_grad_function
from ..ops.basic import conv_f32, gelu

KERNEL_SIZE = 128
GROUPS = 16
# Channels a group the kernel is compiled for: HuBERT-base (768 / 16) and
# HuBERT-large (1024 / 16).
WIDTHS = (48, 64)
# The kernel's plan (csrc/pos_conv.cu): a warp's 64-row subtile, up to 5 a
# block; a ring stage of 8 taps x 16 input channels, rows padded to 24
# bf16, 3 stages at C = 48 and 2 at C = 64; window rows padded by 8.
WARP_ROWS = 64
MAX_WARPS = 5
STAGE_TAPS = 8
STAGE_ROW = 24
STAGES = {48: 3, 64: 2}

# The kernel against its plain version: the products are exact and the sums
# f32 on both sides, in another order, so the conv's bf16 rounding flips at
# near-ties (~1e-6 relative against bf16's 2^-8 step: a few in 10^4
# elements). One flip moves v = bf16(bf16(conv) + b) by at most two bf16
# steps of |v|; GELU (slope <= 1.13) and its rounding carry that into the
# term g, whose binade may lie one below v's (gelu(2) = 1.95), so by at most
# 2 x 1.13 x 2 + 1 = 5.5 steps of |g|; the residual add's rounding adds one:
# at most 6 steps (2^-7 of the power of two) of max(|x|, |g|, |out|, 1), g
# read as plain - x, in few elements. Another rounding point, GELU or a
# wrong tap differs in far more elements than MAX_MISMATCH.
MAX_STEPS = 6
MAX_MISMATCH = 0.005


def kernel_takes(x: torch.Tensor, kernel_size: int, groups: int) -> bool:
    """Whether ``speechclip::pos_conv`` computes this conv on its kernel:
    bf16 on the card, k = 128, 16 groups, a compiled width."""
    d = x.shape[-1]
    return (x.device.type == "cuda" and x.dtype == torch.bfloat16
            and kernel_size == KERNEL_SIZE and groups == GROUPS
            and d % groups == 0 and d // groups in WIDTHS)


def pos_conv_term(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  groups: int) -> torch.Tensor:
    """The GELU term of (B, T, D) ``x``: the grouped conv padded k/2 both
    sides, f32 sums rounded to ``x.dtype``, ``+ b`` in ``x.dtype``, the
    trailing step dropped for even k (SamePad), then GELU. ``w`` (D, D /
    groups, k) in torch's layout."""
    k = w.shape[-1]
    y = conv_f32(F.conv1d, x.transpose(1, 2), w, "kernels/pos_conv.py pos_conv_term",
                 padding=k // 2, groups=groups)
    y = y + b.to(x.dtype)[None, :, None]
    if k % 2 == 0:
        y = y[:, :, :-1]
    return gelu(y.transpose(1, 2))


def pos_conv_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``x + pos_conv_term(x, ...)``, groups
    D / w.shape[1]."""
    return x + pos_conv_term(x, w, b, x.shape[-1] // w.shape[1])


def tile_plan(t: int) -> Tuple[int, int]:
    """(blocks an utterance, warps a block): ceil(T / 64) subtiles of 64
    rows, split into as few blocks of at most MAX_WARPS as hold them, and
    as even as may be (T = 319: one block of 5; T = 849: three of 5)."""
    subtiles = -(-t // WARP_ROWS)
    tiles = -(-subtiles // MAX_WARPS)
    return tiles, -(-subtiles // tiles)


def smem_bytes(c: int, warps: int) -> int:
    """One block's dynamic shared memory: the weight ring and the window of
    (64 warps + 127) rows of C + 8."""
    return 2 * (STAGES[c] * STAGE_TAPS * c * STAGE_ROW + (WARP_ROWS * warps + 127) * (c + 8))


def pack_weight(w: torch.Tensor, c: int) -> torch.Tensor:
    """(D, C, 128) -> (16, 8, C / 16, 16, C, 16) bf16: element [g, j0, kk,
    s, n, ci] is w[g C + n, 16 kk + ci, j0 + 8 s], so each ring stage (g,
    j0, kk, 8 taps s) is one contiguous block."""
    g = w.shape[0] // c
    return (w.to(torch.bfloat16).reshape(g, c, c // 16, 16, 16, 8)
            .permute(0, 5, 2, 4, 1, 3).contiguous())


def check_operands(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    """What the kernel takes (bf16 x on the card, (D, D / 16, 128) w, (D,)
    b, D / 16 in WIDTHS); anything else raises."""
    if x.device.type != "cuda":
        raise ValueError(f"pos_conv: kernel path needs CUDA tensors, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"pos_conv: kernel path runs bf16, got {x.dtype}")
    d = x.shape[-1]
    if x.dim() != 3 or tuple(w.shape) != (d, d // GROUPS, KERNEL_SIZE) \
            or tuple(b.shape) != (d,) or d % GROUPS or d // GROUPS not in WIDTHS:
        raise ValueError(
            f"pos_conv: x {tuple(x.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)}: the kernel "
            f"takes (B, T, 16 C) with C in {WIDTHS}, w (16 C, C, {KERNEL_SIZE}), b (16 C,)")


def pos_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, T, D) -> (B, T, D) through the op ``speechclip::pos_conv``. CPU
    tensor: the plain version. CUDA tensor: the kernel, or an exception.
    Differentiable: where an input requires grad, through ``PosConvFn``."""
    _ops.check_device(x, "pos_conv")
    if needs_grad(x, w, b):
        return PosConvFn.apply(x, w, b)
    return _ops.pos_conv(x, w, b)


def pos_conv_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The op's CUDA implementation: one launch, counted in
    ``pos_conv.launches``; zero rows return the empty output without a
    launch."""
    check_operands(x, w, b)
    bsz, t, d = x.shape
    if x.numel() == 0:
        return x.new_empty(x.shape)
    c = d // GROUPS
    x = x.contiguous()
    wp = pack_weight(w.to(x.device), c)
    bias = b.to(device=x.device, dtype=torch.bfloat16).contiguous()
    out = torch.empty_like(x)
    tiles, warps = tile_plan(t)
    _build.check(
        _build.load().scl_pos_conv(x.data_ptr(), wp.data_ptr(), bias.data_ptr(), out.data_ptr(),
                                   bsz, t, c, tiles, warps, _build.stream(x.device)),
        "scl_pos_conv",
    )
    pos_conv.launches += 1
    return out


pos_conv.launches = 0
pos_conv.recomputes = 0
PosConvFn = plain_grad_function("PosConvFn", _ops.pos_conv, pos_conv_plain, pos_conv)


def pos_conv_agreement(got: torch.Tensor, want: torch.Tensor, x: torch.Tensor) -> dict:
    """The kernel's output against the plain version's on input ``x``: the
    largest difference in bf16 steps (2^-7 of the power of two) of
    max(|x|, |want - x|, |got|, |want|, 1), the largest absolute difference
    and the share of elements that differ."""
    g, w, x = got.float(), want.float(), x.float()
    if not g.numel():
        return dict(max_steps=0.0, max_abs_err=0.0, mismatch=0.0, finite=True)
    diff = (g - w).abs()
    scale = torch.stack([g.abs(), w.abs(), x.abs(), (w - x).abs()]).amax(0).clamp(min=1.0)
    step = torch.exp2(torch.floor(torch.log2(scale)) - 7)
    return dict(max_steps=float((diff / step).max()), max_abs_err=float(diff.max()),
                mismatch=float((diff > 0).float().mean()), finite=bool(torch.isfinite(g).all()))


def pos_conv_agrees(stats: dict) -> bool:
    return (stats["finite"] and stats["max_steps"] <= MAX_STEPS
            and stats["mismatch"] <= MAX_MISMATCH)
