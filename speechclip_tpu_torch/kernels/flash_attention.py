"""Streaming attention with an online softmax (port of
speechclip_tpu/kernels/flash_attention.py ``flash_attention``), the kernel
of the "pallas" attention backend.

What it computes, on (B, H, L, Dh) q/k/v with per-batch key lengths and an
optional causal flag, in f32 throughout: q, k and v upcast to f32, the
scale applied in f32, keys at ``col >= lens[b]`` (and ``col > row`` when
causal) set to f32 ``finfo.min``, the unrounded softmax weights summed in
f32, ``out = (p @ v) / max(sum p, 1e-30)`` rounded once to q's dtype.

A row with no valid key (``lens = 0``) is the mean of v over its S keys
here, as in ``masked_sdpa``; the TPU kernel divides that sum by S rounded up
to its 128-key block instead, the only place its padding shows.

The call is the custom op ``speechclip::flash_attention`` (``_ops``). On
CUDA bf16 or f32 tensors it launches ``csrc/flash_attention.cu``; on a CPU
tensor, or with ``plain=True``, it runs ``flash_attention_plain``. In
bf16, like the TPU kernel, it has no head-dim limit: Dh % 8 == 0 is all it
asks. Heads up
to 128 wide run ``flash_kernel<Dh>`` (a block of 4 warps per 64-row query
tile; rows up to 128 take one block per (batch, head), a warp per 16-row
slab); wider ones (the cascaded branch's single 768-wide head) run two
kernels: ``wide_scores_kernel`` computes the scaled, masked f32 scores once
per (query tile, key block) into a scratch buffer this wrapper allocates,
and ``wide_pv_kernel`` runs the online softmax and P V for one 128-wide
chunk of output columns per block. f32 operands (the CLIP text tower,
which runs in its f32 token table's dtype) take ``flash_f32_kernel``: f32
loads and CUDA-core f32 arithmetic throughout, the TPU kernel's own f32
form; a block stages its Q rows and 32-key blocks of K and V in shared
memory, a lane scores one key against its warp's rows, Dh up to
F32_MAX_HEAD_DIM (the large cascaded branch's 1024-wide head; past 768 the
K and V blocks take turns in one shared buffer).

Where q, k or v requires grad, the call goes through ``FlashAttentionFn``:
the forward as above, the gradient from a recompute through
``flash_attention_plain`` (``_plain_grad``; JAX's ``_bwd`` recomputes
through ``masked_sdpa``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build, _ops
from ._plain_grad import needs_grad, plain_grad_function
from ._sdpa_ref import NEG_INF
from ._attention_common import check_attention_operands, empty_heads_out, key_mask, launch_args

# Tile constants of csrc/flash_attention.cu: query rows per block (16 per
# warp), keys per streamed K/V block, and for Dh > 128 the head-dim chunk of
# the score pass and the output-column chunk of the P V pass.
FLASH_BQ, FLASH_BK, SCORE_CHUNK, WIDE_CHUNK = 64, 64, 64, 128
SHORT_ROWS = 128  # rows up to this run one block per (batch, head)
F32_MAX_HEAD_DIM = 1024  # the f32 form: its K (then V) and Q tiles fit shared memory up to here


def flash_attention_plain(q, k, v, lens: Optional[torch.Tensor], causal: bool = False):
    """The plain PyTorch version: (B, H, L, Dh) x3 -> (B, H, L, Dh) in q's
    dtype, f32 throughout."""
    q32 = q.float() * (1.0 / math.sqrt(q.shape[-1]))
    s = q32 @ k.float().transpose(-1, -2)
    ok = key_mask(lens, causal, q.shape[2], k.shape[2], q.device)
    if ok is not None:
        s = s.masked_fill(~ok, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True).detach())
    out = (p @ v.float()) / p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    return out.to(q.dtype)


def smem_bytes(dh: int) -> int:
    """Shared memory of one block of ``csrc/flash_attention.cu`` at its
    largest: up to Dh = 128, the Q tile (128 rows where L <= 128 takes one
    block) and two stages of K and V blocks, rows padded to 16 + 8
    elements; past it, the larger of the score pass (two stages of a Q and a
    K chunk, 64 + 8 elements a row) and the P V pass (two stages of an f32
    score tile, 64 + 8 a row, and of a V chunk, 128 + 8 a row)."""
    if dh > WIDE_CHUNK:
        scores = 4 * FLASH_BK * (SCORE_CHUNK + 8) * 2
        pv = 2 * FLASH_BQ * (FLASH_BK + 8) * 4 + 2 * FLASH_BK * (WIDE_CHUNK + 8) * 2
        return max(scores, pv)
    ld = (dh + 15) // 16 * 16 + 8
    return (SHORT_ROWS + 4 * FLASH_BK) * ld * 2


def wide_scores_shape(b: int, h: int, l: int, s: int):
    """The f32 scratch of the wide kernels: (B, H, L, S) scores with L and S
    rounded up to whole 64-row tiles."""
    up = lambda x: -(-x // FLASH_BK) * FLASH_BK
    return (b, h, up(l), up(s))


def flash_attention(q, k, v, lens: Optional[torch.Tensor] = None,
                    causal: bool = False, plain: bool = False) -> torch.Tensor:
    """(B, H, L, Dh) x3 [+ lens (B,)] -> (B, H, L, Dh) through the op
    ``speechclip::flash_attention``. CPU tensor or ``plain``: the plain
    version. CUDA tensor: the kernel, or an exception. Differentiable: where
    an input requires grad, through ``FlashAttentionFn`` (``plain``: the
    plain version's own autograd)."""
    if plain:
        return flash_attention_plain(q, k, v, lens, causal)
    _ops.check_device(q, "flash_attention")
    if needs_grad(q, k, v):
        return FlashAttentionFn.apply(q, k, v, lens, bool(causal))
    return _ops.flash_attention(q, k, v, lens, bool(causal))


def check_flash_operands(q, k, v, lens) -> None:
    """What the bf16 form (Dh % 8 == 0, any width) and the f32 form (Dh up
    to F32_MAX_HEAD_DIM) take; anything else raises."""
    check_attention_operands(
        q, k, v, lens, "flash_attention",
        max_head_dim=F32_MAX_HEAD_DIM if q.dtype == torch.float32 else None,
        dtypes=(torch.bfloat16, torch.float32))


def flash_attention_cuda(q, k, v, lens: Optional[torch.Tensor], causal: bool) -> torch.Tensor:
    """The op's CUDA implementation: the bf16 or the f32 form by the
    operands' dtype, counted in ``flash_attention.launches``; zero rows
    return the empty output without a launch."""
    check_flash_operands(q, k, v, lens)
    f32 = q.dtype == torch.float32
    b, h, l, dh = q.shape
    s = k.shape[2]
    out = empty_heads_out(b, h, l, dh, q.device, q.dtype)
    if out.numel() == 0:
        return out
    scores = None
    if dh > WIDE_CHUNK and not f32:
        scores = torch.empty(wide_scores_shape(b, h, l, s), dtype=torch.float32, device=q.device)
    q, k, v, lens_dev, strides = launch_args(q, k, v, lens, out)
    lib = _build.load()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if lens_dev is None else lens_dev.data_ptr(), out.data_ptr(),
            b, h, l, s, dh, strides, int(causal), 1.0 / math.sqrt(dh))
    if f32:
        status = lib.scl_flash_attention_f32(*args, _build.stream(q.device))
    else:
        status = lib.scl_flash_attention(
            *args, None if scores is None else scores.data_ptr(), _build.stream(q.device))
    _build.check(status, "scl_flash_attention_f32" if f32 else "scl_flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
flash_attention.recomputes = 0
FlashAttentionFn = plain_grad_function("FlashAttentionFn", _ops.flash_attention,
                                       flash_attention_plain, flash_attention)
