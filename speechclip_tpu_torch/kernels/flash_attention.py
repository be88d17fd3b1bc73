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

On a CUDA bf16 tensor it launches ``csrc/flash_attention.cu``; on a CPU
tensor, or with ``plain=True``, it runs ``flash_attention_plain``. Like the
TPU kernel it has no head-dim limit: Dh % 8 == 0 is all it asks. Heads up
to 128 wide run ``flash_kernel<Dh>``; wider ones (the cascaded branch's
single 768-wide head) run ``flash_kernel_wide``, which cuts Dh into
128-wide chunks, one block per chunk of output columns.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build
from ._sdpa_ref import NEG_INF
from ._attention_common import check_attention_operands, empty_heads_out, key_mask, launch_args

# Tile constants of csrc/flash_attention.cu: query rows per block (16 per
# warp), keys per streamed K/V block, and the head-dim chunk of the wide
# kernel (Dh > 128).
FLASH_BQ, FLASH_BK, WIDE_CHUNK = 64, 64, 128


def flash_attention_plain(q, k, v, lens: Optional[torch.Tensor], causal: bool = False):
    """The plain PyTorch version: (B, H, L, Dh) x3 -> (B, H, L, Dh) in q's
    dtype, f32 throughout."""
    q32 = q.float() * (1.0 / math.sqrt(q.shape[-1]))
    s = q32 @ k.float().transpose(-1, -2)
    ok = key_mask(lens, causal, q.shape[2], k.shape[2], q.device)
    if ok is not None:
        s = s.masked_fill(~ok, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = (p @ v.float()) / p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    return out.to(q.dtype)


def smem_bytes(dh: int) -> int:
    """Shared memory of one block of ``csrc/flash_attention.cu``: up to Dh =
    128, the Q tile and two stages of K and V blocks, rows padded to 16 + 8
    elements; past it, two stages each of a Q chunk, a K chunk and a V
    chunk, 128 + 8 elements a row."""
    if dh > WIDE_CHUNK:
        return 6 * FLASH_BK * (WIDE_CHUNK + 8) * 2
    ld = (dh + 15) // 16 * 16 + 8
    return (FLASH_BQ + 4 * FLASH_BK) * ld * 2


def flash_attention(q, k, v, lens: Optional[torch.Tensor] = None,
                    causal: bool = False, plain: bool = False) -> torch.Tensor:
    """(B, H, L, Dh) x3 [+ lens (B,)] -> (B, H, L, Dh). CPU tensor or
    ``plain``: the plain version. CUDA tensor: the kernel, or an exception."""
    if plain or q.device.type == "cpu":
        return flash_attention_plain(q, k, v, lens, causal)
    check_attention_operands(q, k, v, lens, "flash_attention", max_head_dim=None)
    b, h, l, dh = q.shape
    s = k.shape[2]
    out = empty_heads_out(b, h, l, dh, q.device)
    q, k, v, lens_dev, strides = launch_args(q, k, v, lens, out)
    lib = _build.load()
    _build.check(
        lib.scl_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if lens_dev is None else lens_dev.data_ptr(), out.data_ptr(),
            b, h, l, s, dh, strides, int(causal), 1.0 / math.sqrt(dh),
            torch.cuda.current_stream(q.device).cuda_stream,
        ),
        "scl_flash_attention",
    )
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
