"""What the attention kernels share: the operands they accept, how their
launch arguments are laid out, the key mask of their plain versions, and
the test by which a kernel's output is held to its plain version's.

``attention_vmem``, ``flash_attention`` and the long-row core of
``mha_layer_block`` read (B, H, rows, Dh) q/k/v through strides and write a
(B, H, L, Dh) output laid out as (B, L, H, Dh).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
MAX_HEAD_DIM = 128
MAX_ROWS = 2**31 - 1  # rows of one head (L or S): the launchers take C ints

# Agreement of a bf16 attention output with its plain version. The outputs
# are weighted means of v (|out| ~ 0.05-3 here), so a fixed absolute limit
# says nothing; each limit is tied to the output's own scale instead. One
# bf16 ulp of x is at most |x| * 2^-7, so a kernel whose only difference is
# the summation order (rounding flips of one ulp) stays within one unit of
# ROW_ULP * max|want| in each row, keeps its rows' cosines near 1 - 1e-5,
# and flips few elements. A wrong mask (one key too many or too few), a
# skipped block or half, or other rounding points move every element of a
# row by a fraction of an ulp or more: many elements flip, and the per-row
# error or the cosine leaves its band.
ROW_ULP = 2.0 ** -7
MAX_ROW_ULPS = 2.0  # max |got - want| in a row, in units of ROW_ULP * max|want| there
MIN_ATTN_COSINE = 0.99999  # per row
MAX_MISMATCH = 0.05  # share of elements whose bf16 values differ
# An f32 output (flash_attention's f32 form) differs from its plain version
# by the summation order alone, ~1e-6 at |out| ~ 3; a key masked wrongly
# moves a row by ~|v| / len, 1e-2 or more.
F32_MAX_ABS = 1e-4


def attention_agreement(got: torch.Tensor, want: torch.Tensor) -> dict:
    """How far ``got`` is from ``want`` (same shape, rows along the last
    dim): max abs error, the worst row's error in units of ROW_ULP times
    that row's largest |want|, the smallest row cosine, the share of
    elements that differ, and whether the output is f32."""
    g = got.float().reshape(-1, got.shape[-1])
    w = want.float().reshape(-1, want.shape[-1])
    diff = (g - w).abs()
    scale = ROW_ULP * w.abs().amax(dim=-1)
    row_err = diff.amax(dim=-1)
    ulps = torch.where(row_err == 0, torch.zeros_like(row_err), row_err / scale)
    cos = torch.nn.functional.cosine_similarity(g, w, dim=-1, eps=1e-30)
    cos = torch.where((g == w).all(dim=-1), torch.ones_like(cos), cos)
    return dict(
        max_abs_err=float(diff.max()),
        row_ulps=float(ulps.max()),
        min_cosine=float(cos.min()),
        mismatch=float((diff > 0).float().mean()),
        finite=bool(torch.isfinite(g).all()),
        f32=got.dtype == torch.float32,
    )


def attention_agrees(stats: dict) -> bool:
    """Whether ``attention_agreement``'s numbers are within the limits (an
    f32 output: F32_MAX_ABS and the cosine; every f32 bit may differ)."""
    if stats.get("f32"):
        return (stats["finite"] and stats["max_abs_err"] <= F32_MAX_ABS
                and stats["min_cosine"] >= MIN_ATTN_COSINE)
    return (stats["finite"] and stats["row_ulps"] <= MAX_ROW_ULPS
            and stats["min_cosine"] >= MIN_ATTN_COSINE
            and stats["mismatch"] <= MAX_MISMATCH)


def key_mask(lens: Optional[torch.Tensor], causal: bool, l: int, s: int, device):
    """(B or 1, 1, L or 1, S) bool, True where a key is VALID; None if none."""
    ok = None
    col = torch.arange(s, device=device)
    if lens is not None:
        ok = col[None, None, None, :] < lens.to(device).long()[:, None, None, None]
    if causal:
        row = torch.arange(l, device=device)
        c = (col[None, :] <= row[:, None])[None, None]
        ok = c if ok is None else ok & c
    return ok


def check_head_dim(dh: int, what: str, max_head_dim: Optional[int] = MAX_HEAD_DIM):
    """Head dims a multiple of 8, up to ``max_head_dim`` when one is given."""
    if dh % 8 or (max_head_dim is not None and dh > max_head_dim):
        limit = "" if max_head_dim is None else f" up to {max_head_dim}"
        raise ValueError(f"{what}: head dim {dh} must be a multiple of 8{limit}")


def check_attention_operands(q, k, v, lens, what: str, max_head_dim: Optional[int] = MAX_HEAD_DIM,
                             dtypes=(torch.bfloat16,)):
    """What the attention kernels accept (q, k, v of one dtype among
    ``dtypes``, head dims a multiple of 8, up to ``max_head_dim`` when one
    is given); anything else raises."""
    names = " or ".join({torch.bfloat16: "bf16", torch.float32: "f32"}[d] for d in dtypes)
    for t in (q, k, v):
        if t.device.type != "cuda":
            raise ValueError(f"{what}: kernel path needs CUDA tensors, got {t.device}")
        if t.dtype not in dtypes or t.dtype != q.dtype:
            raise TypeError(f"{what}: kernel path runs {names} (q, k, v alike), got {t.dtype}")
    b, h, l, dh = q.shape
    s = k.shape[2]
    if k.shape != (b, h, s, dh) or v.shape != (b, h, s, dh):
        raise ValueError(
            f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
            "must be (B, H, L, Dh), (B, H, S, Dh), (B, H, S, Dh)"
        )
    check_head_dim(dh, what, max_head_dim)
    if lens is not None and lens.shape != (b,):
        raise ValueError(f"{what}: lens must be ({b},), got {tuple(lens.shape)}")


def _strided(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernels can read it through its strides (unit
    last stride, the others multiples of 8 elements, 16-byte aligned base),
    else a contiguous copy."""
    if t.stride(-1) == 1 and all(st % 8 == 0 for st in t.stride()[:-1]) and t.data_ptr() % 16 == 0:
        return t
    return t.contiguous()


def launch_args(q, k, v, lens, out):
    """Pointers, the (batch, head, row) element strides of q, k, v, out as a
    host int64 array, and lens as device int32 (or a null pointer)."""
    q, k, v = _strided(q), _strided(k), _strided(v)
    strides = [st for t in (q, k, v, out) for st in t.stride()[:3]]
    lens_dev = None if lens is None else lens.to(device=q.device, dtype=torch.int32).contiguous()
    return (
        q, k, v, lens_dev,
        (ctypes.c_longlong * 12)(*strides),
    )


def empty_heads_out(b: int, h: int, l: int, dh: int, device,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """A (B, H, L, Dh) output laid out as (B, L, H, Dh), so merging the heads
    afterwards is a free view."""
    return torch.empty((b, l, h, dh), dtype=dtype, device=device).permute(0, 2, 1, 3)


def heads_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` (B, H, L, Dh) in ``empty_heads_out``'s layout: the attention
    ops return it on every device, so a graph traced on one runs on the
    other."""
    return t.transpose(1, 2).contiguous().transpose(1, 2)
