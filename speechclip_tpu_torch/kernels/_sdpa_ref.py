"""The plain masked scaled-dot-product attention (port of
speechclip_tpu/kernels/_sdpa_ref.py).

Written with explicit matmuls and softmax, not
``F.scaled_dot_product_attention``, so the rounding points are the
reference's:
- logits accumulate in f32 and are scaled by 1/sqrt(Dh);
- key positions ``col >= lens[b]`` are set to f32 ``finfo.min``, not -inf, so a fully masked row stays finite (it
  becomes a uniform average over all keys);
- softmax in f32; weights cast to the value dtype; the PV product
  accumulates in f32 and returns the value dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..ops.basic import matmul_f32

NEG_INF = float(torch.finfo(torch.float32).min)


def masked_sdpa(
    q: torch.Tensor,  # (B, H, L, Dh)
    k: torch.Tensor,  # (B, H, S, Dh)
    v: torch.Tensor,  # (B, H, S, Dh)
    lens: Optional[torch.Tensor],  # (B,) valid key lengths, or None
) -> torch.Tensor:
    """-> (B, H, L, Dh) in ``v.dtype``."""
    logits = matmul_f32(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if lens is not None:
        col = torch.arange(k.shape[2], device=q.device)
        ok = col[None, None, None, :] < lens.long()[:, None, None, None]
        logits = logits.masked_fill(~ok, NEG_INF)
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return matmul_f32(weights, v).to(v.dtype)
