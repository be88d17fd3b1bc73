"""Whole-row attention over head-split q/k/v (port of
speechclip_tpu/kernels/attention_vmem.py ``attention_vmem`` and its gate
``vmem_eligible``).

What it computes, on (B, H, L, Dh) q/k/v with per-batch key lengths and an
optional causal flag, with the TPU kernel's rounding points:
- q is scaled by ``1/sqrt(Dh)`` rounded to q's dtype, and the product is
  rounded to q's dtype, before Q K^T;
- the scores are f32; masked keys (``col >= lens[b]``, and ``col > row``
  when causal) get f32 ``finfo.min``;
- ``p = exp(s - rowmax)`` is rounded to q's dtype;
- ``p @ v`` and the denominator (the sum of the ROUNDED p) accumulate in
  f32; ``out = acc / max(denom, 1e-30)``, rounded once.
That is not ``masked_sdpa``'s rounding, which normalizes in f32 first.

The call is the custom op ``speechclip::attention_vmem`` (``_ops``). On a
CUDA bf16 tensor it launches ``csrc/attention_vmem.cu``; on a CPU tensor,
or with ``plain=True``, it runs ``attention_vmem_plain``. Where q,
k or v requires grad, the call goes through ``AttentionVmemFn``: the
forward as above, the gradient from a recompute through
``attention_vmem_plain`` (``_plain_grad``; JAX's ``_bwd`` recomputes
through ``masked_sdpa``). The
kernel sweeps K twice (the row max, then the rounded p and P V) with its
scores in registers, so its shared memory depends on Dh alone and it takes
rows of any length.

The gate keeps the TPU package's VMEM numbers on purpose: the gates decide
which computation, with which rounding points, produces a layer's output,
and the port is held to the reference. Retuning them for the H100 is later
work that needs measurements of its own.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build, _ops
from ._plain_grad import needs_grad, plain_grad_function
from ._attention_common import (
    check_attention_operands,
    empty_heads_out,
    key_mask,
    launch_args,
)
from ._sdpa_ref import NEG_INF
from ..ops.basic import matmul_f32

VMEM_BUDGET = 10 * 1024 * 1024  # the TPU kernel's per-cell VMEM cap (bytes)
# Tile constants of csrc/attention_vmem.cu: query rows per block (16 per
# warp) and keys per streamed K/V block.
ROW_BQ, ROW_BK = 64, 64


GROUPS = (16, 12, 8, 6, 4, 3, 2)  # the TPU kernel's (batch*head) groups, largest first


def _group_fits(g: int, l: int, s: int, d: int, itemsize: int) -> bool:
    per_pair = (2 * l * d + s * d + s * (d + 1)) * itemsize * 2
    score = l * s * (4 + 2)
    return g * per_pair + score <= VMEM_BUDGET


def _group_size(bh: int, l: int, s: int, d: int, itemsize: int) -> int:
    """The TPU kernel's (batch*head) group per grid cell (attention_vmem.py
    ``_group_size``); the port uses it only inside ``vmem_eligible``."""
    for g in GROUPS:
        if bh % g == 0 and _group_fits(g, l, s, d, itemsize):
            return g
    return 1


def _symbolic_batch_eligible(h: int, l: int, s: int, d: int, itemsize: int) -> bool:
    """The gate's group test for a batch that is a symbol (``torch.export``
    with a polymorphic batch), decided without the batch: a group of 2 or
    more that fits and divides the heads divides every B * H, so the route
    holds at every batch; with no group that fits, at none. Otherwise the
    route would depend on the batch, and that raises. (JAX's symbolic gate
    answers False there and its artifact takes the XLA attention at every
    batch, which its fixed-batch artifacts do not.)"""
    fits = [g for g in GROUPS if _group_fits(g, l, s, d, itemsize)]
    if any(h % g == 0 for g in fits):
        return True
    if not fits:
        return False
    raise ValueError(
        f"attention_vmem's gate depends on the batch at H = {h} heads, L = {l}, S = {s}, "
        f"Dh = {d}: no group of {fits} divides H, so B * H decides; export a fixed batch")


def vmem_eligible(b: int, h: int, l: int, s: int, d: int, itemsize: int = 2) -> bool:
    """The JAX gate, number for number: head dim a multiple of 8 up to 128,
    ``L*S >= 128^2``, ``6*L*S <= VMEM_BUDGET / 2`` (L = S <= 934) and a
    group of at least 2 (batch*head) pairs. A symbolic ``b`` (a traced
    polymorphic batch): ``_symbolic_batch_eligible``."""
    if d % 8 != 0 or d > 128:
        return False
    if l * s < 128 * 128:
        return False
    if l * s * 6 > VMEM_BUDGET // 2:
        return False
    if isinstance(b, torch.SymInt):
        return _symbolic_batch_eligible(h, l, s, d, itemsize)
    return _group_size(b * h, l, s, d, itemsize) >= 2


def attention_vmem_plain(q, k, v, lens: Optional[torch.Tensor], causal: bool = False):
    """The plain PyTorch version: (B, H, L, Dh) x3 -> (B, H, L, Dh) in q's dtype."""
    dt = q.dtype
    scale = torch.full((), 1.0 / math.sqrt(q.shape[-1]), dtype=dt, device=q.device)
    s = matmul_f32(q * scale, k.transpose(-1, -2))
    ok = key_mask(lens, causal, q.shape[2], k.shape[2], q.device)
    if ok is not None:
        s = s.masked_fill(~ok, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True).detach()).to(dt)
    acc = matmul_f32(p, v)
    denom = p.float().sum(dim=-1, keepdim=True)
    return (acc / denom.clamp(min=1e-30)).to(dt)


def smem_bytes(dh: int) -> int:
    """Shared memory of one block of ``csrc/attention_vmem.cu``: the Q tile
    and two stages each of K and V blocks, rows padded to 16 + 8 elements.
    It does not depend on the row length."""
    return (ROW_BQ + 4 * ROW_BK) * ((dh + 15) // 16 * 16 + 8) * 2


def rowwise_attention(q, k, v, lens, out, causal: bool, vmem_rounding: bool) -> None:
    """Launch the whole-row kernel of ``csrc/attention_vmem.cu`` into ``out``.
    ``vmem_rounding``: attention_vmem's rounding points; else masked_sdpa's
    (f32 softmax normalized, then rounded: the mha_block core)."""
    b, h, l, dh = q.shape
    s = k.shape[2]
    q, k, v, lens_dev, strides = launch_args(q, k, v, lens, out)
    if vmem_rounding:
        scale = float(torch.tensor(1.0 / math.sqrt(dh), dtype=torch.bfloat16))
    else:
        scale = 1.0 / math.sqrt(dh)
    lib = _build.load()
    _build.check(
        lib.scl_rowwise_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if lens_dev is None else lens_dev.data_ptr(), out.data_ptr(),
            b, h, l, s, dh, strides, int(causal), int(vmem_rounding), scale,
            _build.stream(q.device),
        ),
        "scl_rowwise_attention",
    )


def attention_vmem(q, k, v, lens: Optional[torch.Tensor] = None,
                   causal: bool = False, plain: bool = False) -> torch.Tensor:
    """(B, H, L, Dh) x3 [+ lens (B,)] -> (B, H, L, Dh) through the op
    ``speechclip::attention_vmem``. CPU tensor or ``plain``: the plain
    version. CUDA tensor: the kernel, or an exception. Differentiable: where
    an input requires grad, through ``AttentionVmemFn`` (``plain``: the
    plain version's own autograd)."""
    if plain:
        return attention_vmem_plain(q, k, v, lens, causal)
    _ops.check_device(q, "attention_vmem")
    if needs_grad(q, k, v):
        return AttentionVmemFn.apply(q, k, v, lens, bool(causal))
    return _ops.attention_vmem(q, k, v, lens, bool(causal))


def attention_vmem_cuda(q, k, v, lens: Optional[torch.Tensor], causal: bool) -> torch.Tensor:
    """The op's CUDA implementation: the kernel, counted in
    ``attention_vmem.launches``; zero rows return the empty output without
    a launch."""
    check_attention_operands(q, k, v, lens, "attention_vmem")
    b, h, l, dh = q.shape
    out = empty_heads_out(b, h, l, dh, q.device)
    if out.numel() == 0:
        return out
    rowwise_attention(q, k, v, lens, out, causal, vmem_rounding=True)
    attention_vmem.launches += 1
    return out


attention_vmem.launches = 0
attention_vmem.recomputes = 0
AttentionVmemFn = plain_grad_function("AttentionVmemFn", _ops.attention_vmem,
                                      attention_vmem_plain, attention_vmem)
