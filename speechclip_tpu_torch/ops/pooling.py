"""Pooling heads (port of speechclip_tpu/ops/pooling.py, the reference's
avssl/module/pooling.py): ``mean_pooling`` and the bilinear attentive
pooling family. Module-level APIs of the reference, on no SpeechCLIP path.

Masked means and masked softmaxes over padded batches stand in for the
reference's per-row slicing. Params are the JAX package's dicts.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .basic import Params, linear, linear_init
from .masking import valid_mask

_NEG_INF = torch.finfo(torch.float32).min


# ---------------------------------------------------------------------------
# mean pooling
# ---------------------------------------------------------------------------
def mean_pooling_init(generator: torch.Generator, in_dim: int = 0, out_dim: int = 0,
                      bias: bool = True, pre_proj: bool = True,
                      post_proj: bool = True) -> Params:
    """Optional linear projections before and after the mean (both only
    when ``in_dim`` and ``out_dim`` are set)."""
    params: Params = {"pre_proj": None, "post_proj": None}

    def proj(i, o):
        p = linear_init(generator, i, o)
        return p if bias else {"w": p["w"], "b": None}

    if in_dim > 0 and out_dim > 0:
        if pre_proj:
            params["pre_proj"] = proj(in_dim, out_dim)
        if post_proj:
            params["post_proj"] = proj(out_dim if pre_proj else in_dim, out_dim)
    return params


def mean_pooling_apply(params: Params, x: torch.Tensor,
                       x_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, T, D) -> (B, D'): the mean over each row's first ``x_len``
    frames (all frames without lengths), between the projections."""
    if params.get("pre_proj") is not None:
        x = linear(params["pre_proj"], x)
    if x_len is not None:
        mask = valid_mask(x_len.to(x.device), x.shape[1]).to(x.dtype)
        x = (x * mask[..., None]).sum(dim=1) / mask.sum(dim=1, keepdim=True).clamp(min=1.0)
    else:
        x = x.mean(dim=1)
    if params.get("post_proj") is not None:
        x = linear(params["post_proj"], x)
    return x


# ---------------------------------------------------------------------------
# attentive pooling: learnable bilinear U, tanh alignment, max then softmax
# ---------------------------------------------------------------------------
def attentive_pooling_init(generator: torch.Generator, dim_a: int, dim_b: int,
                           degraded: bool = False) -> Params:
    """U ~ N(0, 1), or the identity when ``degraded`` (dim_a == dim_b)."""
    if degraded:
        if dim_a != dim_b:
            raise ValueError(f"degraded attentive pooling needs dim_a == dim_b ({dim_a}, {dim_b})")
        return {"U": torch.eye(dim_a, dtype=torch.float32, device=generator.device)}
    return {"U": torch.randn((dim_a, dim_b), generator=generator, device=generator.device)}


def attentive_pooling_mask(a_lens: Optional[torch.Tensor], b_lens: Optional[torch.Tensor],
                           max_a: int, max_b: int) -> torch.Tensor:
    """Additive (B, max_a, max_b) f32 mask: 0 where both positions are
    valid, the f32 minimum where either is padding (reference
    ``generate_input_msk`` :90-146)."""
    if a_lens is None and b_lens is None:
        raise ValueError("attentive_pooling_mask needs a_lens or b_lens")
    lens = a_lens if a_lens is not None else b_lens
    msk = torch.zeros((lens.shape[0], max_a, max_b), dtype=torch.float32, device=lens.device)
    if a_lens is not None:
        msk = msk.masked_fill(~valid_mask(a_lens, max_a)[:, :, None], _NEG_INF)
    if b_lens is not None:
        msk = msk.masked_fill(~valid_mask(b_lens, max_b)[:, None, :], _NEG_INF)
    return msk


def attentive_pooling_apply(params: Params, input_a: torch.Tensor, input_b: torch.Tensor,
                            input_msk: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paired pooling (reference forward :314-390): (B, dim_A, T_A) and
    (B, dim_B, T_B) -> ((B, dim_A), (B, dim_B))."""
    align = torch.tanh(torch.einsum("bdt,de,bes->bts", input_a, params["U"].to(input_a.dtype),
                                    input_b))
    if input_msk is not None:
        align = align + input_msk.to(align.dtype)
    score_a = torch.softmax(align.amax(dim=2), dim=-1)  # (B, T_A)
    score_b = torch.softmax(align.amax(dim=1), dim=-1)  # (B, T_B)
    return (torch.einsum("bdt,bt->bd", input_a, score_a),
            torch.einsum("bds,bs->bd", input_b, score_b))


def attentive_pooling_batch_apply(params: Params, input_a: torch.Tensor, input_b: torch.Tensor,
                                  input_msk: Optional[torch.Tensor] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-batch pooling (reference batch_forward :148-240): every A row
    against every B row -> ((B_A, B_B, dim_A), (B_A, B_B, dim_B));
    ``input_msk`` is (B_A, T_A, T_B)."""
    align = torch.tanh(torch.einsum("adt,de,bes->abts", input_a,
                                    params["U"].to(input_a.dtype), input_b))
    if input_msk is not None:
        align = align + input_msk[:, None].to(align.dtype)
    score_a = torch.softmax(align.amax(dim=3), dim=-1)  # (B_A, B_B, T_A)
    score_b = torch.softmax(align.amax(dim=2), dim=-1)  # (B_A, B_B, T_B)
    return (torch.einsum("adt,abt->abd", input_a, score_a),
            torch.einsum("bds,abs->abd", input_b, score_b))
