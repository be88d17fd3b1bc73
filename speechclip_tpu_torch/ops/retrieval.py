"""Speech -> image retrieval over an embedding gallery, and recall@k in
both directions (port of speechclip_tpu/ops/retrieval.py and the scoring
of speechclip_tpu/serving.py ``EncoderService.retrieve``).

Scores are full-precision f32 with TF32 off: the reference found that a
reduced-precision score matmul flips near-tie ranks
(docs/DESIGN_NOTES.md:239-241). Equal scores rank the lower index first,
as ``jax.lax.top_k`` does (``torch.topk`` leaves their order unspecified):
duplicate gallery rows under distinct ids are ordinary.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Sequence, Tuple

import torch

from ..utils import tracing


@contextmanager
def _full_f32_matmul():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def scores(feats: torch.Tensor, gallery: torch.Tensor) -> torch.Tensor:
    """(N, E) queries x (G, E) gallery -> (N, G) f32 cosine scores (both
    sides are expected L2-normalized)."""
    with _full_f32_matmul():
        return feats.float() @ gallery.float().T


def top_k(s: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last dim, descending, ties lower index first:
    ``jax.lax.top_k``'s order, from a stable descending sort."""
    values, idx = torch.sort(s, dim=-1, descending=True, stable=True)
    k = min(k, s.shape[-1])
    return values[..., :k], idx[..., :k]


def retrieve(
    feats: torch.Tensor, gallery: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k gallery rows per query -> (scores (N, k) f32, indices (N, k))."""
    with tracing.span("speechclip.retrieve", device=True):
        return top_k(scores(feats, gallery), k)


def recall_at_k(
    scores: torch.Tensor,  # (N_query, N_cand)
    query_gold_ids: torch.Tensor,  # (N_query,)
    cand_ids: torch.Tensor,  # (N_cand,)
    recall_at: Sequence[int],
) -> Dict[str, float]:
    """recall@k x100: a query hits at k if any of its top-k candidates
    carries its gold id."""
    k_max = min(max(recall_at), scores.shape[1])
    _, idx = top_k(scores, k_max)
    hit = cand_ids.to(idx.device)[idx] == query_gold_ids.to(idx.device)[:, None]
    return {
        f"recall@{k}": float(hit[:, : min(k, k_max)].any(dim=1).float().mean() * 100.0)
        for k in recall_at
    }


def mutual_retrieval(
    score_per_a: torch.Tensor,  # (N_A, N_B)
    score_per_b: torch.Tensor,  # (N_B, N_A)
    ab_answers: torch.Tensor,  # (N_A,) gold pair id per A row
    ba_answers: torch.Tensor,  # (N_B,) gold pair id per B row
    recall_at: Sequence[int],
) -> Tuple[Dict[str, float], Dict[str, float], Dict[str, float]]:
    """recall@k A -> B, B -> A and their mean (x100)."""
    if tuple(score_per_a.shape) != (len(ab_answers), len(ba_answers)) or tuple(
            score_per_b.shape) != (len(ba_answers), len(ab_answers)):
        raise ValueError(
            f"scores {tuple(score_per_a.shape)} / {tuple(score_per_b.shape)} do not match "
            f"{len(ab_answers)} A rows and {len(ba_answers)} B rows")
    recall_ab = recall_at_k(score_per_a, ab_answers, ba_answers, recall_at)
    recall_ba = recall_at_k(score_per_b, ba_answers, ab_answers, recall_at)
    recall_mean = {k: (recall_ab[k] + recall_ba[k]) / 2.0 for k in recall_ab}
    return recall_ab, recall_ba, recall_mean
