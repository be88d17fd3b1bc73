"""Speech -> image retrieval over an embedding gallery (port of
speechclip_tpu/ops/retrieval.py and the scoring of
speechclip_tpu/serving.py ``EncoderService.retrieve``).

Scores are full-precision f32 with TF32 off: the reference found that a
reduced-precision score matmul flips near-tie ranks
(docs/DESIGN_NOTES.md:239-241).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Sequence, Tuple

import torch


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


def retrieve(
    feats: torch.Tensor, gallery: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k gallery rows per query -> (scores (N, k) f32, indices (N, k))."""
    s = scores(feats, gallery)
    return torch.topk(s, min(k, s.shape[1]), dim=1)


def recall_at_k(
    scores: torch.Tensor,  # (N_query, N_cand)
    query_gold_ids: torch.Tensor,  # (N_query,)
    cand_ids: torch.Tensor,  # (N_cand,)
    recall_at: Sequence[int],
) -> Dict[str, float]:
    """recall@k x100: a query hits at k if any of its top-k candidates
    carries its gold id."""
    k_max = min(max(recall_at), scores.shape[1])
    _, idx = torch.topk(scores, k_max, dim=1)
    hit = cand_ids.to(idx.device)[idx] == query_gold_ids.to(idx.device)[:, None]
    return {
        f"recall@{k}": float(hit[:, : min(k, k_max)].any(dim=1).float().mean() * 100.0)
        for k in recall_at
    }
