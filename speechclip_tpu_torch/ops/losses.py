"""Contrastive objectives (port of speechclip_tpu/ops/losses.py).

``masked_contrastive_loss`` is the reference's MaskedContrastiveLoss:
symmetric InfoNCE over an (A, B) feature pair with id-aware negatives
(other captions of the same image leave the negative set), as a masked
logsumexp over the whole batch's logits. ``supcon_loss`` is the supervised
contrastive loss, selectable as ``cl_loss.type: SupConLoss``. The
all-gather variant for data-parallel training waits for the ROADMAP item
"Training" (DDP).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .basic import Params

NEG_INF = float(torch.finfo(torch.float32).min)


def contrastive_temp_init(temperature: float = 0.07, temperature_trainable: bool = False,
                          device=None) -> Params:
    """A trainable temperature is kept as ``log_inv_temp`` = log(1 / t)."""
    if temperature_trainable:
        return {"log_inv_temp": torch.tensor(math.log(1.0 / temperature), dtype=torch.float32,
                                             device=device)}
    return {}


def contrastive_temperature(params: Params, temperature: float,
                            temperature_trainable: bool) -> torch.Tensor:
    """The logits' scale, 1 / t: ``exp(log_inv_temp)`` when trainable."""
    if temperature_trainable:
        return torch.exp(params["log_inv_temp"])
    return torch.tensor(1.0 / temperature, dtype=torch.float32)


def masked_contrastive_loss(
    params: Params,
    feat_a: torch.Tensor,  # (N, D) L2-normalized
    feat_b: torch.Tensor,  # (N, D) L2-normalized, row-aligned positives
    ids: Optional[torch.Tensor] = None,  # (N,) pair ids
    *,
    temperature: float = 0.07,
    temperature_trainable: bool = False,
    margin: float = 0.0,
    dcl: bool = False,
    a2b: bool = True,
    b2a: bool = True,
) -> torch.Tensor:
    """f32 scalar: the mean over rows (a -> b) and columns (b -> a) of
    ``logsumexp(negatives and the positive) - positive``, halved when both
    directions count. ``margin`` comes off the positives' logits; ``dcl``
    leaves the positive out of its own denominator."""
    if not (a2b or b2a):
        raise ValueError("masked_contrastive_loss needs a2b or b2a")
    n = feat_a.shape[0]
    temp = contrastive_temperature(params, temperature, temperature_trainable)
    logits = (feat_a.float() @ feat_b.float().T) * temp
    eye = torch.eye(n, dtype=torch.bool, device=logits.device)
    if margin > 0.0:
        logits = logits - margin * eye.float()
    neg_mask = ids[:, None] != ids[None, :] if ids is not None else ~eye
    if not dcl:
        neg_mask = neg_mask | eye
    pos = torch.diagonal(logits)
    masked = logits.masked_fill(~neg_mask, NEG_INF)
    loss = torch.zeros((), dtype=torch.float32, device=logits.device)
    if a2b:
        loss = loss + (torch.logsumexp(masked, dim=1) - pos).mean()
    if b2a:
        loss = loss + (torch.logsumexp(masked, dim=0) - pos).mean()
    return loss / 2 if a2b and b2a else loss


def supcon_loss(
    features: torch.Tensor,  # (B, n_views, D) L2-normalized
    temperature=0.07,
    labels: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    contrast_mode: str = "all",
    base_temperature: float = 0.07,
) -> torch.Tensor:
    """Supervised contrastive loss (Khosla et al. 2020): positives are the
    other views of the anchor's label (``labels``), or ``mask[i, j]``, or
    the anchor's own other views."""
    if features.dim() != 3:
        raise ValueError(f"features must be (B, n_views, D), got {tuple(features.shape)}")
    bsz, n_views, _ = features.shape
    if labels is not None and mask is not None:
        raise ValueError("cannot define both labels and mask")
    if labels is None and mask is None:
        mask = torch.eye(bsz, dtype=torch.float32, device=features.device)
    elif labels is not None:
        labels = labels.reshape(-1, 1)
        mask = (labels == labels.T).float()
    else:
        mask = mask.float()
    contrast = torch.cat([features[:, i] for i in range(n_views)], dim=0)
    if contrast_mode == "one":
        anchor, anchor_count = features[:, 0], 1
    elif contrast_mode == "all":
        anchor, anchor_count = contrast, n_views
    else:
        raise ValueError(contrast_mode)
    logits = (anchor @ contrast.T) / temperature
    logits = logits - logits.amax(dim=1, keepdim=True).detach()
    mask = mask.repeat(anchor_count, n_views)
    n_anchor = bsz * anchor_count
    self_mask = 1.0 - torch.eye(n_anchor, mask.shape[1], device=features.device)
    mask = mask * self_mask
    exp_logits = torch.exp(logits) * self_mask
    log_prob = logits - torch.log(exp_logits.sum(dim=1, keepdim=True))
    mean_log_prob_pos = (mask * log_prob).sum(dim=1) / mask.sum(dim=1)
    loss = -(1.0 / base_temperature) * mean_log_prob_pos
    return loss.reshape(anchor_count, bsz).mean()
