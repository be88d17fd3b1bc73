"""Learnable softmax-weighted sum over encoder hidden states (port of
speechclip_tpu/ops/weighted_sum.py)."""

from __future__ import annotations

from typing import Sequence, Union

import torch

from .basic import Params, layer_norm


def weighted_sum_init(n_weights: int, device) -> Params:
    return {"weights": torch.zeros(n_weights, dtype=torch.float32, device=device)}


def weighted_sum_apply(
    params: Params,
    hidden_states: Union[Sequence[torch.Tensor], torch.Tensor],
    normalize_features: bool = False,
) -> torch.Tensor:
    """softmax(weights) . states. A sequence of states without per-state
    normalization takes the unrolled f32 multiply-add chain (the reference's
    order of accumulation), cast back to the state dtype. A stacked
    (N, B, T, D) tensor, or ``normalize_features`` (per-state LayerNorm, the
    s3prl mode), takes the stacked form: weights cast to the state dtype,
    products accumulated in f32."""
    w = torch.softmax(params["weights"].float(), dim=0)
    if not torch.is_tensor(hidden_states) and not normalize_features:
        states = list(hidden_states)
        if len(states) != w.shape[0]:
            raise ValueError(f"{len(states)} states for {w.shape[0]} weights")
        acc = w[0] * states[0].float()
        for i in range(1, len(states)):
            acc = acc + w[i] * states[i].float()
        return acc.to(states[0].dtype)
    x = hidden_states if torch.is_tensor(hidden_states) else torch.stack(list(hidden_states))
    if x.shape[0] != w.shape[0]:
        raise ValueError(f"{x.shape[0]} states for {w.shape[0]} weights")
    if normalize_features:
        x = layer_norm(None, x)
    wx = w.to(x.dtype).float()
    return torch.einsum("n,nbtd->btd", wx, x.float()).to(x.dtype)
