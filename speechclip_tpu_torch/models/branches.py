"""The parallel branch (port of speechclip_tpu/models/branches.py:126-141,
308-348): a learnable CLS row prepended to the audio features, a
TransformerEncoder over (CLS + frames), the CLS output projected to the
image-embedding width."""

from __future__ import annotations

import torch

from ..ops.basic import Params, linear, linear_init, normal
from ..ops.transformer import transformer_encoder_apply, transformer_encoder_init


def _prepend_cls(params: Params, audio_feat: torch.Tensor) -> torch.Tensor:
    """(B, T, D) -> (B, K + T, D) with the K learnable cls rows first."""
    cls = params["cls"].to(audio_feat.dtype)
    cls = cls.expand(audio_feat.shape[0], *cls.shape[1:])
    return torch.cat([cls, audio_feat], dim=1)


def parallel_branch_init(
    generator: torch.Generator, branch_cfg, audio_dim: int, out_dim: int
) -> Params:
    d_model = branch_cfg.d_model
    params: Params = {
        "cls": normal((1, 1, d_model), 1.0, generator),
        "transformer": transformer_encoder_init(
            generator, branch_cfg.n_layers, d_model, branch_cfg.dim_feedforward
        ),
    }
    if branch_cfg.need_projection:
        params["proj"] = linear_init(generator, audio_dim, out_dim)
    return params


def parallel_branch_apply(
    params: Params,
    branch_cfg,
    audio_feat: torch.Tensor,  # (B, T, D)
    audio_len: torch.Tensor,  # (B,) feature lengths
    plain: bool = False,
) -> torch.Tensor:
    """-> (B, out_dim). Keys are masked with ``audio_len + 1`` (the CLS)."""
    src = _prepend_cls(params, audio_feat)
    out = transformer_encoder_apply(
        params["transformer"],
        src,
        nhead=branch_cfg.nhead,
        key_valid_lens=audio_len + params["cls"].shape[1],
        activation=branch_cfg.activation,
        layer_norm_eps=branch_cfg.layer_norm_eps,
        norm_first=branch_cfg.norm_first,
        plain=plain,
    )
    out = out[:, 0]
    if "proj" in params:
        out = linear(params["proj"], out)
    return out
