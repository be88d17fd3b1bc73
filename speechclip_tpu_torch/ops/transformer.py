"""torch-style TransformerEncoder for the parallel branch (port of
speechclip_tpu/ops/transformer.py:38-186): N encoder layers (post-norm by
default, GELU FFN) plus a final LayerNorm, eval mode.

Every layer runs through ``kernels.fused_layer.fused_encoder_layer``; key
masking is by per-batch valid lengths.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .basic import Params, layer_norm, layer_norm_init, linear_init, uniform
from ..kernels.fused_layer import fused_encoder_layer


def mha_init(generator: torch.Generator, d_model: int) -> Params:
    """torch nn.MultiheadAttention init: xavier-uniform in_proj, zero biases,
    out_proj weight U(-1/sqrt(d), 1/sqrt(d))."""
    dev = generator.device
    limit = math.sqrt(6.0 / (d_model + 3 * d_model))
    return {
        "in_proj": {
            "w": uniform((d_model, 3 * d_model), limit, generator),
            "b": torch.zeros(3 * d_model, dtype=torch.float32, device=dev),
        },
        "out_proj": {
            "w": uniform((d_model, d_model), 1.0 / math.sqrt(d_model), generator),
            "b": torch.zeros(d_model, dtype=torch.float32, device=dev),
        },
    }


def encoder_layer_init(
    generator: torch.Generator, d_model: int, dim_feedforward: int
) -> Params:
    dev = generator.device
    return {
        "self_attn": mha_init(generator, d_model),
        "linear1": linear_init(generator, d_model, dim_feedforward),
        "linear2": linear_init(generator, dim_feedforward, d_model),
        "norm1": layer_norm_init(d_model, dev),
        "norm2": layer_norm_init(d_model, dev),
    }


def encoder_layer_apply(
    params: Params,
    x: torch.Tensor,
    *,
    nhead: int,
    key_valid_lens: Optional[torch.Tensor] = None,
    activation: str = "gelu",
    layer_norm_eps: float = 1e-5,
    norm_first: bool = False,
    plain: bool = False,
) -> torch.Tensor:
    if activation != "gelu":
        raise NotImplementedError(
            f"activation {activation!r}: the fused layer carries GELU only"
        )
    return fused_encoder_layer(
        x,
        key_valid_lens,
        heads=nhead,
        mode="pre" if norm_first else "post",
        eps=layer_norm_eps,
        attn=params["self_attn"],
        fc1=params["linear1"],
        fc2=params["linear2"],
        ln1=params["norm1"],
        ln2=params["norm2"],
        plain=plain,
    )


def transformer_encoder_init(
    generator: torch.Generator, n_layers: int, d_model: int, dim_feedforward: int
) -> Params:
    return {
        "layers": [
            encoder_layer_init(generator, d_model, dim_feedforward)
            for _ in range(n_layers)
        ],
        "norm": layer_norm_init(d_model, generator.device),
    }


def transformer_encoder_apply(
    params: Params,
    src: torch.Tensor,
    *,
    nhead: int,
    key_valid_lens: Optional[torch.Tensor] = None,
    activation: str = "gelu",
    layer_norm_eps: float = 1e-5,
    norm_first: bool = False,
    plain: bool = False,
) -> torch.Tensor:
    """The layer stack, then the final LayerNorm (eps 1e-5 regardless of
    ``layer_norm_eps``, as the reference's)."""
    x = src
    for layer in params["layers"]:
        x = encoder_layer_apply(
            layer,
            x,
            nhead=nhead,
            key_valid_lens=key_valid_lens,
            activation=activation,
            layer_norm_eps=layer_norm_eps,
            norm_first=norm_first,
            plain=plain,
        )
    return layer_norm(params["norm"], x, 1e-5)
