"""The branch transformer bodies (port of speechclip_tpu/ops/transformer.py):

- ``transformer_encoder``: N torch-style encoder layers (post-norm by
  default, GELU FFN) plus a final LayerNorm, the parallel branch's body;
- ``mha_and_norm``: LayerNorm(MHA(src) + src), the cascaded branch's body
  (one 768-wide head in SpeechCLIP base);
- ``branch_transformer_{init,apply,hidden_states}``: the switch over the
  two by ``transformer_type``.

A layer runs through ``kernels.fused_layer`` where its gates admit the
shapes and no dropout is active (``not (train and dropout_rate > 0)``,
as in JAX), else unfused with ``ops.attention.multi_head_attention`` and
the JAX package's dropout placement. Under a live model axis
(``parallel.tensor.model_mesh``) the unfused layer is tensor-parallel:
``linear1`` column-parallel, ``linear2`` row-parallel, attention on the
rank's heads (``ops/attention.py``). Key
masking is by per-batch valid lengths; a bare key-padding mask (the
hidden-state and attention-map extractions, as in the reference) keeps
the layer unfused on ``sdpa_plain``.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from .attention import multi_head_attention
from .basic import (
    Params,
    dropout,
    gelu,
    layer_norm,
    layer_norm_init,
    linear,
    linear_init,
    uniform,
)
from ..kernels.fused_layer import fused_encoder_layer, fused_mha_and_norm
from ..parallel import tensor as tp


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
    key_padding_mask: Optional[torch.Tensor] = None,
    activation: str = "gelu",
    layer_norm_eps: float = 1e-5,
    norm_first: bool = False,
    dropout_rate: float = 0.0,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    plain: bool = False,
) -> torch.Tensor:
    """torch nn.TransformerEncoderLayer: the fused layer where its gates
    admit the shapes and no dropout is active, else the unfused layer of the
    JAX package (ops/transformer.py ``encoder_layer_apply``), with dropout
    on the attention weights, the attention output, the FFN's middle and its
    output in train mode; tensor-parallel under a live model axis."""
    if activation != "gelu":
        raise NotImplementedError(
            f"activation {activation!r}: the branches run GELU layers only"
        )
    if not (train and dropout_rate > 0) and (
            key_padding_mask is None or key_valid_lens is not None):
        fused = fused_encoder_layer(
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
        if fused is not None:
            return fused

    drop = lambda h: dropout(h, dropout_rate, train, generator)

    def sa(h):
        return drop(multi_head_attention(
            params["self_attn"], h, h, h, num_heads=nhead,
            key_padding_mask=key_padding_mask, key_valid_lens=key_valid_lens,
            dropout_rate=dropout_rate, train=train, generator=generator, plain=plain,
        )[0])

    def ff(h):
        mid = gelu(tp.linear_col(params["linear1"], h, "linear1 input"))
        mid = dropout(mid, dropout_rate, train, generator, tp.split_of(params["linear1"]))
        return drop(tp.linear_row(params["linear2"], mid, "linear2 output"))

    if norm_first:
        x = x + sa(layer_norm(params["norm1"], x, layer_norm_eps))
        return x + ff(layer_norm(params["norm2"], x, layer_norm_eps))
    x = layer_norm(params["norm1"], x + sa(x), layer_norm_eps)
    return layer_norm(params["norm2"], x + ff(x), layer_norm_eps)


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
    key_padding_mask: Optional[torch.Tensor] = None,
    activation: str = "gelu",
    layer_norm_eps: float = 1e-5,
    norm_first: bool = False,
    dropout_rate: float = 0.0,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    plain: bool = False,
    return_hidden_states: bool = False,
):
    """The layer stack, then the final LayerNorm (eps 1e-5 regardless of
    ``layer_norm_eps``, as the reference's). ``return_hidden_states``: also
    the input and every layer's output, without the final norm, as
    ``(out, hiddens)``."""
    x = src
    hiddens: List[torch.Tensor] = []
    for layer in params["layers"]:
        hiddens.append(x)
        x = encoder_layer_apply(
            layer,
            x,
            nhead=nhead,
            key_valid_lens=key_valid_lens,
            key_padding_mask=key_padding_mask,
            activation=activation,
            layer_norm_eps=layer_norm_eps,
            norm_first=norm_first,
            dropout_rate=dropout_rate,
            train=train,
            generator=generator,
            plain=plain,
        )
    hiddens.append(x)
    out = layer_norm(params["norm"], x, 1e-5)
    return (out, tuple(hiddens)) if return_hidden_states else out


def mha_and_norm_init(generator: torch.Generator, d_model: int) -> Params:
    return {"attn": mha_init(generator, d_model), "norm": layer_norm_init(d_model, generator.device)}


def mha_and_norm_apply(
    params: Params,
    src: torch.Tensor,  # (B, T, D)
    *,
    nhead: int,
    key_padding_mask: Optional[torch.Tensor] = None,
    key_valid_lens: Optional[torch.Tensor] = None,
    layer_norm_eps: float = 1e-5,
    dropout_rate: float = 0.0,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    need_weights: bool = False,
    plain: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """LayerNorm(MHA(src) + src) -> (out, per-head weights (B, H, T, T) if
    ``need_weights`` else None); in train mode the attention weights take
    dropout. The fused ``mha_layer_block`` where its gates admit the shapes
    and no dropout is active (never at one 768-wide head: Dh > 128), else
    ``multi_head_attention``, whose route is ``sdpa_plain`` under "auto"
    and ``flash_attention`` under "pallas" at that head."""
    if not need_weights and not (train and dropout_rate > 0) and (
            key_padding_mask is None or key_valid_lens is not None):
        fused = fused_mha_and_norm(
            src, key_valid_lens, heads=nhead, eps=layer_norm_eps,
            attn=params["attn"], norm=params["norm"], plain=plain,
        )
        if fused is not None:
            return fused, None
    attn_out, weights = multi_head_attention(
        params["attn"], src, src, src, num_heads=nhead,
        key_padding_mask=key_padding_mask, key_valid_lens=key_valid_lens,
        dropout_rate=dropout_rate, train=train, generator=generator,
        need_weights=need_weights, average_attn_weights=False, plain=plain,
    )
    return layer_norm(params["norm"], attn_out + src, layer_norm_eps), weights


TRANSFORMER_TYPES = ("TransformerEncoder", "MultiheadAttentionAndNorm")


def branch_transformer_init(generator: torch.Generator, kind: str, branch_cfg) -> Params:
    """``kind``: the ``transformer_type``; ``branch_cfg``: the branch's
    ``config.BranchConfig`` or ``config.CascadedBranchConfig``."""
    if kind == "TransformerEncoder":
        return transformer_encoder_init(
            generator, branch_cfg.n_layers, branch_cfg.d_model, branch_cfg.dim_feedforward
        )
    if kind == "MultiheadAttentionAndNorm":
        return mha_and_norm_init(generator, branch_cfg.d_model)
    raise NotImplementedError(f"transformer type {kind!r}")


def branch_transformer_apply(
    params: Params,
    kind: str,
    branch_cfg,
    src: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor],
    key_valid_lens: Optional[torch.Tensor] = None,
    plain: bool = False,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """The body in eval mode, or in train mode with ``branch_cfg.dropout``
    drawn from ``generator``."""
    if kind == "TransformerEncoder":
        return transformer_encoder_apply(
            params, src, nhead=branch_cfg.nhead, key_valid_lens=key_valid_lens,
            key_padding_mask=key_padding_mask, activation=branch_cfg.activation,
            layer_norm_eps=branch_cfg.layer_norm_eps, norm_first=branch_cfg.norm_first,
            dropout_rate=branch_cfg.dropout, train=train, generator=generator, plain=plain,
        )
    if kind == "MultiheadAttentionAndNorm":
        return mha_and_norm_apply(
            params, src, nhead=branch_cfg.nhead, key_padding_mask=key_padding_mask,
            key_valid_lens=key_valid_lens, layer_norm_eps=branch_cfg.layer_norm_eps,
            dropout_rate=branch_cfg.dropout, train=train, generator=generator, plain=plain,
        )[0]
    raise NotImplementedError(f"transformer type {kind!r}")


def branch_transformer_hidden_states(
    params: Params,
    kind: str,
    branch_cfg,
    src: torch.Tensor,
    key_padding_mask: Optional[torch.Tensor],
    plain: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """All hidden states (the input and each layer's output), eval mode;
    masking by the key-padding mask alone, as the reference extracts them."""
    if kind == "TransformerEncoder":
        return transformer_encoder_apply(
            params, src, nhead=branch_cfg.nhead, key_padding_mask=key_padding_mask,
            activation=branch_cfg.activation, layer_norm_eps=branch_cfg.layer_norm_eps,
            norm_first=branch_cfg.norm_first, plain=plain, return_hidden_states=True,
        )[1]
    if kind == "MultiheadAttentionAndNorm":
        out, _ = mha_and_norm_apply(
            params, src, nhead=branch_cfg.nhead, key_padding_mask=key_padding_mask,
            layer_norm_eps=branch_cfg.layer_norm_eps, plain=plain,
        )
        return (src, out)
    raise NotImplementedError(f"transformer type {kind!r}")
