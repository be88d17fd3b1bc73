"""The CLIP text tower, eval mode (port of the text side of
speechclip_tpu/models/clip.py): pre-norm residual blocks with QuickGELU
and causal multi-head attention, ``encode_text`` over token ids,
``encode_keywords`` (the cascaded branch's way into the tower), and the
reduced subword vocabulary. The image towers wait for the gallery slice.

Parameters: the JAX package's ``params["clip"]`` tree with the ``text``
subtree only, linear weights (in, out).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import CLIPTextConfig
from ..ops.attention import multi_head_attention
from ..ops.basic import Params, layer_norm, layer_norm_init, linear, normal, quick_gelu


def _block_init(generator: torch.Generator, width: int, ffn: int) -> Params:
    dev = generator.device
    std = width**-0.5

    def lin(i, o):
        return {"w": normal((i, o), std, generator),
                "b": torch.zeros(o, dtype=torch.float32, device=dev)}

    return {
        "attn": {"in_proj": lin(width, 3 * width), "out_proj": lin(width, width)},
        "ln_1": layer_norm_init(width, dev),
        "mlp": {"c_fc": lin(width, ffn), "c_proj": lin(ffn, width)},
        "ln_2": layer_norm_init(width, dev),
    }


def text_init(generator: torch.Generator, cfg: CLIPTextConfig) -> Params:
    """Random text-tower params with the JAX package's distributions (real
    weights come through ``convert.from_jax``)."""
    return {
        "token_embedding": normal((cfg.vocab_size, cfg.width), 0.02, generator),
        "positional_embedding": normal((cfg.context_length, cfg.width), 0.01, generator),
        "blocks": [_block_init(generator, cfg.width, cfg.width * 4) for _ in range(cfg.layers)],
        "ln_final": layer_norm_init(cfg.width, generator.device),
        "text_projection": normal((cfg.width, cfg.output_dim), cfg.width**-0.5, generator),
    }


def _resblock(params: Params, x: torch.Tensor, heads: int, causal: bool,
              plain: bool = False) -> torch.Tensor:
    """x + MHA(LN(x)), then + MLP(LN(x)) with QuickGELU."""
    normed = layer_norm(params["ln_1"], x)
    h, _ = multi_head_attention(params["attn"], normed, normed, normed, num_heads=heads,
                                causal=causal, plain=plain)
    x = x + h
    y = layer_norm(params["ln_2"], x)
    return x + linear(params["mlp"]["c_proj"], quick_gelu(linear(params["mlp"]["c_fc"], y)))


def _text_transformer(params: Params, cfg: CLIPTextConfig, x: torch.Tensor,
                      plain: bool = False) -> torch.Tensor:
    for block in params["text"]["blocks"]:
        x = _resblock(block, x, cfg.heads, True, plain)
    return x


def encode_text(params: Params, cfg: CLIPTextConfig, text: torch.Tensor,
                eot_positions: Optional[torch.Tensor] = None,
                plain: bool = False) -> torch.Tensor:
    """(B, 77) token ids (reduced ids under a reduced vocabulary) ->
    (B, output_dim), in the token table's dtype. The pooled position is
    ``eot_positions``, else ``text.argmax(-1)`` (right for full-vocabulary
    ids only: under a reduced vocabulary EOT is not the largest id)."""
    emb = params["text"]["token_embedding"][text]
    x = emb + params["text"]["positional_embedding"].to(emb.dtype)
    x = _text_transformer(params, cfg, x, plain)
    x = layer_norm(params["text"]["ln_final"], x)
    if eot_positions is None:
        eot_positions = text.argmax(dim=-1)
    pooled = x[torch.arange(x.shape[0], device=x.device), eot_positions.long()]
    return pooled @ params["text"]["text_projection"].to(pooled.dtype)


def encode_keywords(params: Params, cfg: CLIPTextConfig, keywords: torch.Tensor,
                    sot_id: int, eot_id: int, plain: bool = False) -> torch.Tensor:
    """(B, K, width) keyword embeddings -> (B, output_dim): the sequence
    [SOT, K keywords, EOT] through the tower, pooled at the EOT (position
    K + 1). The reference pads to 77 tokens; under causal attention the EOT
    output depends on positions 0..K+1 only, so the K + 2 rows give the same
    result exactly (held against ``encode_text`` on the full buffer in the
    tests)."""
    b, k, w = keywords.shape
    table = params["text"]["token_embedding"]
    sot = table[sot_id].to(keywords.dtype).expand(b, 1, w)
    eot = table[eot_id].to(keywords.dtype).expand(b, 1, w)
    x = torch.cat([sot, keywords, eot], dim=1)
    x = x + params["text"]["positional_embedding"][: k + 2].to(x.dtype)
    x = _text_transformer(params, cfg, x, plain)
    x = layer_norm(params["text"]["ln_final"], x)
    pooled = x[:, k + 1]
    return pooled @ params["text"]["text_projection"].to(pooled.dtype)


@dataclasses.dataclass
class ReducedVocab:
    """A reduced subword vocabulary: row i of the cut token table is
    original id ``selected_ids[i]``."""

    selected_ids: np.ndarray  # (V_red,) original token ids
    original_to_reduced: dict
    reduced_to_original: dict
    freq_dist: np.ndarray  # (V_red,) normalized counts

    @property
    def size(self) -> int:
        return len(self.selected_ids)

    def map_original(self, ids: np.ndarray) -> np.ndarray:
        """Original ids -> reduced ids; raises on an id outside the table."""
        lut = np.full(int(self.selected_ids.max()) + 1, -1, np.int64)
        lut[self.selected_ids] = np.arange(len(self.selected_ids))
        mapped = lut[ids]
        if (mapped < 0).any():
            raise KeyError("token id outside the reduced vocabulary")
        return mapped

    def map_reduced(self, ids: np.ndarray) -> np.ndarray:
        return self.selected_ids[ids]


def load_reduced_vocab(npy_path: str) -> ReducedVocab:
    """A (V_red, 2) table of (original id, count) rows."""
    data = np.load(npy_path)
    selected = data[:, 0].astype(np.int64)
    freq = data[:, 1].astype(np.float64)
    return ReducedVocab(
        selected_ids=selected,
        original_to_reduced={int(o): i for i, o in enumerate(selected)},
        reduced_to_original={i: int(o) for i, o in enumerate(selected)},
        freq_dist=freq / freq.sum(),
    )


def reduce_token_embedding(params: Params, vocab: ReducedVocab) -> Params:
    """The clip params with the text token table cut to the vocabulary's
    rows (the full table is dropped, as in the JAX package)."""
    table = params["text"]["token_embedding"]
    idx = torch.from_numpy(vocab.selected_ids).to(table.device)
    return dict(params, text=dict(params["text"], token_embedding=table[idx]))
