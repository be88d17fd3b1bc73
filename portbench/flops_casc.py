"""Model FLOPs of a cascaded model's train step, counted as ``flops.py``
counts the parallel model's (2 FLOPs a multiply-add, at the shapes the step
computes; recomputes, elementwise work and normalizations left out):

- HuBERT's forward (frozen): ``flops.hubert_flops``;
- the keyword head, trainable, forward and backward (3x the forward): the
  MHA-and-norm over all K + T rows of [CLS; frames], as the program runs it
  (projections and the (K + T)^2 scores and weighted values), and the K
  rows' projection to the text width;
- the cosine scores and the product with the token table, each
  2 * B * K * width * V forward and as much again for the keywords'
  gradient (the table is frozen);
- the text tower (frozen) at B * (K + 2) tokens: its forward and its
  input's gradient (2x the forward), with the EOT row's projection;
- the loss, 3x its forward, as ``flops.train_step_flops``.
"""

from __future__ import annotations

from typing import Dict

from .flops import conv_out_len, encoder_layer_flops, hubert_flops


def head_flops(c: Dict, text_dim: int, b: int, frames: int) -> float:
    """The keyword head's forward at T = ``frames``."""
    t, d, k = frames + c["keyword_number"], c["d_model"], c["keyword_number"]
    attention = 2.0 * b * t * 4 * d * d + 4.0 * b * t * t * d
    return attention + 2.0 * b * k * d * text_dim


def text_flops(t: Dict, b: int, tokens: int) -> float:
    """The text tower's forward over ``tokens`` rows a sentence, with the
    pooled row's projection."""
    w = t["width"]
    return (t["layers"] * encoder_layer_flops(b, tokens, w, 4 * w)
            + 2.0 * b * w * t["output_dim"])


def vocab_rows(t: Dict) -> int:
    return int(t.get("reduced_rows") or t["vocab_size"])


def train_step_flops(sizes: Dict, b: int, samples: int) -> float:
    a, c, t = sizes["audio"], sizes["cascaded_branch"], sizes["text"]
    e = sizes["vision"]["output_dim"]
    frames = conv_out_len(samples, a["conv_layers"])[-1]
    k, w = c["keyword_number"], t["width"]
    choice = 2 * (2.0 * b * k * w * vocab_rows(t))  # the cosine and the table product
    return (hubert_flops(a, b, samples) + 3.0 * head_flops(c, w, b, frames) + 2.0 * choice
            + 2.0 * text_flops(t, b, k + 2) + 3.0 * 2.0 * b * b * e)
