"""One transformer encoder layer as the two fused half-layers (port of
speechclip_tpu/kernels/fused_layer.py ``fused_encoder_layer``).

Both layer flavors of the model have the same algebra: fairseq
TransformerSentenceEncoderLayer (HuBERT) and torch nn.TransformerEncoderLayer
(the parallel branch), post-norm or pre-norm, GELU FFN, eval mode.

Routing, decided by the activations alone (in the two wrappers):
- CPU tensor -> the plain PyTorch versions;
- CUDA bf16 tensor, no grad -> the hand-written kernels;
- any other tensor (CUDA f32, one that requires grad, another device) ->
  raise.
``plain=True`` is the explicit request for the plain versions on any
device; the card's checks compare the kernel path against it.

The JAX package's ``_dispatch.py`` (shard_map over a TPU mesh) has no
counterpart: under torch each rank already holds its local batch.
"""

from __future__ import annotations

from typing import Optional

import torch

from .ffn_block import ffn_block, ffn_block_plain
from .mha_block import mha_layer_block, mha_layer_block_plain


def fused_encoder_layer(
    x: torch.Tensor,  # (B, T, D)
    lens: Optional[torch.Tensor],  # (B,) valid key lengths, or None
    *,
    heads: int,
    mode: str,  # "post" | "pre"
    eps: float,
    attn,  # {"in_proj": {w, b}, "out_proj": {w, b}}
    fc1,  # {"w", "b"}
    fc2,
    ln1,  # {"scale", "bias"} around attention
    ln2,  # {"scale", "bias"} around the FFN
    plain: bool = False,
) -> torch.Tensor:
    d = x.shape[-1]
    bi = attn["in_proj"]["b"]
    bo = attn["out_proj"]["b"]
    if bi is None:
        bi = torch.zeros(3 * d, dtype=torch.float32, device=x.device)
    if bo is None:
        bo = torch.zeros(d, dtype=torch.float32, device=x.device)
    if plain:
        mha, ffn = mha_layer_block_plain, ffn_block_plain
    else:
        mha, ffn = mha_layer_block, ffn_block
    h = mha(
        x, attn["in_proj"]["w"], bi, attn["out_proj"]["w"], bo,
        ln1["scale"], ln1["bias"], lens, heads, mode, eps,
    )
    return ffn(
        h, fc1["w"], fc1["b"], fc2["w"], fc2["b"], ln2["scale"], ln2["bias"],
        mode, eps,
    )
