"""One transformer encoder layer as the two fused half-layers, and the
cascaded branch's MHA-and-norm as one (port of
speechclip_tpu/kernels/fused_layer.py ``fused_encoder_layer`` and
``fused_mha_and_norm``).

Both layer flavors of the model have the same algebra: fairseq
TransformerSentenceEncoderLayer (HuBERT) and torch nn.TransformerEncoderLayer
(the parallel branch), post-norm or pre-norm, GELU FFN, with no dropout
active (eval mode, or training at dropout 0, where the parallel branch's
layer and a trainable HuBERT's layers, "post" at base width and "pre" on
HuBERT-large, carry a gradient through the kernels' autograd.Functions; the
callers keep a layer with active dropout off this path, as JAX does).

The gate list is the JAX package's: bf16 activations, the "auto" attention
backend, ``block_eligible`` and no live model axis (``parallel.tensor.
model_mesh``: ``mha_layer_block`` needs the full-width LayerNorm and the
replicated out-projection, ``ffn_block`` fc2's partial sums across the
ranks before its bias and LayerNorm; JAX's ``mesh_plan`` steps aside there
too); any failure returns None and the caller runs the unfused layer (``multi_head_attention`` + the torch FFN chain). When
``ffn_eligible`` fails, the attention half still runs fused and the FFN half
is the torch chain (``linear``/``gelu``), which the JAX package leaves to XLA.

The route depends on shapes, dtype and backend alone; the device picks
the body: a CPU tensor, or ``plain=True``, runs the plain versions; a CUDA
bf16 tensor the hand-written kernels; any other tensor on a kernel route
raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from .ffn_block import ffn_block, ffn_block_plain, ffn_eligible
from .mha_block import block_eligible, mha_layer_block, mha_layer_block_plain
from ..ops.attention import get_attention_backend
from ..ops.basic import gelu, layer_norm, linear
from ..parallel.tensor import live_mesh


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
) -> Optional[torch.Tensor]:
    """The layer on the fused path, or None where the JAX gates send it to
    the unfused layer."""
    b, t, d = x.shape
    isz = x.element_size()
    if (x.dtype != torch.bfloat16 or get_attention_backend() != "auto"
            or live_mesh() is not None or not block_eligible(b, t, d, heads, isz)):
        return None
    bi = attn["in_proj"]["b"]
    bo = attn["out_proj"]["b"]
    if bi is None:
        bi = torch.zeros(3 * d, dtype=torch.float32, device=x.device)
    if bo is None:
        bo = torch.zeros(d, dtype=torch.float32, device=x.device)
    mha = mha_layer_block_plain if plain else mha_layer_block
    h = mha(
        x, attn["in_proj"]["w"], bi, attn["out_proj"]["w"], bo,
        ln1["scale"], ln1["bias"], lens, heads, mode, eps,
    )
    if ffn_eligible(b, t, d, fc1["w"].shape[1], isz):
        ffn = ffn_block_plain if plain else ffn_block
        return ffn(
            h, fc1["w"], fc1["b"], fc2["w"], fc2["b"], ln2["scale"], ln2["bias"],
            mode, eps,
        )
    h_in = layer_norm(ln2, h, eps) if mode == "pre" else h
    out = linear(fc2, gelu(linear(fc1, h_in)))
    return layer_norm(ln2, h + out, eps) if mode == "post" else h + out


def fused_mha_and_norm(
    src: torch.Tensor,  # (B, T, D)
    lens: Optional[torch.Tensor],
    *,
    heads: int,
    eps: float,
    attn,  # {"in_proj", "out_proj"}
    norm,  # {"scale", "bias"}
    plain: bool = False,
) -> Optional[torch.Tensor]:
    """LayerNorm(MHA(src) + src) as ``mha_layer_block`` with ln_mode
    "post", or None where the JAX gates (bf16, backend "auto",
    ``block_eligible``, no live model axis) send it to the unfused path. The cascaded branch's
    one 768-wide head fails ``block_eligible`` (Dh > 128), so it always
    returns None there."""
    b, t, d = src.shape
    if (src.dtype != torch.bfloat16 or get_attention_backend() != "auto"
            or live_mesh() is not None
            or not block_eligible(b, t, d, heads, src.element_size())):
        return None
    bi = attn["in_proj"]["b"]
    bo = attn["out_proj"]["b"]
    if bi is None:
        bi = torch.zeros(3 * d, dtype=torch.float32, device=src.device)
    if bo is None:
        bo = torch.zeros(d, dtype=torch.float32, device=src.device)
    mha = mha_layer_block_plain if plain else mha_layer_block
    return mha(src, attn["in_proj"]["w"], bi, attn["out_proj"]["w"], bo,
               norm["scale"], norm["bias"], lens, heads, "post", eps)
