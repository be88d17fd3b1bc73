"""The plain reference of SpeechCLIP's cascaded branch (Shih et al.,
SpeechCLIP, SLT 2022, section 2.3): K learnable keyword CLS rows prepended
to the speech features, one MultiheadAttentionAndNorm layer, the keyword
rows projected into the CLIP text-embedding space and batch-normalized per
keyword (kw-BN), scored by cosine against CLIP's token table, quantized to
the best subword with the soft choice's gradient (straight-through), taken
back through the table, and encoded by CLIP's frozen text tower as the
sentence [SOT, K keywords, EOT], whose EOT output is the branch's feature.

Plain PyTorch in float32 with TF32 off (``speechclip_par.f32_math``),
written from the paper, the SpeechCLIP repository's configuration and
OpenAI CLIP, independent of the measured package. HuBERT, the weighted
sum, ViT, the loss, ``Precision`` (the float8 control) and Adam are
``speechclip_par``'s. The program's design choices that the reference
follows, as the semantics it is held to: keys past ``K + round(len /
320)`` are masked; the head's attention weights take dropout (keep masks
drawn in the program's order, ``keep_mask``); kw-BN is the reference's
``eachKw`` layout with ``parallel``: one BatchNorm over the (B, D * K)
view, feature ``d * K + k``, its scale and bias tiled from the table's std
and mean; the scores of the special ids (the configuration's
``prob_mask``) are masked before the argmax and the softmax.

Departures: the text tower runs the K + 2 rows of the sentence, not CLIP's
77-token buffer (exact under causal attention: the EOT row at K + 1 sees
rows 0 .. K + 1 only); only the K keyword rows of the head's attention are
computed (the other rows' outputs are not read); HuBERT's GELU is the erf
form, as in ``speechclip_par``. The text tower keeps CLIP's QuickGELU.

``vq`` can be teacher-forced: given the program's ids it takes them for the
hard forward and keeps its own scores' softmax for the gradient, so that
the loss and gradients stay continuous where a near-tie argmax picks
another subword than the reference's own.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from .speechclip_par import Precision, f32, layer_norm, linear

MASK_VALUE = torch.finfo(torch.float32).min


def keep_mask(generator: torch.Generator, b: int, frames: int, k: int, rate: float):
    """The head's keep mask on its attention weights, drawn as the program
    draws it: one (B, 1, K + T, K + T) uniform block a step; -> the K
    keyword rows' part, (B, K, K + T)."""
    u = torch.rand((b, 1, k + frames, k + frames), generator=generator, device=generator.device)
    return (u < 1.0 - rate)[:, 0, :k]


def keyword_head(P: Precision, p: Dict, c: Dict, feat: torch.Tensor, feat_len: torch.Tensor,
                 keep: Optional[torch.Tensor] = None, rate: float = 0.0) -> torch.Tensor:
    """(B, T, D) features -> the K keyword rows after LayerNorm(MHA(x) + x)
    and the projection, (B, K, text width), before kw-BN. ``nhead`` heads
    over ``[cls; feat]``, keys at or past ``feat_len + K`` masked."""
    b, t, d = feat.shape
    k, heads = c["keyword_number"], c["nhead"]
    x = torch.cat([f32(p["cls"]).expand(b, k, d), feat], dim=1)
    attn = p["transformer"]["attn"]
    w_in, b_in = attn["in_proj"]["w"], f32(attn["in_proj"]["b"])
    q = P.mm(x[:, :k], w_in[:, :d]) + b_in[:d]
    key = P.mm(x, w_in[:, d:2 * d]) + b_in[d:2 * d]
    val = P.mm(x, w_in[:, 2 * d:]) + b_in[2 * d:]
    dh = d // heads
    q, key, val = (z.reshape(b, -1, heads, dh).transpose(1, 2) for z in (q, key, val))
    s = P.mm(q, key.transpose(-1, -2)) / math.sqrt(dh)
    pad = torch.arange(k + t, device=feat.device)[None, :] >= (feat_len.long() + k)[:, None]
    s = s.masked_fill(pad[:, None, None, :], float("-inf"))
    w = torch.softmax(s, dim=-1)
    if keep is not None:
        w = w * keep[:, None] / (1.0 - rate)
    o = P.mm(w, val).transpose(1, 2).reshape(b, k, d)
    z = layer_norm(x[:, :k] + linear(P, o, attn["out_proj"]), p["transformer"]["norm"],
                   c["layer_norm_eps"])
    return linear(P, z, p["proj"]["linear"])


def kw_bn(p: Dict, state: Dict, kw: torch.Tensor, momentum: float = 0.1,
          eps: float = 1e-5) -> Tuple[torch.Tensor, Dict]:
    """kw-BN in train mode on (B, K, D): batch statistics (the biased
    variance) over the (B, D * K) view; the running statistics move by
    ``momentum`` toward the batch mean and the unbiased variance."""
    b, k, d = kw.shape
    flat = kw.transpose(1, 2).reshape(b, d * k)
    mean = flat.mean(dim=0)
    var = (flat - mean).square().mean(dim=0)
    y = (flat - mean) / torch.sqrt(var + eps) * f32(p["scale"]) + f32(p["bias"])
    new = {"mean": (1 - momentum) * f32(state["mean"]) + momentum * mean.detach(),
           "var": (1 - momentum) * f32(state["var"]) + momentum * var.detach() * b / (b - 1)}
    return y.reshape(b, d, k).transpose(1, 2), new


def cosine(kw: torch.Tensor, table: torch.Tensor, P: Precision, eps: float = 1e-8):
    """(B, K, D) x (V, D) -> (B, K, V): dot / max(|a| |b|, eps)."""
    dots = P.mm(kw, table.T)
    kn = torch.linalg.vector_norm(kw, dim=-1)[:, :, None]
    tn = torch.linalg.vector_norm(table, dim=-1)[None, None, :]
    return dots / torch.clamp(kn * tn, min=eps)


def vq(scores: torch.Tensor, temp: float, prob_mask: Sequence[int],
       ids: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The hard straight-through choice over masked scores -> (the choice
    (B, K, V): one-hot forward, the gradient of softmax(scores / temp);
    the reference's own argmax ids (B, K)). ``ids``: the one-hot's ids
    (teacher forcing); its own argmax where None."""
    masked = torch.zeros(scores.shape[-1], dtype=torch.bool, device=scores.device)
    masked[list(prob_mask)] = True
    own = scores.detach().masked_fill(masked, MASK_VALUE).argmax(dim=-1)
    soft = torch.softmax((scores / temp).masked_fill(masked, MASK_VALUE), dim=-1)
    hard = torch.nn.functional.one_hot(own if ids is None else ids.long(),
                                       scores.shape[-1]).float()
    return hard + soft - soft.detach(), own


def causal_attention(P: Precision, x: torch.Tensor, p: Dict, heads: int) -> torch.Tensor:
    b, t, d = x.shape
    dh = d // heads
    qkv = linear(P, x, p["in_proj"])
    q, k, v = (z.reshape(b, t, heads, dh).transpose(1, 2) for z in qkv.split(d, dim=-1))
    s = P.mm(q, k.transpose(-1, -2)) / math.sqrt(dh)
    future = torch.ones(t, t, dtype=torch.bool, device=x.device).triu(1)
    w = torch.softmax(s.masked_fill(future, float("-inf")), dim=-1)
    return linear(P, P.mm(w, v).transpose(1, 2).reshape(b, t, d), p["out_proj"])


def text_tower(P: Precision, t: Dict, tc: Dict, keywords: torch.Tensor, sot_id: int,
               eot_id: int) -> torch.Tensor:
    """(B, K, width) keyword embeddings -> (B, output_dim): [SOT; keywords;
    EOT] plus the positional rows through CLIP's causal pre-norm blocks
    (QuickGELU), ``ln_final``, the EOT row's projection."""
    b, k, w = keywords.shape
    table = f32(t["token_embedding"])
    x = torch.cat([table[sot_id].expand(b, 1, w), keywords, table[eot_id].expand(b, 1, w)], 1)
    x = x + f32(t["positional_embedding"])[:k + 2]
    for blk in t["blocks"]:
        x = x + causal_attention(P, layer_norm(x, blk["ln_1"]), blk["attn"], tc["heads"])
        h = linear(P, layer_norm(x, blk["ln_2"]), blk["mlp"]["c_fc"])
        x = x + linear(P, h * torch.sigmoid(1.702 * h), blk["mlp"]["c_proj"])
    return P.mm(layer_norm(x[:, k + 1], t["ln_final"]), t["text_projection"])


def cascaded_branch(P: Precision, p: Dict, state: Dict, c: Dict, text: Dict, tc: Dict,
                    sot_id: int, eot_id: int, feat: torch.Tensor, feat_len: torch.Tensor,
                    keep: Optional[torch.Tensor] = None, ids: Optional[torch.Tensor] = None
                    ) -> Dict:
    """The branch in train mode -> {"feat" (B, output_dim) before the L2
    norm, "scores" (B, K, V), "own" (B, K) the reference's argmax ids,
    "state" the new kw-BN running statistics}."""
    layout = (c["transformer_type"], c["batchnorm_type"], c["bn_parallel"], c["vq_hard"])
    if layout != ("MultiheadAttentionAndNorm", "eachKw", True, True):
        raise NotImplementedError(f"the reference's cascaded branch is SpeechCLIP's: {layout}")
    kw = keyword_head(P, p, c, feat, feat_len, keep, c["dropout"])
    kw, new_state = kw_bn(p["bn"], state, kw)
    table = f32(text["token_embedding"])
    scores = cosine(kw, table, P)
    choice, own = vq(scores, c["vq_temp"], c["prob_mask"], ids)
    feat = text_tower(P, text, tc, P.mm(choice, table), sot_id, eot_id)
    return {"feat": feat, "scores": scores, "own": own, "state": new_state}
