"""The CLIP towers, eval mode (port of speechclip_tpu/models/clip.py):
pre-norm residual blocks with QuickGELU; the text tower (causal attention,
``encode_text`` over token ids, ``encode_keywords``, the cascaded branch's
way into it, and the reduced subword vocabulary); the image towers
(``encode_image``: the vision transformer, or CLIP's ModifiedResNet for the
RN names); and ``get_scores``.

Parameters: the JAX package's ``params["clip"]`` tree (``visual``,
``text``, ``logit_scale``), linear weights (in, out) and conv kernels in
torch's OIHW layout (JAX's HWIO turned by ``convert.from_jax``). Images
are NHWC, as in the JAX package; the convs run on an NCHW view.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import CLIPResNetVisionConfig, CLIPTextConfig, VisionConfig
from ..ops.attention import multi_head_attention
from ..ops.basic import (
    Params,
    conv_f32,
    layer_norm,
    layer_norm_init,
    linear,
    matmul_f32,
    normal,
    quick_gelu,
)
from ..parallel import tensor as tp
from ..utils import tracing


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


def vision_init(generator: torch.Generator, cfg: VisionConfig) -> Params:
    """Random image-tower params with the JAX package's distributions."""
    if isinstance(cfg, CLIPResNetVisionConfig):
        return _resnet_init(generator, cfg)
    w, grid = cfg.width, cfg.image_size // cfg.patch_size
    return {
        "conv1": {"w": normal((w, 3, cfg.patch_size, cfg.patch_size), w**-0.5, generator)},
        "class_embedding": normal((w,), w**-0.5, generator),
        "positional_embedding": normal((grid * grid + 1, w), w**-0.5, generator),
        "ln_pre": layer_norm_init(w, generator.device),
        "blocks": [_block_init(generator, w, w * 4) for _ in range(cfg.layers)],
        "ln_post": layer_norm_init(w, generator.device),
        "proj": normal((w, cfg.output_dim), w**-0.5, generator),
    }


def _resnet_init(generator: torch.Generator, v: CLIPResNetVisionConfig) -> Params:
    dev = generator.device

    def conv(k, cin, cout):
        return {"w": normal((cout, cin, k, k), (k * k * cin) ** -0.5, generator)}

    def bn(dim):
        return {"scale": torch.ones(dim, device=dev), "bias": torch.zeros(dim, device=dev),
                "mean": torch.zeros(dim, device=dev), "var": torch.ones(dim, device=dev)}

    def lin(i, o):
        return {"w": normal((i, o), i**-0.5, generator), "b": torch.zeros(o, device=dev)}

    w2 = v.width // 2
    visual: Params = {"stem": {
        "conv1": conv(3, 3, w2), "bn1": bn(w2),
        "conv2": conv(3, w2, w2), "bn2": bn(w2),
        "conv3": conv(3, w2, v.width), "bn3": bn(v.width),
    }}
    inplanes = v.width
    for stage in range(4):
        planes = v.width * 2**stage
        blocks = []
        for block in range(v.layers[stage]):
            p = {"conv1": conv(1, inplanes, planes), "bn1": bn(planes),
                 "conv2": conv(3, planes, planes), "bn2": bn(planes),
                 "conv3": conv(1, planes, planes * 4), "bn3": bn(planes * 4)}
            if block == 0:  # the first block of a stage re-projects the identity
                p["downsample"] = {"conv": conv(1, inplanes, planes * 4), "bn": bn(planes * 4)}
            blocks.append(p)
            inplanes = planes * 4
        visual[f"layer{stage + 1}"] = blocks
    ed = v.embed_dim
    visual["attnpool"] = {
        "positional_embedding": normal((v.feature_grid**2 + 1, ed), ed**-0.5, generator),
        "q_proj": lin(ed, ed), "k_proj": lin(ed, ed), "v_proj": lin(ed, ed),
        "c_proj": lin(ed, v.output_dim),
    }
    return visual


def _resblock(params: Params, x: torch.Tensor, heads: int, causal: bool,
              plain: bool = False) -> torch.Tensor:
    """x + MHA(LN(x)), then + MLP(LN(x)) with QuickGELU; under a live
    model axis ``c_fc`` column-parallel, ``c_proj`` row-parallel and the
    attention on the rank's heads."""
    normed = layer_norm(params["ln_1"], x)
    h, _ = multi_head_attention(params["attn"], normed, normed, normed, num_heads=heads,
                                causal=causal, plain=plain)
    x = x + h
    y = layer_norm(params["ln_2"], x)
    mid = quick_gelu(tp.linear_col(params["mlp"]["c_fc"], y, "c_fc input"))
    return x + tp.linear_row(params["mlp"]["c_proj"], mid, "c_proj output")


def _conv2d(w: torch.Tensor, x: torch.Tensor, stride: int = 1, padding: int = 0):
    """Bias-free conv on NCHW with f32 sums (``ops.basic.conv_f32``)."""
    return conv_f32(F.conv2d, x, w, "models/clip.py _conv2d", stride=stride, padding=padding)


def _batch_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm2d with running statistics over NCHW channels, folded in f32
    to a scale and a bias, cast to ``x.dtype``, then one multiply-add."""
    scale = p["scale"].float() * torch.rsqrt(p["var"].float() + eps)
    bias = p["bias"].float() - p["mean"].float() * scale
    return x * scale.to(x.dtype)[:, None, None] + bias.to(x.dtype)[:, None, None]


def _avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """AvgPool2d(k) (no padding, floor mode), summed in f32."""
    if k == 1:
        return x
    return F.avg_pool2d(x.float(), k).to(x.dtype)


def _bottleneck(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    """CLIP's anti-aliased Bottleneck: 1x1 -> 3x3 -> [avgpool(stride)] ->
    1x1 (x4); the identity through avgpool + 1x1 where re-projected."""
    out = torch.relu(_batch_norm(p["bn1"], _conv2d(p["conv1"]["w"], x)))
    out = torch.relu(_batch_norm(p["bn2"], _conv2d(p["conv2"]["w"], out, padding=1)))
    out = _batch_norm(p["bn3"], _conv2d(p["conv3"]["w"], _avg_pool(out, stride)))
    identity = x
    if "downsample" in p:
        ds = p["downsample"]
        identity = _batch_norm(ds["bn"], _conv2d(ds["conv"]["w"], _avg_pool(x, stride)))
    return torch.relu(out + identity)


def _attention_pool(p: Params, v: CLIPResNetVisionConfig, x: torch.Tensor) -> torch.Tensor:
    """AttentionPool2d: the spatial mean as the one query, a learned
    positional embedding, one round of multi-head attention (f32 logits and
    softmax, weights rounded to the activation dtype), then ``c_proj``
    (row-parallel under a live model axis, as JAX shards its input rows:
    each rank multiplies its slice of the pooled row)."""
    b, c = x.shape[:2]
    x = x.flatten(2).transpose(1, 2)  # (B, H*W, C), JAX's row order
    x = torch.cat([x.float().mean(dim=1, keepdim=True).to(x.dtype), x], dim=1)
    x = x + p["positional_embedding"].to(x.dtype)
    hd = c // v.heads
    split = lambda z: z.reshape(b, -1, v.heads, hd).transpose(1, 2)
    q = split(linear(p["q_proj"], x[:, :1]))
    k, val = split(linear(p["k_proj"], x)), split(linear(p["v_proj"], x))
    scale = torch.full((), hd**-0.5, dtype=x.dtype, device=x.device)
    weights = torch.softmax(matmul_f32(q * scale, k.transpose(-1, -2)), dim=-1).to(x.dtype)
    pooled = matmul_f32(weights, val).to(x.dtype).transpose(1, 2).reshape(b, 1, c)
    return tp.linear_row(p["c_proj"], pooled, "attention pool", scatter=True)[:, 0]


def _encode_image_resnet(params: Params, v: CLIPResNetVisionConfig,
                         x: torch.Tensor) -> torch.Tensor:
    p = params["visual"]
    stem = p["stem"]
    x = torch.relu(_batch_norm(stem["bn1"], _conv2d(stem["conv1"]["w"], x, 2, 1)))
    x = torch.relu(_batch_norm(stem["bn2"], _conv2d(stem["conv2"]["w"], x, 1, 1)))
    x = torch.relu(_batch_norm(stem["bn3"], _conv2d(stem["conv3"]["w"], x, 1, 1)))
    x = _avg_pool(x, 2)
    for stage in range(4):
        for block, bp in enumerate(p[f"layer{stage + 1}"]):
            x = _bottleneck(bp, x, stride=2 if stage > 0 and block == 0 else 1)
    return _attention_pool(p["attnpool"], v, x)


def encode_image(params: Params, cfg: VisionConfig, images: torch.Tensor,
                 plain: bool = False) -> torch.Tensor:
    """(B, H, W, 3) normalized NHWC images -> (B, output_dim) in their
    dtype: the vision transformer (patch conv, class and positional
    embeddings, ``ln_pre``, non-causal resblocks, ``ln_post`` on the class
    row, ``proj``), or the ModifiedResNet for the RN towers (no kernel)."""
    x = images.permute(0, 3, 1, 2)
    if isinstance(cfg, CLIPResNetVisionConfig):
        return _encode_image_resnet(params, cfg, x)
    v = params["visual"]
    x = _conv2d(v["conv1"]["w"], x, stride=cfg.patch_size).flatten(2).transpose(1, 2)
    b, _, w = x.shape
    cls = v["class_embedding"].to(x.dtype).expand(b, 1, w)
    x = torch.cat([cls, x], dim=1) + v["positional_embedding"].to(x.dtype)
    x = layer_norm(v["ln_pre"], x)
    for block in v["blocks"]:
        x = _resblock(block, x, cfg.heads, False, plain)
    x = layer_norm(v["ln_post"], x[:, 0])
    return x @ v["proj"].to(x.dtype)


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
    tracing.count("speechclip.cascaded.text_rows", b * (k + 2))
    table = params["text"]["token_embedding"]
    sot = table[sot_id].to(keywords.dtype).expand(b, 1, w)
    eot = table[eot_id].to(keywords.dtype).expand(b, 1, w)
    x = torch.cat([sot, keywords, eot], dim=1)
    x = x + params["text"]["positional_embedding"][: k + 2].to(x.dtype)
    x = _text_transformer(params, cfg, x, plain)
    x = layer_norm(params["text"]["ln_final"], x)
    pooled = x[:, k + 1]
    return pooled @ params["text"]["text_projection"].to(pooled.dtype)


def get_scores(params: Params, vision_cfg: VisionConfig, text_cfg: CLIPTextConfig,
               images: torch.Tensor, text: torch.Tensor,
               eot_positions: Optional[torch.Tensor] = None,
               plain: bool = False):
    """-> (logits per image, logits per text): cosine scores scaled by
    ``exp(logit_scale)``, in f32 (the f32 scale promotes the features, as in
    the JAX package)."""
    img = encode_image(params, vision_cfg, images, plain)
    txt = encode_text(params, text_cfg, text, eot_positions, plain)
    img = img / torch.linalg.vector_norm(img, dim=-1, keepdim=True)
    txt = txt / torch.linalg.vector_norm(txt, dim=-1, keepdim=True)
    logits_per_image = (params["logit_scale"].float().exp() * img.float()) @ txt.float().T
    return logits_per_image, logits_per_image.T


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
