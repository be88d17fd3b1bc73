"""Seeded weights for a SpeechCLIP parallel model, made on the device in two
random draws (one bf16 buffer for the frozen towers' matrices, one f32
buffer for everything else), then viewed and scaled leaf by leaf.

The tree has the program's parameter keys (``SpeechCLIPModel.init``):
``audio_encoder`` (HuBERT), ``weighted_sum``, ``parallel_branch``,
``criterion`` where the temperature trains, and ``clip`` with the image
tower ``visual`` and ``logit_scale`` (the parallel model reads no text
tower, so none is made). Frozen matrices are bf16, the dtype the program
runs them in; vectors and the trainable leaves are f32, as the program
keeps them. Linear weights are (in, out); conv weights (out, in / groups,
k). Biases and LayerNorm parameters are drawn near their usual values
rather than left at 0 and 1, so that a dropped bias or a skipped norm shows.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

ALIGN = 128  # elements
# (path, shape, dtype group, std, mean); group "m16": frozen matrix in bf16
Leaf = Tuple[Tuple, Tuple[int, ...], str, float, float]


def _lin(path, i, o, group, std=None, bias_std=0.02) -> List[Leaf]:
    std = i ** -0.5 if std is None else std
    return [(path + ("w",), (i, o), group, std, 0.0), (path + ("b",), (o,), "f32", bias_std, 0.0)]


def _ln(path, d) -> List[Leaf]:
    return [(path + ("scale",), (d,), "f32", 0.02, 1.0), (path + ("bias",), (d,), "f32", 0.02, 0.0)]


def hubert_leaves(a: Dict) -> List[Leaf]:
    """``a``: the config's ``sizes.audio`` block."""
    out: List[Leaf] = []
    root = ("audio_encoder",)
    in_ch = 1
    for i, (ch, k, _s) in enumerate(a["conv_layers"]):
        p = root + ("feature_extractor", i)
        out.append((p + ("w",), (ch, in_ch, k), "m16", (k * in_ch) ** -0.5, 0.0))
        if a["conv_bias"]:
            out.append((p + ("b",), (ch,), "f32", 0.02, 0.0))
        if a["extractor_mode"] == "layer_norm" or i == 0:
            out += _ln(p + ("norm",), ch)
        in_ch = ch
    d, f, c = a["encoder_embed_dim"], a["encoder_ffn_dim"], a["conv_layers"][-1][0]
    out += _ln(root + ("layer_norm",), c)
    out += _lin(root + ("post_extract_proj",), c, d, "m16")
    enc = root + ("encoder",)
    g, k = a["pos_conv_groups"], a["pos_conv_kernel"]
    out.append((enc + ("pos_conv", "w"), (d, d // g, k), "m16", 0.02, 0.0))
    out.append((enc + ("pos_conv", "b"), (d,), "f32", 0.02, 0.0))
    out += _ln(enc + ("layer_norm",), d)
    for i in range(a["encoder_layers"]):
        p = enc + ("layers", i)
        out += _lin(p + ("self_attn", "in_proj"), d, 3 * d, "m16")
        out += _lin(p + ("self_attn", "out_proj"), d, d, "m16")
        out += _ln(p + ("self_attn_layer_norm",), d)
        out += _lin(p + ("fc1",), d, f, "m16")
        out += _lin(p + ("fc2",), f, d, "m16")
        out += _ln(p + ("final_layer_norm",), d)
    return out


def branch_leaves(b: Dict, audio_dim: int, out_dim: int) -> List[Leaf]:
    """The parallel branch: CLS row, TransformerEncoder, final norm, the
    projection to the image embedding; every leaf trains (f32)."""
    d, f = b["d_model"], b["dim_feedforward"]
    root = ("parallel_branch",)
    out: List[Leaf] = [(root + ("cls",), (1, 1, d), "f32", 1.0, 0.0)]
    xavier = math.sqrt(6.0 / (4 * d)) / math.sqrt(3.0)
    for i in range(b["n_layers"]):
        p = root + ("transformer", "layers", i)
        out += _lin(p + ("self_attn", "in_proj"), d, 3 * d, "f32", std=xavier)
        out += _lin(p + ("self_attn", "out_proj"), d, d, "f32", std=(3 * d) ** -0.5)
        out += _lin(p + ("linear1",), d, f, "f32", std=(3 * d) ** -0.5)
        out += _lin(p + ("linear2",), f, d, "f32", std=(3 * f) ** -0.5)
        out += _ln(p + ("norm1",), d)
        out += _ln(p + ("norm2",), d)
    out += _ln(root + ("transformer", "norm"), d)
    out += _lin(root + ("proj",), audio_dim, out_dim, "f32", std=(3 * audio_dim) ** -0.5)
    return out


def vit_leaves(v: Dict) -> List[Leaf]:
    w, p, grid = v["width"], v["patch_size"], v["image_size"] // v["patch_size"]
    root = ("clip", "visual")
    out: List[Leaf] = [
        (root + ("conv1", "w"), (w, 3, p, p), "m16", (3 * p * p) ** -0.5, 0.0),
        (root + ("class_embedding",), (w,), "f32", w ** -0.5, 0.0),
        (root + ("positional_embedding",), (grid * grid + 1, w), "m16", w ** -0.5, 0.0),
    ]
    out += _ln(root + ("ln_pre",), w)
    for i in range(v["layers"]):
        b = root + ("blocks", i)
        out += _lin(b + ("attn", "in_proj"), w, 3 * w, "m16")
        out += _lin(b + ("attn", "out_proj"), w, w, "m16")
        out += _ln(b + ("ln_1",), w)
        out += _lin(b + ("mlp", "c_fc"), w, 4 * w, "m16")
        out += _lin(b + ("mlp", "c_proj"), 4 * w, w, "m16")
        out += _ln(b + ("ln_2",), w)
    out += _ln(root + ("ln_post",), w)
    out.append((root + ("proj",), (w, v["output_dim"]), "m16", w ** -0.5, 0.0))
    return out


def model_leaves(sizes: Dict) -> List[Leaf]:
    a, b, v = sizes["audio"], sizes["parallel_branch"], sizes["vision"]
    out = hubert_leaves(a)
    out.append((("weighted_sum", "weights"), (a["encoder_layers"] + 1,), "f32", 0.5, 0.0))
    out += branch_leaves(b, a["encoder_embed_dim"], v["output_dim"])
    if sizes.get("temperature_trainable"):
        out.append((("criterion", "log_inv_temp"), (), "f32", 0.0, math.log(1 / 0.07)))
    out += vit_leaves(v)
    out.append((("clip", "logit_scale"), (), "f32", 0.0, math.log(1 / 0.07)))
    return out


def _insert(tree, path, value):
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append({} if not isinstance(nxt, int) else [])
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    last = path[-1]
    if isinstance(last, int):
        while len(node) <= last:
            node.append(None)
    node[last] = value


def _padded(n: int) -> int:
    """Each leaf starts on a multiple of ``ALIGN`` elements of its buffer
    (256 bytes or more), as a tensor of its own would; the program's
    kernels ask for 16."""
    return -(-n // ALIGN) * ALIGN


def make_params(sizes: Dict, seed: int, device) -> Dict:
    """The parameter tree for ``sizes`` (a configuration file's ``sizes``),
    drawn from ``seed`` on ``device``. Conv layers without a bias get a
    ``b`` of None, as the program's init gives them."""
    leaves = model_leaves(sizes)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    numel = {g: sum(_padded(math.prod(s)) for _, s, gg, _, _ in leaves if gg == g)
             for g in ("m16", "f32")}
    bufs = {"m16": torch.randn(numel["m16"], generator=gen, device=device, dtype=torch.bfloat16),
            "f32": torch.randn(numel["f32"], generator=gen, device=device, dtype=torch.float32)}
    offset = {"m16": 0, "f32": 0}
    tree: Dict = {}
    with torch.no_grad():
        for path, shape, group, std, mean in leaves:
            n = math.prod(shape)
            t = bufs[group][offset[group]:offset[group] + n].view(shape)
            offset[group] += _padded(n)
            t.mul_(std)
            if mean:
                t.add_(mean)
            _insert(tree, path, t)
    if not sizes["audio"]["conv_bias"]:
        for conv in tree["audio_encoder"]["feature_extractor"]:
            conv["b"] = None
    return tree

