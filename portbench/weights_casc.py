"""Seeded weights for a SpeechCLIP cascaded model, made on the device as
``weights.py`` makes the parallel model's (two random draws, viewed and
scaled leaf by leaf), in the program's tree (``SpeechCLIPModel.init``):
``audio_encoder`` (HuBERT), ``weighted_sum``, ``criterion`` where the
temperature trains, ``cascaded_branch`` and ``clip`` with the text tower
``text``, the image tower ``visual`` and ``logit_scale``.

The text tower's token table is drawn at the full vocabulary (CLIP's 49408
rows) and cut to the rows of the configuration's reduced vocabulary (the
``.npy`` table of (original id, count) rows), as the program cuts it; the
positional table has CLIP's 77 rows. The cascaded branch: the K keyword
CLS rows, the MHA-and-norm body (``transformer``: ``attn``, ``norm``), the
keyword projection (``proj.linear``, with ``proj.mlp`` None), ``vq`` (empty:
the temperature is fixed) and kw-BN's scale and bias, which start, as the
program's ``kw_bn_init`` starts them, from the cut table's std (unbiased,
times ``bn_std_scale``) and mean, tiled K times (the ``eachKw`` + ``parallel`` layout). Its running
statistics are the model state (``model_state``): mean 0, variance 1.
Frozen matrices (the text tower's included, which the program keeps in
f32 and runs in the activation dtype) are drawn in bf16; vectors and the
trainable leaves in f32.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List

import numpy as np
import torch

from .harness import ROOT
from .weights import Leaf, _insert, _lin, _ln, _padded, hubert_leaves, vit_leaves


def reduced_ids(t: Dict):
    """The original ids of the reduced table's rows, or None without one
    (``t``: the config's ``sizes.text`` block)."""
    path = t.get("reduced_vocab")
    if not path:
        return None
    path = path if os.path.isabs(path) else os.path.join(ROOT, path)
    return np.load(path)[:, 0].astype(np.int64)


def text_leaves(t: Dict) -> List[Leaf]:
    """The CLIP text tower, the token table at the full vocabulary."""
    w, root = t["width"], ("clip", "text")
    out: List[Leaf] = [(root + ("token_embedding",), (t["vocab_size"], w), "m16", 0.02, 0.0),
                       (root + ("positional_embedding",), (t["context_length"], w), "m16", 0.01,
                        0.0)]
    for i in range(t["layers"]):
        b = root + ("blocks", i)
        out += _lin(b + ("attn", "in_proj"), w, 3 * w, "m16")
        out += _lin(b + ("attn", "out_proj"), w, w, "m16")
        out += _ln(b + ("ln_1",), w)
        out += _lin(b + ("mlp", "c_fc"), w, 4 * w, "m16")
        out += _lin(b + ("mlp", "c_proj"), 4 * w, w, "m16")
        out += _ln(b + ("ln_2",), w)
    out += _ln(root + ("ln_final",), w)
    out.append((root + ("text_projection",), (w, t["output_dim"]), "m16", w ** -0.5, 0.0))
    return out


def cascaded_leaves(c: Dict, text_dim: int) -> List[Leaf]:
    """The cascaded branch's drawn leaves (every one trains, f32); kw-BN's
    scale and bias are set from the table afterwards."""
    d, k = c["d_model"], c["keyword_number"]
    root = ("cascaded_branch",)
    xavier = math.sqrt(6.0 / (4 * d)) / math.sqrt(3.0)
    out: List[Leaf] = [(root + ("cls",), (1, k, d), "f32", 1.0, 0.0)]
    out += _lin(root + ("transformer", "attn", "in_proj"), d, 3 * d, "f32", std=xavier)
    out += _lin(root + ("transformer", "attn", "out_proj"), d, d, "f32", std=(3 * d) ** -0.5)
    out += _ln(root + ("transformer", "norm"), d)
    out += _lin(root + ("proj", "linear"), d, text_dim, "f32", std=(3 * d) ** -0.5)
    return out


def model_leaves(sizes: Dict) -> List[Leaf]:
    a, c, t, v = sizes["audio"], sizes["cascaded_branch"], sizes["text"], sizes["vision"]
    out = hubert_leaves(a)
    out.append((("weighted_sum", "weights"), (a["encoder_layers"] + 1,), "f32", 0.5, 0.0))
    if sizes.get("temperature_trainable"):
        out.append((("criterion", "log_inv_temp"), (), "f32", 0.0, math.log(1 / 0.07)))
    out += cascaded_leaves(c, t["width"])
    out += text_leaves(t)
    out += vit_leaves(v)
    out.append((("clip", "logit_scale"), (), "f32", 0.0, math.log(1 / 0.07)))
    return out


def make_params(sizes: Dict, seed: int, device) -> Dict:
    """The parameter tree for ``sizes`` (a configuration file's ``sizes``),
    drawn from ``seed`` on ``device``."""
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
        text = tree["clip"]["text"]
        ids = reduced_ids(sizes["text"])
        if ids is not None:
            text["token_embedding"] = text["token_embedding"][
                torch.from_numpy(ids).to(text["token_embedding"].device)]
        table = text["token_embedding"].float()
        k = sizes["cascaded_branch"]["keyword_number"]
        branch = tree["cascaded_branch"]
        branch["proj"]["mlp"] = None
        branch["vq"] = {}
        scale = table.std(dim=0) * sizes["cascaded_branch"]["bn_std_scale"]
        branch["bn"] = {"scale": scale.repeat(k), "bias": table.mean(dim=0).repeat(k)}
    return tree


def model_state(sizes: Dict, device) -> Dict:
    """kw-BN's running statistics as the program's init makes them."""
    n = sizes["text"]["width"] * sizes["cascaded_branch"]["keyword_number"]
    return {"cascaded_branch": {"bn": {"mean": torch.zeros(n, device=device),
                                       "var": torch.ones(n, device=device)}}}
