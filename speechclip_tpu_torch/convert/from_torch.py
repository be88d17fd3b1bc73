"""Torch checkpoints of the frozen towers -> the port's params (port of
speechclip_tpu/convert/from_torch.py).

- HuBERT from a fairseq checkpoint (``hubert_base_ls960.pt``: the
  ``{"model": state_dict, "cfg": ...}`` files) or a HuggingFace
  ``HubertModel`` state dict (other names, same architecture);
- CLIP from an OpenAI ``clip.load`` checkpoint (TorchScript or a plain
  state dict; ViT or ModifiedResNet image tower) or a HuggingFace
  ``CLIPModel`` state dict.

The port keeps the JAX package's pytree keys with torch's layouts: linear
weights become ``(in, out)`` for ``y = x @ w + b`` (the torch weight
transposed); convolution kernels stay ``(out, in / groups, k)`` and
``(out, in, kh, kw)``. The weight norm of HuBERT's ``pos_conv`` (fairseq's
``weight_g``/``weight_v``, or torch's parametrization) is folded into a
plain kernel: ``w[o, i, k] = g[k] v[o, i, k] / ||v[:, :, k]||``, the norm
over (out, in) for each tap, in float64. Every leaf is f32 on the CPU; cast
with ``models.speechclip.cast_params``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..config import CLIPConfig
from ..models.hubert import HubertConfig


def _t(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        x = x.detach().float().numpy()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _lin(sd: Mapping, prefix: str) -> Dict:
    b = sd.get(f"{prefix}.bias")
    return {"w": _t(sd[f"{prefix}.weight"]).T.contiguous(), "b": None if b is None else _t(b)}


def _ln(sd: Mapping, prefix: str) -> Dict:
    return {"scale": _t(sd[f"{prefix}.weight"]), "bias": _t(sd[f"{prefix}.bias"])}


def _mha_from_qkv(sd: Mapping, prefix: str) -> Dict:
    """Separate q/k/v projections (fairseq, HF) -> one in_proj (in, 3 D)."""
    ws = [_t(sd[f"{prefix}.{n}.weight"]).T for n in ("q_proj", "k_proj", "v_proj")]
    bs = [_t(sd[f"{prefix}.{n}.bias"]) for n in ("q_proj", "k_proj", "v_proj")]
    return {"in_proj": {"w": torch.cat(ws, dim=1).contiguous(), "b": torch.cat(bs)},
            "out_proj": _lin(sd, f"{prefix}.out_proj")}


def _mha_from_in_proj(sd: Mapping, prefix: str) -> Dict:
    """torch nn.MultiheadAttention's in_proj_weight (OpenAI CLIP)."""
    return {"in_proj": {"w": _t(sd[f"{prefix}.in_proj_weight"]).T.contiguous(),
                        "b": _t(sd[f"{prefix}.in_proj_bias"])},
            "out_proj": _lin(sd, f"{prefix}.out_proj")}


def fold_weight_norm(v: np.ndarray, g: np.ndarray) -> np.ndarray:
    """weight_norm(dim=2): w[o, i, k] = g[k] * v[o, i, k] / ||v[:, :, k]||."""
    norm = np.sqrt(np.sum(v.astype(np.float64) ** 2, axis=(0, 1), keepdims=True))
    return (g.reshape(1, 1, -1) * v / np.maximum(norm, 1e-12)).astype(np.float32)


def _np(x) -> np.ndarray:
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _pos_conv(sd: Mapping, prefix: str) -> Dict:
    """fairseq ``weight_g``/``weight_v``, torch >= 2.1 parametrizations, or
    a plain ``weight``: a (out, in / groups, k) kernel."""
    if f"{prefix}.weight_v" in sd:
        w = fold_weight_norm(_np(sd[f"{prefix}.weight_v"]),
                             _np(sd[f"{prefix}.weight_g"]).reshape(-1))
    elif f"{prefix}.parametrizations.weight.original1" in sd:
        w = fold_weight_norm(_np(sd[f"{prefix}.parametrizations.weight.original1"]),
                             _np(sd[f"{prefix}.parametrizations.weight.original0"]).reshape(-1))
    else:
        w = _np(sd[f"{prefix}.weight"])
    return {"w": _t(w), "b": _t(sd[f"{prefix}.bias"])}


def _conv(sd: Mapping, key: str) -> torch.Tensor:
    return _t(sd[key])


def hubert_from_fairseq(sd: Mapping, cfg: HubertConfig) -> Dict:
    """A fairseq HubertModel state dict."""
    convs = []
    for i in range(len(cfg.conv_layers)):
        b = sd.get(f"feature_extractor.conv_layers.{i}.0.bias")
        layer: Dict = {"w": _conv(sd, f"feature_extractor.conv_layers.{i}.0.weight"),
                       "b": None if b is None else _t(b)}
        if cfg.extractor_mode == "default" and i == 0:
            layer["norm"] = _ln(sd, f"feature_extractor.conv_layers.{i}.2")
        elif cfg.extractor_mode == "layer_norm":
            layer["norm"] = _ln(sd, f"feature_extractor.conv_layers.{i}.2.1")
        convs.append(layer)
    layers = [{
        "self_attn": _mha_from_qkv(sd, f"encoder.layers.{i}.self_attn"),
        "self_attn_layer_norm": _ln(sd, f"encoder.layers.{i}.self_attn_layer_norm"),
        "fc1": _lin(sd, f"encoder.layers.{i}.fc1"),
        "fc2": _lin(sd, f"encoder.layers.{i}.fc2"),
        "final_layer_norm": _ln(sd, f"encoder.layers.{i}.final_layer_norm"),
    } for i in range(cfg.encoder_layers)]
    return {
        "feature_extractor": convs,
        "layer_norm": _ln(sd, "layer_norm"),
        "post_extract_proj": (_lin(sd, "post_extract_proj")
                              if "post_extract_proj.weight" in sd else None),
        "encoder": {"pos_conv": _pos_conv(sd, "encoder.pos_conv.0"),
                    "layer_norm": _ln(sd, "encoder.layer_norm"), "layers": layers},
    }


def hubert_from_hf(sd: Mapping, cfg: HubertConfig) -> Dict:
    """A HuggingFace transformers HubertModel state dict."""
    convs = []
    for i in range(len(cfg.conv_layers)):
        p = f"feature_extractor.conv_layers.{i}"
        b = sd.get(f"{p}.conv.bias")
        layer: Dict = {"w": _conv(sd, f"{p}.conv.weight"), "b": None if b is None else _t(b)}
        if f"{p}.layer_norm.weight" in sd:
            layer["norm"] = _ln(sd, f"{p}.layer_norm")
        convs.append(layer)
    layers = [{
        "self_attn": _mha_from_qkv(sd, f"encoder.layers.{i}.attention"),
        "self_attn_layer_norm": _ln(sd, f"encoder.layers.{i}.layer_norm"),
        "fc1": _lin(sd, f"encoder.layers.{i}.feed_forward.intermediate_dense"),
        "fc2": _lin(sd, f"encoder.layers.{i}.feed_forward.output_dense"),
        "final_layer_norm": _ln(sd, f"encoder.layers.{i}.final_layer_norm"),
    } for i in range(cfg.encoder_layers)]
    return {
        "feature_extractor": convs,
        "layer_norm": _ln(sd, "feature_projection.layer_norm"),
        "post_extract_proj": (_lin(sd, "feature_projection.projection")
                              if "feature_projection.projection.weight" in sd else None),
        "encoder": {"pos_conv": _pos_conv(sd, "encoder.pos_conv_embed.conv"),
                    "layer_norm": _ln(sd, "encoder.layer_norm"), "layers": layers},
    }


def _openai_block(sd: Mapping, prefix: str) -> Dict:
    return {"attn": _mha_from_in_proj(sd, f"{prefix}.attn"), "ln_1": _ln(sd, f"{prefix}.ln_1"),
            "mlp": {"c_fc": _lin(sd, f"{prefix}.mlp.c_fc"),
                    "c_proj": _lin(sd, f"{prefix}.mlp.c_proj")},
            "ln_2": _ln(sd, f"{prefix}.ln_2")}


def _bn2d(sd: Mapping, prefix: str) -> Dict:
    return {"scale": _t(sd[f"{prefix}.weight"]), "bias": _t(sd[f"{prefix}.bias"]),
            "mean": _t(sd[f"{prefix}.running_mean"]), "var": _t(sd[f"{prefix}.running_var"])}


def _resnet_visual_from_openai(sd: Mapping, cfg: CLIPConfig) -> Dict:
    """The ModifiedResNet image tower (RN* names)."""
    visual: Dict = {"stem": {}}
    for j in (1, 2, 3):
        visual["stem"][f"conv{j}"] = {"w": _conv(sd, f"visual.conv{j}.weight")}
        visual["stem"][f"bn{j}"] = _bn2d(sd, f"visual.bn{j}")
    for stage in range(4):
        blocks = []
        for i in range(cfg.vision.layers[stage]):
            prefix = f"visual.layer{stage + 1}.{i}"
            p: Dict = {}
            for j in (1, 2, 3):
                p[f"conv{j}"] = {"w": _conv(sd, f"{prefix}.conv{j}.weight")}
                p[f"bn{j}"] = _bn2d(sd, f"{prefix}.bn{j}")
            if f"{prefix}.downsample.0.weight" in sd:
                p["downsample"] = {"conv": {"w": _conv(sd, f"{prefix}.downsample.0.weight")},
                                   "bn": _bn2d(sd, f"{prefix}.downsample.1")}
            blocks.append(p)
        visual[f"layer{stage + 1}"] = blocks
    visual["attnpool"] = {"positional_embedding": _t(sd["visual.attnpool.positional_embedding"]),
                          **{k: _lin(sd, f"visual.attnpool.{k}")
                             for k in ("q_proj", "k_proj", "v_proj", "c_proj")}}
    return visual


def _openai_text(sd: Mapping, cfg: CLIPConfig) -> Dict:
    return {
        "token_embedding": _t(sd["token_embedding.weight"]),
        "positional_embedding": _t(sd["positional_embedding"]),
        "blocks": [_openai_block(sd, f"transformer.resblocks.{i}")
                   for i in range(cfg.text.layers)],
        "ln_final": _ln(sd, "ln_final"),
        "text_projection": _t(sd["text_projection"]),
    }


def clip_from_openai(sd: Mapping, cfg: CLIPConfig) -> Dict:
    """An OpenAI CLIP state dict (ViT or ModifiedResNet image tower)."""
    if "visual.attnpool.positional_embedding" in sd:
        visual = _resnet_visual_from_openai(sd, cfg)
    else:
        visual = {
            "conv1": {"w": _conv(sd, "visual.conv1.weight")},
            "class_embedding": _t(sd["visual.class_embedding"]),
            "positional_embedding": _t(sd["visual.positional_embedding"]),
            "ln_pre": _ln(sd, "visual.ln_pre"),
            "blocks": [_openai_block(sd, f"visual.transformer.resblocks.{i}")
                       for i in range(cfg.vision.layers)],
            "ln_post": _ln(sd, "visual.ln_post"),
            "proj": _t(sd["visual.proj"]),  # already (width, out)
        }
    return {"visual": visual, "text": _openai_text(sd, cfg),
            "logit_scale": _t(sd["logit_scale"])}


def _hf_clip_block(sd: Mapping, prefix: str) -> Dict:
    return {"attn": _mha_from_qkv(sd, f"{prefix}.self_attn"),
            "ln_1": _ln(sd, f"{prefix}.layer_norm1"),
            "mlp": {"c_fc": _lin(sd, f"{prefix}.mlp.fc1"), "c_proj": _lin(sd, f"{prefix}.mlp.fc2")},
            "ln_2": _ln(sd, f"{prefix}.layer_norm2")}


def clip_from_hf(sd: Mapping, cfg: CLIPConfig) -> Dict:
    """A HuggingFace transformers CLIPModel state dict (ViT towers)."""
    pre_ln = ("vision_model.pre_layrnorm" if "vision_model.pre_layrnorm.weight" in sd
              else "vision_model.pre_layernorm")
    visual = {
        "conv1": {"w": _conv(sd, "vision_model.embeddings.patch_embedding.weight")},
        "class_embedding": _t(sd["vision_model.embeddings.class_embedding"]).reshape(-1),
        "positional_embedding": _t(sd["vision_model.embeddings.position_embedding.weight"]),
        "ln_pre": _ln(sd, pre_ln),
        "blocks": [_hf_clip_block(sd, f"vision_model.encoder.layers.{i}")
                   for i in range(cfg.vision.layers)],
        "ln_post": _ln(sd, "vision_model.post_layernorm"),
        "proj": _t(sd["visual_projection.weight"]).T.contiguous(),
    }
    text = {
        "token_embedding": _t(sd["text_model.embeddings.token_embedding.weight"]),
        "positional_embedding": _t(sd["text_model.embeddings.position_embedding.weight"]),
        "blocks": [_hf_clip_block(sd, f"text_model.encoder.layers.{i}")
                   for i in range(cfg.text.layers)],
        "ln_final": _ln(sd, "text_model.final_layer_norm"),
        "text_projection": _t(sd["text_projection.weight"]).T.contiguous(),
    }
    return {"visual": visual, "text": text, "logit_scale": _t(sd["logit_scale"])}


def load_hubert_checkpoint(path: str, cfg: HubertConfig) -> Dict:
    """A HuBERT checkpoint file: fairseq (``{"model": sd, ...}``) or a HF
    state dict (``hubert.``-prefixed full-model dumps too), told apart by
    key names. The file is a pickle: load only files you trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt.get("state_dict", ckpt))
    if any(k.startswith("feature_extractor.conv_layers.0.0.") for k in sd):
        return hubert_from_fairseq(sd, cfg)
    if any(k.startswith("feature_extractor.conv_layers.0.conv.") for k in sd):
        return hubert_from_hf(sd, cfg)
    stripped = {k[len("hubert."):]: v for k, v in sd.items() if k.startswith("hubert.")}
    if stripped:
        return hubert_from_hf(stripped, cfg)
    raise ValueError(f"unrecognized HuBERT state dict format in {path}")


def load_clip_checkpoint(path: str, cfg: CLIPConfig) -> Dict:
    """A CLIP checkpoint: OpenAI's TorchScript ``.pt`` (what ``clip.load``
    fetches), or a state dict (OpenAI's or a HF CLIPModel's)."""
    try:
        sd = dict(torch.jit.load(path, map_location="cpu").state_dict())
    except RuntimeError:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        sd = ckpt.get("state_dict", ckpt)
    if "visual.conv1.weight" in sd:
        return clip_from_openai(sd, cfg)
    if "vision_model.embeddings.patch_embedding.weight" in sd:
        return clip_from_hf(sd, cfg)
    raise ValueError(f"unrecognized CLIP state dict format in {path}")
