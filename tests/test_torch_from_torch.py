"""``speechclip_tpu_torch.convert.from_torch`` on synthetic torch state
dicts, written here from the port's own seeded tiny towers in fairseq and
HuggingFace HuBERT layouts, OpenAI CLIP (ViT and ModifiedResNet) and
HuggingFace CLIP (ViT) layouts:
each converts back to the towers bitwise, and to what the JAX package's
``convert/from_torch.py`` makes of the same dict (carried across with
``convert/from_jax.py``); the ``pos_conv`` weight-norm fold equals torch's
``weight_norm``; ``SpeechCLIPModel.load_pretrained`` loads configured files
and keeps the random towers, with JAX's warning, where they are missing."""

import dataclasses
import logging

import jax
import numpy as np
import pytest
import torch

from speechclip_tpu.convert import from_torch as jax_from_torch
from speechclip_tpu.models import clip as jax_clip
from speechclip_tpu.models import hubert as jax_hubert
from speechclip_tpu_torch import tiny_flagship_config
from speechclip_tpu_torch.config import CLIPConfig
from speechclip_tpu_torch.convert import from_torch
from speechclip_tpu_torch.convert.from_jax import speechclip_params_from_jax
from speechclip_tpu_torch.models import clip as port_clip
from speechclip_tpu_torch.models import hubert as port_hubert
from speechclip_tpu_torch.models.speechclip import SpeechCLIPModel, cast_params
from speechclip_tpu_torch.training.optim import tree_leaves

CFG = tiny_flagship_config()


def _towers():
    gen = torch.Generator().manual_seed(3)
    ae = port_hubert.hubert_init(gen, CFG.audio)
    clip = {"visual": port_clip.vision_init(gen, CFG.clip_vision),
            "text": port_clip.text_init(gen, CFG.clip_text),
            "logit_scale": torch.tensor(4.6)}
    return ae, clip


def _lin(sd, prefix, p):
    sd[f"{prefix}.weight"] = p["w"].T.contiguous()
    if p.get("b") is not None:
        sd[f"{prefix}.bias"] = p["b"]


def _ln(sd, prefix, p):
    sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = p["scale"], p["bias"]


def _qkv(sd, prefix, p, names=("q_proj", "k_proj", "v_proj")):
    w, b = p["in_proj"]["w"], p["in_proj"]["b"]
    d = w.shape[0]
    for i, name in enumerate(names):
        sd[f"{prefix}.{name}.weight"] = w[:, i * d:(i + 1) * d].T.contiguous()
        sd[f"{prefix}.{name}.bias"] = b[i * d:(i + 1) * d]
    _lin(sd, f"{prefix}.out_proj", p["out_proj"])


def hubert_sd(ae, flavor):
    """A fairseq or HF HubertModel state dict holding ``ae`` (pos_conv as
    a plain weight; weight-norm pairs are tested on their own)."""
    sd = {}
    hf = flavor == "hf"
    for i, layer in enumerate(ae["feature_extractor"]):
        sd[f"feature_extractor.conv_layers.{i}." + ("conv.weight" if hf else "0.weight")] = \
            layer["w"]
        if "norm" in layer:
            _ln(sd, f"feature_extractor.conv_layers.{i}." + ("layer_norm" if hf else "2"),
                layer["norm"])
    _ln(sd, "feature_projection.layer_norm" if hf else "layer_norm", ae["layer_norm"])
    _lin(sd, "feature_projection.projection" if hf else "post_extract_proj",
         ae["post_extract_proj"])
    enc = ae["encoder"]
    pos = "encoder.pos_conv_embed.conv" if hf else "encoder.pos_conv.0"
    sd[f"{pos}.weight"], sd[f"{pos}.bias"] = enc["pos_conv"]["w"], enc["pos_conv"]["b"]
    _ln(sd, "encoder.layer_norm", enc["layer_norm"])
    for i, layer in enumerate(enc["layers"]):
        p = f"encoder.layers.{i}"
        _qkv(sd, f"{p}.attention" if hf else f"{p}.self_attn", layer["self_attn"])
        _ln(sd, f"{p}.layer_norm" if hf else f"{p}.self_attn_layer_norm",
            layer["self_attn_layer_norm"])
        _lin(sd, f"{p}.feed_forward.intermediate_dense" if hf else f"{p}.fc1", layer["fc1"])
        _lin(sd, f"{p}.feed_forward.output_dense" if hf else f"{p}.fc2", layer["fc2"])
        _ln(sd, f"{p}.final_layer_norm", layer["final_layer_norm"])
    return sd


def _openai_block(sd, prefix, p):
    sd[f"{prefix}.attn.in_proj_weight"] = p["attn"]["in_proj"]["w"].T.contiguous()
    sd[f"{prefix}.attn.in_proj_bias"] = p["attn"]["in_proj"]["b"]
    _lin(sd, f"{prefix}.attn.out_proj", p["attn"]["out_proj"])
    _ln(sd, f"{prefix}.ln_1", p["ln_1"])
    _lin(sd, f"{prefix}.mlp.c_fc", p["mlp"]["c_fc"])
    _lin(sd, f"{prefix}.mlp.c_proj", p["mlp"]["c_proj"])
    _ln(sd, f"{prefix}.ln_2", p["ln_2"])


def _hf_block(sd, prefix, p):
    _qkv(sd, f"{prefix}.self_attn", p["attn"])
    _ln(sd, f"{prefix}.layer_norm1", p["ln_1"])
    _lin(sd, f"{prefix}.mlp.fc1", p["mlp"]["c_fc"])
    _lin(sd, f"{prefix}.mlp.fc2", p["mlp"]["c_proj"])
    _ln(sd, f"{prefix}.layer_norm2", p["ln_2"])


def clip_sd(clip, flavor):
    """An OpenAI or HF CLIP (ViT) state dict holding ``clip``."""
    v, t = clip["visual"], clip["text"]
    sd = {"logit_scale": clip["logit_scale"]}
    if flavor == "openai":
        sd.update({"visual.conv1.weight": v["conv1"]["w"],
                   "visual.class_embedding": v["class_embedding"],
                   "visual.positional_embedding": v["positional_embedding"],
                   "visual.proj": v["proj"], "token_embedding.weight": t["token_embedding"],
                   "positional_embedding": t["positional_embedding"],
                   "text_projection": t["text_projection"]})
        _ln(sd, "visual.ln_pre", v["ln_pre"])
        _ln(sd, "visual.ln_post", v["ln_post"])
        _ln(sd, "ln_final", t["ln_final"])
        for i, b in enumerate(v["blocks"]):
            _openai_block(sd, f"visual.transformer.resblocks.{i}", b)
        for i, b in enumerate(t["blocks"]):
            _openai_block(sd, f"transformer.resblocks.{i}", b)
        return sd
    e = "vision_model.embeddings"
    sd.update({f"{e}.patch_embedding.weight": v["conv1"]["w"],
               f"{e}.class_embedding": v["class_embedding"],
               f"{e}.position_embedding.weight": v["positional_embedding"],
               "visual_projection.weight": v["proj"].T.contiguous(),
               "text_model.embeddings.token_embedding.weight": t["token_embedding"],
               "text_model.embeddings.position_embedding.weight": t["positional_embedding"],
               "text_projection.weight": t["text_projection"].T.contiguous()})
    _ln(sd, "vision_model.pre_layrnorm", v["ln_pre"])
    _ln(sd, "vision_model.post_layernorm", v["ln_post"])
    _ln(sd, "text_model.final_layer_norm", t["ln_final"])
    for i, b in enumerate(v["blocks"]):
        _hf_block(sd, f"vision_model.encoder.layers.{i}", b)
    for i, b in enumerate(t["blocks"]):
        _hf_block(sd, f"text_model.encoder.layers.{i}", b)
    return sd


def _bn(sd, prefix, p):
    sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = p["scale"], p["bias"]
    sd[f"{prefix}.running_mean"], sd[f"{prefix}.running_var"] = p["mean"], p["var"]


def resnet_visual_sd(visual):
    """OpenAI's ModifiedResNet keys for a port ``visual`` tree."""
    sd = {}
    for j in (1, 2, 3):
        sd[f"visual.conv{j}.weight"] = visual["stem"][f"conv{j}"]["w"]
        _bn(sd, f"visual.bn{j}", visual["stem"][f"bn{j}"])
    for stage in range(4):
        for i, block in enumerate(visual[f"layer{stage + 1}"]):
            prefix = f"visual.layer{stage + 1}.{i}"
            for j in (1, 2, 3):
                sd[f"{prefix}.conv{j}.weight"] = block[f"conv{j}"]["w"]
                _bn(sd, f"{prefix}.bn{j}", block[f"bn{j}"])
            if "downsample" in block:
                sd[f"{prefix}.downsample.0.weight"] = block["downsample"]["conv"]["w"]
                _bn(sd, f"{prefix}.downsample.1", block["downsample"]["bn"])
    pool = visual["attnpool"]
    sd["visual.attnpool.positional_embedding"] = pool["positional_embedding"]
    for k in ("q_proj", "k_proj", "v_proj", "c_proj"):
        _lin(sd, f"visual.attnpool.{k}", pool[k])
    return sd


def _assert_trees_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_trees_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_trees_equal(a, b)
    elif want is None:
        assert got is None
    else:
        assert got.dtype == torch.float32 and torch.equal(got, want)


def _numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}


JAX_HUBERT = jax_hubert.HubertConfig(**dataclasses.asdict(CFG.audio))
JAX_CLIP = jax_clip.CLIPConfig(vision=jax_clip.CLIPVisionConfig(**dataclasses.asdict(
    CFG.clip_vision)), text=jax_clip.CLIPTextConfig(**dataclasses.asdict(CFG.clip_text)))


@pytest.mark.parametrize("flavor", ["fairseq", "hf"])
def test_hubert_state_dict_converts_back_and_as_jax_does(flavor):
    ae, _ = _towers()
    sd = hubert_sd(ae, flavor)
    convert = from_torch.hubert_from_hf if flavor == "hf" else from_torch.hubert_from_fairseq
    got = convert(sd, CFG.audio)
    _assert_trees_equal(got, ae)
    jax_convert = (jax_from_torch.hubert_from_hf if flavor == "hf"
                   else jax_from_torch.hubert_from_fairseq)
    jax_tree = jax.tree.map(np.asarray, jax_convert(_numpy(sd), JAX_HUBERT))
    _assert_trees_equal(got, speechclip_params_from_jax({"audio_encoder": jax_tree})[
        "audio_encoder"])


@pytest.mark.parametrize("flavor", ["openai", "hf"])
def test_clip_state_dict_converts_back_and_as_jax_does(flavor):
    _, clip = _towers()
    sd = clip_sd(clip, flavor)
    cfg = CLIPConfig(vision=CFG.clip_vision, text=CFG.clip_text)
    convert = from_torch.clip_from_hf if flavor == "hf" else from_torch.clip_from_openai
    got = convert(sd, cfg)
    _assert_trees_equal(got, clip)
    jax_convert = jax_from_torch.clip_from_hf if flavor == "hf" else jax_from_torch.clip_from_openai
    jax_tree = jax.tree.map(np.asarray, jax_convert(_numpy(sd), JAX_CLIP))
    _assert_trees_equal(got, speechclip_params_from_jax({"clip": jax_tree})["clip"])


def test_modified_resnet_state_dict_converts_back_and_as_jax_does():
    from speechclip_tpu_torch.config import CLIPResNetVisionConfig

    vision = CLIPResNetVisionConfig(image_size=64, width=8, layers=(1, 2, 1, 1), heads=2,
                                    output_dim=16)
    gen = torch.Generator().manual_seed(5)
    _, vit_clip = _towers()
    clip = dict(vit_clip, visual=port_clip.vision_init(gen, vision))
    sd = {**resnet_visual_sd(clip["visual"]),
          **{k: v for k, v in clip_sd(vit_clip, "openai").items() if not k.startswith("visual.")}}
    got = from_torch.clip_from_openai(sd, CLIPConfig(vision=vision, text=CFG.clip_text))
    _assert_trees_equal(got, clip)
    jax_cfg = jax_clip.CLIPConfig(
        vision=jax_clip.CLIPResNetVisionConfig(**dataclasses.asdict(vision)), text=JAX_CLIP.text)
    jax_tree = jax.tree.map(np.asarray, jax_from_torch.clip_from_openai(_numpy(sd), jax_cfg))
    _assert_trees_equal(got, speechclip_params_from_jax({"clip": jax_tree})["clip"])


@pytest.mark.parametrize("form", ["fairseq", "parametrizations"])
def test_pos_conv_weight_norm_fold(form):
    """fairseq's ``weight_g``/``weight_v`` and torch's parametrization of
    ``weight_norm(dim=2)`` fold to torch's own weight, as JAX folds them."""
    conv = torch.nn.Conv1d(32, 32, 8, groups=4)
    if form == "fairseq":
        conv = torch.nn.utils.weight_norm(conv, dim=2)
        sd = {"p.weight_g": conv.weight_g.detach(), "p.weight_v": conv.weight_v.detach()}
        w = torch._weight_norm(conv.weight_v, conv.weight_g, 2).detach()
    else:
        conv = torch.nn.utils.parametrizations.weight_norm(conv, dim=2)
        orig = conv.parametrizations.weight
        sd = {"p.parametrizations.weight.original0": orig.original0.detach(),
              "p.parametrizations.weight.original1": orig.original1.detach()}
        w = conv.weight.detach()
    sd["p.bias"] = conv.bias.detach()
    got = from_torch._pos_conv(sd, "p")
    torch.testing.assert_close(got["w"], w, atol=1e-6, rtol=1e-5)
    want = jax_from_torch._pos_conv(_numpy(sd), "p")
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]).transpose(2, 1, 0))


def test_load_pretrained_loads_configured_files(tmp_path, caplog):
    ae, clip = _towers()
    torch.save({"model": hubert_sd(ae, "fairseq"), "cfg": {}}, tmp_path / "hubert.pt")
    torch.save(clip_sd(clip, "openai"), tmp_path / "clip.pt")
    cfg = dataclasses.replace(CFG, precision=16, audio_pretrained_path=str(tmp_path / "hubert.pt"),
                              clip_pretrained_path=str(tmp_path / "clip.pt"))
    model = SpeechCLIPModel(cfg, device="cpu")
    params, _ = model.init(0)
    params = cast_params(params, model.compute_dtype, "cpu")
    loaded = model.load_pretrained(params)
    # leaf by leaf, by path: the swapped towers keep the target's key order
    by_path = lambda t: {jax.tree_util.keystr(k): v
                         for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    for key, tower in (("audio_encoder", ae), ("clip", clip)):
        want = by_path(cast_params(tower, torch.bfloat16, "cpu"))
        got = by_path(loaded[key])
        assert len(list(tree_leaves(loaded[key]))) == len(want) and set(got) == set(want), key
        assert all(got[k].dtype == w.dtype and torch.equal(got[k], w)
                   for k, w in want.items()), key
    assert loaded["parallel_branch"] is params["parallel_branch"]

    missing = dataclasses.replace(cfg, audio_pretrained_path=str(tmp_path / "none.pt"),
                                  clip_pretrained_path=str(tmp_path / "none_clip.pt"))
    model = SpeechCLIPModel(missing, device="cpu")
    with caplog.at_level(logging.WARNING):
        kept = model.load_pretrained(params)
    assert "HuBERT checkpoint" in caplog.text and "not found; random init" in caplog.text
    assert "CLIP checkpoint" in caplog.text
    assert kept["audio_encoder"] is params["audio_encoder"] and kept["clip"] is params["clip"]
