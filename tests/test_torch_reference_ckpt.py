"""The reference Lightning checkpoint converter of the port
(``speechclip_tpu_torch/convert/reference_ckpt.py``) and its restore path
(``training.checkpoint.load_any_checkpoint``) against the JAX package's, on
``tests/test_reference_ckpt.py``'s synthetic checkpoint (the reference's
state-dict names, tiny dims) and a variant of it with the eachKw
BatchNorms as K modules, a learnable VQ temperature, a trainable loss
temperature and the three projection MLPs.

Limits: the converted params and kw-BN state equal JAX's conversion carried
across by ``convert/from_jax.py`` bit for bit, leaf by leaf; features of the
two models from them within 1e-4 (f32)."""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechclip_tpu.config import ConfigNode
from speechclip_tpu.convert.reference_ckpt import convert_reference_checkpoint as jax_convert
from speechclip_tpu.models.speechclip import SpeechCLIPModel as JaxModel
from speechclip_tpu_torch.config import ConfigTree, model_config_from_tree
from speechclip_tpu_torch.convert.from_jax import (
    speechclip_params_from_jax,
    speechclip_state_from_jax,
)
from speechclip_tpu_torch.convert.reference_ckpt import (
    convert_reference_checkpoint,
    load_reference_checkpoint,
)
from speechclip_tpu_torch.models.speechclip import SpeechCLIPModel, cast_params
from tests.test_reference_ckpt import build_reference_ckpt
from tests.test_models import tiny_speechclip_config

ATOL = 1e-4
K, D = 4, 32
FLICKR_TABLE = "avssl/data/flickr_stat/text_clip_vocab_usage_byfreq.npy"


def each_kw_variant(config, ckpt):
    """The checkpoint with K BatchNorm1d modules (eachKw, not parallel), a
    learnable VQ temperature, a trainable log(1/t) and the image, parallel
    and cascaded projection MLPs (16 -> 24 -> 16), as the reference names
    them."""
    cfg = copy.deepcopy(config.to_dict())
    cb = cfg["model_settings"]["cascaded_branch"]
    cb["keyword"]["batchnorms"]["parallel"] = False
    cb["vq"]["args"]["temp"] = "learnable=0.1"
    cfg["cl_loss"]["args"]["temperature_trainable"] = True
    for key in ("image_encoder_projection", "parallel_branch_projection",
                "cascaded_branch_projection"):
        cfg["model_settings"][key] = {"dimensions": [16, 24, 16], "dropout": 0.0}
    gen = torch.Generator().manual_seed(5)
    sd = {k: v for k, v in ckpt["state_dict"].items()
          if not k.startswith("cascaded_branch.bn_layer.")}
    for i in range(K):
        p = f"cascaded_branch.bn_layer.bn_layers.{i}"
        sd[f"{p}.weight"] = torch.randn(D, generator=gen)
        sd[f"{p}.bias"] = torch.randn(D, generator=gen)
        sd[f"{p}.running_mean"] = torch.randn(D, generator=gen)
        sd[f"{p}.running_var"] = torch.rand(D, generator=gen) + 0.5
        sd[f"{p}.num_batches_tracked"] = torch.tensor(3)
    sd["criterion.temperature"] = torch.tensor(2.5)
    for net in ("img_enc_proj_net", "p_branch_proj_net", "c_branch_proj_net"):
        for idx, (i, o) in zip((0, 3), ((16, 24), (24, 16))):
            sd[f"{net}.sequential.{idx}.weight"] = torch.randn(o, i, generator=gen)
            sd[f"{net}.sequential.{idx}.bias"] = torch.randn(o, generator=gen)
    return ConfigNode(cfg), {"state_dict": sd, "hyper_parameters": {"config": cfg}}


@pytest.fixture(scope="module", params=["shipped form", "eachKw variant"])
def checkpoint(request, tmp_path_factory):
    config = tiny_speechclip_config(tmp_path_factory.mktemp("ref_ckpt"))
    ckpt, _ = build_reference_ckpt(config)
    if request.param == "eachKw variant":
        config, ckpt = each_kw_variant(config, ckpt)
    return config, ckpt


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def assert_same_tree(got, want, path=""):
    """Equal structure (the same keys), and every tensor leaf bitwise equal
    (dtype too)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (path, list(got), list(want))
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, f"{path}[{i}]")
    elif want is None:
        assert got is None, path
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, (path, got.shape, want.shape)
        assert torch.equal(got, want), path


def test_converted_params_equal_jax_bitwise(checkpoint):
    """The port's conversion equals JAX's carried across by from_jax, leaf
    by leaf, bit for bit; the kw-BN statistics likewise."""
    config, ckpt = checkpoint
    params, state, out_cfg = convert_reference_checkpoint(ckpt, ConfigTree(config.to_dict()))
    jax_params, jax_state, _ = jax_convert(ckpt, ConfigNode(config.to_dict()))
    assert_same_tree(params, speechclip_params_from_jax(np_tree(jax_params)))
    assert_same_tree(state, speechclip_state_from_jax(np_tree(jax_state)))
    assert isinstance(out_cfg, ConfigTree)
    bn = params["cascaded_branch"]["bn"]["scale"]
    if config.model_settings.cascaded_branch.keyword.batchnorms.parallel:
        assert bn.shape == (K * D,)
    else:  # K modules stacked
        assert bn.shape == (K, D) and params["cascaded_branch"]["vq"]["curr_temp"].numel() == 1
        assert params["criterion"]["log_inv_temp"].dim() == 0
        assert {"img_enc_proj", "p_branch_proj", "c_branch_proj"} <= set(params)


def test_encode_speech_of_the_converted_models_matches_jax(checkpoint):
    """Both models built from their converted checkpoint: speech (both
    branches) and image features within 1e-4 at f32."""
    config, ckpt = checkpoint
    params, state, out_cfg = convert_reference_checkpoint(ckpt, ConfigTree(config.to_dict()))
    model = SpeechCLIPModel(model_config_from_tree(out_cfg), device="cpu")
    params, state = cast_params(params, torch.float32, "cpu"), cast_params(state, torch.float32,
                                                                           "cpu")
    jax_params, jax_state, jax_cfg = jax_convert(ckpt, ConfigNode(config.to_dict()))
    jax_model = JaxModel(jax_cfg)
    rng = np.random.default_rng(3)
    wav = rng.standard_normal((3, 2000)).astype(np.float32)
    lens = np.array([2000, 1500, 900], np.int32)
    wav[1, 1500:] = wav[2, 900:] = 0
    want = jax_model.encode_speech(jax_params, jax_state, jnp.asarray(wav), jnp.asarray(lens))
    with torch.no_grad():
        got = model.encode_speech(params, state, torch.from_numpy(wav), torch.from_numpy(lens))
        images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
        got_img = model.forward_image(params, torch.from_numpy(images))
    for key in ("parallel_audio_feat", "cascaded_audio_feat"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ATOL,
                                   err_msg=key)
    np.testing.assert_allclose(
        got_img.numpy(), np.asarray(jax_model.forward_image(jax_params, jnp.asarray(images))),
        atol=ATOL)


def test_released_checkpoint_unpickles_without_avssl_or_lightning(tmp_path):
    """A released checkpoint pickles pytorch_lightning's AttributeDict around
    an avssl OrderedNamespace tree, neither installed: the port's tolerant
    unpickler stubs them and the nested values survive (the fixture saves
    through clones registered under the real module paths, then removes
    them before loading)."""
    import sys
    import types
    from collections import OrderedDict

    fake_names = ["avssl", "avssl.base", "avssl.base.ordered_namespace", "pytorch_lightning",
                  "pytorch_lightning.utilities", "pytorch_lightning.utilities.parsing"]
    assert all(n not in sys.modules for n in fake_names)

    class OrderedNamespace:  # state layout of avssl/base/ordered_namespace.py
        def __init__(self, data):
            object.__setattr__(self, "_odict", OrderedDict())
            for k, v in data.items():
                self._odict[k] = OrderedNamespace(v) if isinstance(v, dict) else v

        def __setattr__(self, key, val):
            self._odict[key] = val

    class AttributeDict(dict):
        pass

    OrderedNamespace.__module__ = "avssl.base.ordered_namespace"
    OrderedNamespace.__qualname__ = "OrderedNamespace"
    AttributeDict.__module__ = "pytorch_lightning.utilities.parsing"
    AttributeDict.__qualname__ = "AttributeDict"
    mods = {n: types.ModuleType(n) for n in fake_names}
    mods["avssl.base.ordered_namespace"].OrderedNamespace = OrderedNamespace
    mods["pytorch_lightning.utilities.parsing"].AttributeDict = AttributeDict
    sys.modules.update(mods)
    try:
        config = tiny_speechclip_config(tmp_path)
        ckpt, _ = build_reference_ckpt(config)
        ckpt["hyper_parameters"] = AttributeDict(config=OrderedNamespace(config.to_dict()))
        path = tmp_path / "released_style.ckpt"
        torch.save(ckpt, str(path))
    finally:
        for n in fake_names:
            sys.modules.pop(n, None)

    params, _, out_cfg = load_reference_checkpoint(str(path))
    assert "audio_encoder" in params and "clip" in params
    for key in ("model_settings.cascaded_branch.transformer_type",
                "model_settings.cascaded_branch.keyword.number",
                "audio_encoder.custom.encoder_layers"):
        assert out_cfg.get_path(key) == config.get_path(key), key


def test_released_stat_path_remaps_to_the_vendored_table(tmp_path):
    """The pickled config's reference-repository table path becomes the
    vendored copy under assets/, as JAX's conversion makes it."""
    config = tiny_speechclip_config(tmp_path)
    ckpt, _ = build_reference_ckpt(config)
    cfg = copy.deepcopy(config.to_dict())
    cfg["clip"]["reduce_subword_embbedding"] = FLICKR_TABLE
    _, _, out_cfg = convert_reference_checkpoint(ckpt, ConfigTree(cfg))
    _, _, jax_cfg = jax_convert(ckpt, ConfigNode(copy.deepcopy(cfg)))
    resolved = out_cfg.clip.reduce_subword_embbedding
    assert resolved == jax_cfg.clip.reduce_subword_embbedding
    assert os.path.isabs(resolved) and resolved.endswith(
        "assets/flickr_stat/text_clip_vocab_usage_byfreq.npy")
    assert np.load(resolved).shape == (8112, 2)


def test_a_reference_layout_table_path_builds_as_in_jax(tmp_path):
    """``resolve_asset_path``'s remap: a config naming the reference
    layout's Flickr table (at CLIP's full vocabulary) builds the same SOT /
    EOT ids and reduced vocabulary in both packages."""
    from speechclip_tpu.models.speechclip import _resolve_asset_path
    from speechclip_tpu_torch.models.speechclip import resolve_asset_path

    assert resolve_asset_path(FLICKR_TABLE) == _resolve_asset_path(FLICKR_TABLE)
    assert resolve_asset_path("no/such/file.npy") == "no/such/file.npy"
    cfg = copy.deepcopy(tiny_speechclip_config(tmp_path).to_dict())
    cfg["clip"]["reduce_subword_embbedding"] = FLICKR_TABLE
    cfg["clip"]["custom"]["text"]["vocab_size"] = 49408
    model = SpeechCLIPModel(model_config_from_tree(ConfigTree(cfg)), device="cpu")
    jax_model = JaxModel(ConfigNode(cfg))
    assert (model.sot_id, model.eot_id) == (jax_model.sot_id, jax_model.eot_id)
    np.testing.assert_array_equal(model.reduced_vocab.selected_ids,
                                  jax_model.reduced_vocab.selected_ids)
    assert model.reduced_vocab.original_to_reduced == jax_model.reduced_vocab.original_to_reduced


def test_lightning_file_serves_through_from_checkpoint(tmp_path):
    """A Lightning ``.ckpt`` on disk -> ``load_any_checkpoint`` and
    ``EncoderService.from_checkpoint(device="cpu")``: the served features
    equal the restored model's direct ones and JAX's service's within 1e-4."""
    from speechclip_tpu.serving import EncoderService as JaxService
    from speechclip_tpu_torch.serving import EncoderService
    from speechclip_tpu_torch.training.checkpoint import load_any_checkpoint

    config = tiny_speechclip_config(tmp_path)
    ckpt, _ = build_reference_ckpt(config)
    path = tmp_path / "epoch=42-step=1234.ckpt"
    torch.save(ckpt, str(path))
    model, params, state = load_any_checkpoint(str(path), device="cpu")
    assert model.device.type == "cpu"
    svc = EncoderService.from_checkpoint(str(path), wav_buckets=(2000,), batch=2,
                                         max_wait_ms=5.0, device="cpu")
    jax_svc = JaxService.from_checkpoint(str(path), wav_buckets=(2000,), batch=2,
                                         max_wait_ms=5.0)
    try:
        wav = np.random.default_rng(7).standard_normal(1800).astype(np.float32)
        got, want = svc.encode_speech(wav), jax_svc.encode_speech(wav)
        padded = np.zeros((1, 2000), np.float32)
        padded[0, :1800] = wav
        with torch.no_grad():
            direct = model.encode_speech(params, state, torch.from_numpy(padded),
                                         torch.tensor([1800]))
        for key in ("parallel_audio_feat", "cascaded_audio_feat"):
            np.testing.assert_allclose(got[key], direct[key][0].numpy(), atol=1e-6)
            np.testing.assert_allclose(got[key], want[key], atol=ATOL, err_msg=key)
    finally:
        svc.close()
        jax_svc.close()
