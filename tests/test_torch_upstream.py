"""The port's s3prl upstreams (speechclip_tpu_torch/models/upstream.py)
against the JAX package's: the mel filterbank bitwise; ``log_mel``, the
GRU, APC and CPC at f32 (1e-4) and bf16 (per-row cosine 0.999) from one
JAX init carried with ``convert/from_jax.py``; the registry and the config
reader (``upstream_args``, downsample 160, unknown names raise); an
input shorter than one hop; and JAX's blockers on tests/test_models.py's
tiny config (``wsum_remat``, ``load_pretrained``, ``reinit_layers`` /
``unfreeze_layers``). The model over each upstream is
tests/test_torch_upstream_model.py."""

import copy
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechclip_tpu.models import upstream as jax_up
from speechclip_tpu.models.speechclip import SpeechCLIPModel as JaxModel
from speechclip_tpu.models.speechclip import resolve_tower_configs
from speechclip_tpu_torch.config import ConfigTree, model_config_from_tree, resolve_audio_upstream
from speechclip_tpu_torch.convert.from_jax import speechclip_params_from_jax
from speechclip_tpu_torch.models import upstream as port_up
from speechclip_tpu_torch.models.speechclip import SpeechCLIPModel, cast_params
from tests.test_models import tiny_speechclip_config

torch.set_num_threads(2)
RTOL, ATOL = 1e-4, 1e-4
MIN_COSINE = 0.999
APC_ARGS = {"n_mels": 16, "encoder_embed_dim": 32, "num_layers": 2}
CPC_ARGS = {"conv_dim": 48, "context_dim": 32}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _wav(b=3, n=3200, seed=0):
    return np.random.default_rng(seed).standard_normal((b, n)).astype(np.float32) * 0.3


def _agree(got, want, dtype):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    else:
        g, w = got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])
        cos = (g * w).sum(-1) / np.maximum(np.linalg.norm(g, axis=-1) * np.linalg.norm(w, axis=-1),
                                           1e-12)
        assert cos.min() >= MIN_COSINE, cos.min()


# ----------------------------------------------------------------- pieces
def test_mel_filterbank_bitwise():
    for n_mels, n_fft in ((80, 512), (16, 512), (40, 400)):
        np.testing.assert_array_equal(port_up.mel_filterbank(n_mels, n_fft),
                                      jax_up.mel_filterbank(n_mels, n_fft))


@pytest.mark.parametrize("n", [3200, 3205, 160, 480, 100])
def test_log_mel(n):
    wav = _wav(n=n)
    got = port_up.log_mel(torch.from_numpy(wav), n_mels=24)
    want = jax_up.log_mel(jnp.asarray(wav), n_mels=24)
    assert got.shape == (3, n // 160, 24) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("in_dim, hidden", [(12, 16), (32, 32)])
def test_gru_layer(dtype, in_dim, hidden):
    jdt, pdt = DTYPES[dtype]
    params = jax_up.gru_layer_init(jax.random.key(1), in_dim, hidden)
    x = np.random.default_rng(2).standard_normal((2, 9, in_dim)).astype(np.float32)
    want = jax_up.gru_layer_apply(params, jnp.asarray(x, jdt))
    got = port_up.gru_layer_apply(cast_params(speechclip_params_from_jax(
        {"weighted_sum": _np(params)})["weighted_sum"], pdt, "cpu"),
        torch.from_numpy(x).to(pdt))
    assert got.dtype == pdt
    _agree(got, want, dtype)


def test_gru_matches_torch_gru():
    """The gate order and layout are torch.nn.GRU's."""
    torch.manual_seed(0)
    ref = torch.nn.GRU(12, 16, batch_first=True)
    params = {"w_ih": ref.weight_ih_l0.detach().T, "w_hh": ref.weight_hh_l0.detach().T,
              "b_ih": ref.bias_ih_l0.detach(), "b_hh": ref.bias_hh_l0.detach()}
    x = torch.randn(2, 9, 12)
    with torch.no_grad():
        want, _ = ref(x)
    torch.testing.assert_close(port_up.gru_layer_apply(params, x), want, rtol=1e-5, atol=1e-5)


def test_init_shapes():
    gen = torch.Generator().manual_seed(0)
    p = port_up.gru_layer_init(gen, 8, 16)
    assert p["w_ih"].shape == (8, 48) and p["w_hh"].shape == (16, 48)
    assert float(p["w_hh"].abs().max()) <= 0.25
    cpc = port_up.cpc_init(gen, port_up.CPCConfig(**CPC_ARGS))
    assert [c["w"].shape for c in cpc["convs"]] == [(48, 1, 10), (48, 48, 8), (48, 48, 4),
                                                    (48, 48, 4), (48, 48, 4)]
    apc = port_up.apc_init(gen, port_up.APCConfig(**APC_ARGS))
    assert apc["prenet"]["w"].shape == (16, 32) and len(apc["layers"]) == 2


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name, args", [("apc", APC_ARGS), ("modified_cpc", CPC_ARGS)])
def test_upstream_apply(name, args, dtype):
    jdt, pdt = DTYPES[dtype]
    jup, pup = jax_up.resolve_upstream(name, args), port_up.resolve_upstream(name, args)
    params = jup.init(jax.random.key(0))
    carried = speechclip_params_from_jax({"audio_encoder": _np(params)})["audio_encoder"]
    wav, wav_len = _wav(), np.array([3200, 1600, 2471])
    want, want_len = jup.apply(params, jnp.asarray(wav, jdt), jnp.asarray(wav_len))
    got, got_len = pup.apply(cast_params(carried, pdt, "cpu"), torch.from_numpy(wav).to(pdt),
                             torch.from_numpy(wav_len))
    assert len(got) == len(want) == pup.cfg.num_hidden_states
    for g, w in zip(got, want):
        assert g.dtype == pdt
        _agree(g, w, dtype)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert got_len.dtype == torch.int32


def test_shorter_than_a_hop():
    """Under 160 samples there is no frame: empty states and zero lengths,
    as in JAX (the port's rfft and GRU loop refused an empty frame axis)."""
    jup, pup = (m.resolve_upstream("apc", APC_ARGS) for m in (jax_up, port_up))
    params = jup.init(jax.random.key(0))
    carried = speechclip_params_from_jax({"audio_encoder": _np(params)})["audio_encoder"]
    wav, wav_len = _wav(2, 100), np.array([100, 40])
    want, want_len = jup.apply(params, jnp.asarray(wav), jnp.asarray(wav_len))
    got, got_len = pup.apply(carried, torch.from_numpy(wav), torch.from_numpy(wav_len))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want] == [(2, 0, 32)] * 2
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))


def test_registry_and_config_reader(tmp_path):
    assert port_up.resolve_upstream("hubert") is None
    assert port_up.resolve_upstream("hubert_large_ll60k") is None
    up = port_up.resolve_upstream("apc", {"encoder_embed_dim": 32})
    assert up.cfg.downsample_rate == 160 and up.cfg.encoder_embed_dim == 32
    for resolve in (port_up.resolve_upstream, jax_up.resolve_upstream):
        with pytest.raises(NotImplementedError, match="offline registry"):
            resolve("wav2vec2_xlsr")
    cpc = port_up.CPCConfig(**CPC_ARGS)
    assert cpc.hidden_state_dims == (48, 32) and cpc.encoder_embed_dim == 32
    assert port_up.upstream_name(cpc) == "modified_cpc"
    for name, args in (("apc", APC_ARGS), ("modified_cpc", {**CPC_ARGS,
                                                            "conv_strides": [5, 4, 2, 2, 2]})):
        cfg = _jax_config(tmp_path, name, args)
        got = model_config_from_tree(ConfigTree(cfg.to_dict()))
        want, _ = resolve_tower_configs(cfg)
        assert got.audio_encoder_type == "s3prl_plus"
        assert {k: tuple(v) if isinstance(v, list) else v for k, v in vars(want).items()} == \
            vars(got.audio)
        assert resolve_audio_upstream(ConfigTree(cfg.to_dict()).audio_encoder).name == name
    cfg = _jax_config(tmp_path, "apc", APC_ARGS)
    cfg.audio_encoder.name = "hubert"  # the hubert family under s3prl_plus: HuBERT itself
    cfg.audio_encoder.custom = tiny_speechclip_config(tmp_path).audio_encoder.custom.to_dict()
    assert resolve_audio_upstream(ConfigTree(cfg.to_dict()).audio_encoder) is None
    assert SpeechCLIPModel(model_config_from_tree(ConfigTree(cfg.to_dict())),
                           device="cpu").upstream is None


# ------------------------------------------------------------ config helpers
def _jax_config(tmp_path, name, args, cascaded=1.0, precision=32, select="weighted_sum"):
    """tests/test_models.py's tiny config with the s3prl upstream ``name``."""
    cfg = tiny_speechclip_config(tmp_path, cascaded=cascaded)
    cfg.audio_encoder.type = "s3prl_plus"
    cfg.audio_encoder.name = name
    del cfg.audio_encoder["custom"]
    cfg.audio_encoder.upstream_args = dict(args)
    cfg.audio_encoder.feat_select_idx = select
    cfg.trainer.precision = precision
    return cfg


def _port_model(cfg):
    return SpeechCLIPModel(model_config_from_tree(ConfigTree(copy.deepcopy(cfg).to_dict())),
                           device="cpu")


def test_blockers(tmp_path, caplog):
    """JAX's: ``wsum_remat`` warns and stays off, a configured weight file
    is refused with a warning, and ``reinit_layers`` / ``unfreeze_layers``
    raise on an upstream; a trainable upstream trains every leaf."""
    cfg = _jax_config(tmp_path, "apc", APC_ARGS)
    cfg.audio_encoder.wsum_remat = True
    cfg.audio_encoder.pretrained = True
    cfg.audio_encoder.pretrained_path = str(tmp_path / "apc.pt")
    with caplog.at_level(logging.WARNING):
        jm, pm = JaxModel(cfg), _port_model(cfg)
    assert not pm.wsum_remat_engaged
    assert sum("a custom s3prl upstream is configured" in r.getMessage()
               for r in caplog.records) == 2  # JAX's warning and the port's
    jparams = jax.eval_shape(jm.init, jax.random.key(0))[0]
    pparams, _ = pm.init(0)
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        out = pm.load_pretrained(pparams)
        jm.load_pretrained(jparams)
    assert out["audio_encoder"] is pparams["audio_encoder"]
    assert sum("not available offline" in r.getMessage() for r in caplog.records) == 2

    cfg = _jax_config(tmp_path, "apc", APC_ARGS)
    cfg.audio_encoder.trainable = True
    for key in ("unfreeze_layers", "reinit_layers"):
        cfg.audio_encoder[key] = [1]
        jm, pm = JaxModel(cfg), _port_model(cfg)
        for model, p in ((jm, jparams), (pm, pparams)):
            with pytest.raises(NotImplementedError, match="hubert-family"):
                model.trainable_mask(p)
            if key == "reinit_layers":
                with pytest.raises(NotImplementedError, match="hubert-family"):
                    model.load_pretrained(p)
        del cfg.audio_encoder[key]
    jm, pm = JaxModel(cfg), _port_model(cfg)
    assert all(jax.tree.leaves(pm.trainable_mask(pparams)["audio_encoder"]))
    assert all(jax.tree.leaves(jm.trainable_mask(jparams)["audio_encoder"]))
