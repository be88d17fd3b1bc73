"""``SpeechCLIPModel`` over each s3prl upstream (APC and CPC) against the
JAX package's, on tests/test_models.py's tiny config (both branches) from
one JAX init carried with ``convert/from_jax.py``: the forward's features
(f32 1e-4, bf16 per-row cosine 0.999), keyword ids and losses; the loss's
gradient in every trainable leaf (f32) with the upstream frozen and
``trainable_mask`` equal; the feature selections (named keys, index lists:
CPC's states are 48 and 32 wide)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechclip_tpu.models.speechclip import SpeechCLIPModel as JaxModel
from speechclip_tpu_torch.convert.from_jax import (
    speechclip_params_from_jax,
    speechclip_state_from_jax,
)
from speechclip_tpu_torch.models.speechclip import cast_params
from tests.test_torch_train_step import flat, port_tree
from tests.test_torch_upstream import APC_ARGS, CPC_ARGS, _agree, _jax_config, _np, _port_model

torch.set_num_threads(2)
ARGS = {"apc": APC_ARGS, "modified_cpc": CPC_ARGS}
SELECT = {"apc": "weighted_sum", "modified_cpc": "last_hidden_state"}  # CPC: no weighted sum


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(name, dtype) -> (JAX model, port model, JAX params, state, the
    port's cast params and state), built once."""
    cache = {}

    def get(name, dtype):
        if (name, dtype) not in cache:
            cfg = _jax_config(tmp_path_factory.mktemp(name), name, ARGS[name],
                              precision=32 if dtype == "f32" else 16, select=SELECT[name])
            jm, pm = JaxModel(cfg), _port_model(cfg)
            params, state = jm.init(jax.random.key(0))
            cache[name, dtype] = (
                jm, pm, params, state,
                cast_params(speechclip_params_from_jax(_np(params)), pm.compute_dtype, "cpu"),
                cast_params(speechclip_state_from_jax(_np(state)), pm.compute_dtype, "cpu"))
        return cache[name, dtype]
    return get


def _batch():
    rng = np.random.default_rng(7)
    return {"wav": rng.standard_normal((4, 2000)).astype(np.float32) * 0.3,
            "wav_len": np.array([2000, 1500, 1000, 2000]),
            "image": rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
            "id": np.array([0, 0, 1, 2])}


def _jax_batch():
    return {k: jnp.asarray(v) for k, v in _batch().items()}


def _port_batch():
    return {k: torch.from_numpy(v) for k, v in _batch().items()}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["apc", "modified_cpc"])
def test_forward_and_loss(models, name, dtype):
    jm, pm, params, state, pparams, pstate = models(name, dtype)
    assert pm.upstream.name == jm.upstream.name == name
    assert pm.audio_cfg.downsample_rate == 160
    assert ("weighted_sum" in pparams) == (name == "apc")
    jfeats, _, jothers, _ = jax.jit(jm.forward)(params, state, _jax_batch())
    pfeats, _, pothers, _ = pm.forward(pparams, pstate, _port_batch())
    assert pfeats["parallel_audio_feat"].shape == (4, 16)
    for key in ("parallel_audio_feat", "cascaded_audio_feat", "image_feat"):
        _agree(pfeats[key], jfeats[key], dtype)
    if dtype == "f32":
        np.testing.assert_array_equal(
            np.asarray(jothers["vq_results"]["subword_prob"]).argmax(-1),
            pothers["vq_results"]["subword_prob"].argmax(-1).numpy())
        jloss, ploss = jm.compute_loss(params, jfeats), pm.compute_loss(pparams, pfeats)
        for key in ("loss", "p_cl_loss", "c_cl_loss"):
            np.testing.assert_allclose(float(ploss[key]), float(jloss[key]), rtol=1e-5)


@pytest.mark.parametrize("name", ["apc", "modified_cpc"])
def test_gradients_and_mask(models, name):
    """The loss's gradient in every trainable leaf equals JAX's at f32, the
    frozen upstream holds none, and ``trainable_mask`` marks the same
    leaves."""
    jm, pm, params, state, pparams, pstate = models(name, "f32")
    jmask, pmask = jm.trainable_mask(params), pm.trainable_mask(pparams)
    assert flat(jax.tree.map(float, jmask)) == flat(jax.tree.map(float, pmask))
    assert not any(jax.tree.leaves(pmask["audio_encoder"]))

    def jloss(p):
        p = jax.tree.map(lambda x, t: x if t else jax.lax.stop_gradient(x), p, jmask)
        feats, _, _, _ = jm.forward(p, state, _jax_batch())
        return jm.compute_loss(p, feats)["loss"]

    want = flat(port_tree(jax.jit(jax.grad(jloss))(params)))
    leaves = jax.tree_util.tree_flatten_with_path(pparams)[0]
    live = [(jax.tree_util.keystr(path), leaf.detach().clone().requires_grad_(True))
            for (path, leaf), keep in zip(leaves, jax.tree.leaves(pmask)) if keep]
    by_path = dict(live)
    trained = jax.tree_util.tree_map_with_path(
        lambda path, leaf: by_path.get(jax.tree_util.keystr(path), leaf), pparams)
    feats, _, _, _ = pm.forward(trained, pstate, _port_batch())
    grads = torch.autograd.grad(pm.compute_loss(trained, feats)["loss"],
                                [leaf for _, leaf in live], allow_unused=True)
    assert len(live) > 5
    for (path, _), g in zip(live, grads):
        g = np.zeros_like(want[path]) if g is None else g.numpy()
        np.testing.assert_allclose(g, want[path], rtol=1e-3,
                                   atol=1e-5 + 1e-3 * np.abs(want[path]).max(), err_msg=path)
    assert np.abs(want["['parallel_branch']['cls']"]).max() > 0


@pytest.mark.parametrize("name", ["apc", "modified_cpc"])
def test_feature_selection(models, name):
    jm, pm, params, _, pparams, _ = models(name, "f32")
    wav, wav_len = _batch()["wav"][:2], np.array([2000, 1500])
    keep = pm.config
    try:
        for select in ("hidden_states", "all", "last_hidden_state", [0], [1, 0]):
            jm.config.audio_encoder.feat_select_idx = select
            pm.config = dataclasses.replace(keep, feat_select_idx=select)
            want, want_len = jax.jit(jm.forward_audio)(params, jnp.asarray(wav),
                                                       jnp.asarray(wav_len))
            got, got_len = pm.forward_audio(pparams, torch.from_numpy(wav),
                                            torch.from_numpy(wav_len))
            np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
            if select == "last_hidden_state":
                got, want = [got], [want]
            assert type(got) is type(want) and len(got) == len(want), select
            for g, w in zip(got, want):
                _agree(g, w, "f32")
        if name == "modified_cpc":  # mixed widths: c 32, z 48
            assert [g.shape[-1] for g in got] == [32, 48]
        _, _, hidden = pm.forward_audio(pparams, torch.from_numpy(wav),
                                        torch.from_numpy(wav_len), return_hidden_states=True)
        assert len(hidden) == pm.audio_cfg.num_hidden_states
    finally:
        jm.config.audio_encoder.feat_select_idx = SELECT[name]
        pm.config = keep
