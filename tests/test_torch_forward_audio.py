"""The port's ``forward_audio`` in every ``feat_select_idx`` mode and with
normalized hidden states, and ``encode_speech`` with the optional branch
projection MLP, against the JAX package at tiny dims and f32 (setup as in
tests/test_torch_slice.py, but from the towers' own inits, which is all
these paths read).

Tolerance: f32 max abs diff <= 1e-4 (same math, another summation order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speechclip_tpu.models import branches as jb
from speechclip_tpu.models import hubert as jh
from speechclip_tpu.ops import mlp as jmlp
from speechclip_tpu.ops.weighted_sum import weighted_sum_init
from speechclip_tpu_torch.convert.from_jax import speechclip_params_from_jax
from tests.test_torch_slice import LENS, WAV_LEN, _jax_encode_and_retrieve, _models, _wav, jax_config

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def slice_setup():
    from speechclip_tpu.models.speechclip import SpeechCLIPModel as JaxModel

    cfg = jax_config(32)
    jm = JaxModel(cfg)

    @jax.jit
    def init(key):
        k1, k2 = jax.random.split(key)
        return {
            "audio_encoder": jh.hubert_init(k1, jm.audio_cfg),
            "weighted_sum": weighted_sum_init(jm.audio_cfg.num_hidden_states),
            "parallel_branch": jb.parallel_branch_init(
                k2, cfg.model_settings.parallel_branch, 32, 16
            ),
        }

    jparams = init(jax.random.key(0))
    rng = np.random.default_rng(0)
    pcm = (rng.standard_normal((len(LENS), WAV_LEN)) * 3000).astype(np.int16)
    pcm *= (np.arange(WAV_LEN)[None, :] < LENS[:, None]).astype(np.int16)
    gallery = rng.standard_normal((64, 16)).astype(np.float32)
    gallery /= np.linalg.norm(gallery, axis=1, keepdims=True)
    return dict(
        jparams=jparams,
        pparams32=speechclip_params_from_jax(jax.tree.map(np.asarray, jparams)),
        pcm=pcm, gallery=gallery,
    )


@pytest.mark.parametrize(
    "select", ["last_hidden_state", "hidden_states", (0, 2), "weighted_sum"]
)
def test_forward_audio_feat_select_modes(slice_setup, select):
    cfg = jax_config(32, feat_select_idx=list(select) if isinstance(select, tuple) else select)
    jm, jparams, pm, pparams = _models(slice_setup, cfg)
    jwav, pwav = _wav(slice_setup, "float32")
    want, want_len = jax.jit(jm.forward_audio)(jparams, jwav, jnp.asarray(LENS))
    got, got_len = pm.forward_audio(pparams, pwav, torch.from_numpy(LENS))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    want_l = [want] if select in ("last_hidden_state", "weighted_sum") else list(want)
    got_l = [got] if select in ("last_hidden_state", "weighted_sum") else list(got)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)


@pytest.mark.parametrize("norm_type", ["s3prl", "method1"])
def test_forward_audio_normalized_hidden_states(slice_setup, norm_type):
    cfg = jax_config(32, normalize_hiddenstates=True, normalize_type=norm_type)
    jm, jparams, pm, pparams = _models(slice_setup, cfg)
    jwav, pwav = _wav(slice_setup, "float32")
    want, _ = jax.jit(jm.forward_audio)(jparams, jwav, jnp.asarray(LENS))
    got, _ = pm.forward_audio(pparams, pwav, torch.from_numpy(LENS))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_branch_projection_mlp_is_applied(slice_setup):
    jproj = jmlp.mlp_init(jax.random.key(5), [16, 32, 16])
    pproj = speechclip_params_from_jax(
        {"p_branch_proj": jax.tree.map(np.asarray, jproj)}
    )["p_branch_proj"]
    jm, jparams, pm, pparams = _models(
        slice_setup, jax_config(32), {"p_branch_proj": (jproj, pproj)}
    )
    jwav, pwav = _wav(slice_setup, "float32")
    want, _ = _jax_encode_and_retrieve(
        jm, jparams, jwav, jnp.asarray(LENS), slice_setup["gallery"]
    )
    got = pm.encode_speech(pparams, {}, pwav, torch.from_numpy(LENS))["parallel_audio_feat"]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
