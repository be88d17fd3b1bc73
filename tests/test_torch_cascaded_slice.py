"""The cascaded slice end to end: the port's ``encode_speech`` + ``retrieve``
against the JAX package's ``encode_speech`` + f32 scores / top-k at tiny
dims with both branches live (``flagship_tiny_config()``), from ONE JAX
``init`` carried over by convert.from_jax (params and the kw-BN state, whose
running statistics are set away from the init's on both sides); also
``extract_hidden_states``, ``get_attention_weights`` and
``get_attention_map``.

Tolerances: f32 — the same keyword ids, the same top-10 (in order) over a
64-row gallery, and max abs diff <= 1e-4 on both branches' features. bf16 —
per-row cosine >= 0.999 on the rows whose keyword ids agree with JAX's, and
at least 90 % of the keyword ids agreeing (the VQ argmax is discontinuous:
the JAX XLA path rounds in other places, so a near-tie may flip).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speechclip_tpu.config import flagship_tiny_config
from speechclip_tpu.models.speechclip import SpeechCLIPModel as JaxModel
from speechclip_tpu_torch import retrieve
from speechclip_tpu_torch.convert.from_jax import (
    speechclip_params_from_jax,
    speechclip_state_from_jax,
)
from speechclip_tpu_torch.models.speechclip import SpeechCLIPModel, cast_params
from tests.test_torch_config import port_config_from_jax
from tests.test_torch_slice import GALLERY, LENS, TOPK, WAV_LEN, _row_cosine

torch.set_num_threads(2)

MIN_ID_AGREEMENT = 0.9


def jax_config(precision):
    cfg = flagship_tiny_config()
    cfg.trainer.precision = precision
    return cfg


@pytest.fixture(scope="module")
def setup():
    jm = JaxModel(jax_config(32))
    jparams, jstate = jax.jit(jm.init)(jax.random.key(0))
    rng = np.random.default_rng(7)
    bn = jstate["cascaded_branch"]["bn"]
    jstate = {"cascaded_branch": {"bn": {
        "mean": jnp.asarray(0.01 * rng.standard_normal(bn["mean"].shape), jnp.float32),
        "var": jnp.asarray(rng.uniform(0.5, 2.0, bn["var"].shape), jnp.float32)}}}
    wav = (rng.standard_normal((len(LENS), WAV_LEN)) * 0.1).astype(np.float32)
    wav *= np.arange(WAV_LEN)[None, :] < LENS[:, None]
    gallery = rng.standard_normal((GALLERY, 16)).astype(np.float32)
    gallery /= np.linalg.norm(gallery, axis=1, keepdims=True)
    return dict(jparams=jparams, jstate=jstate, wav=wav, gallery=gallery,
                pparams=speechclip_params_from_jax(jax.tree.map(np.asarray, jparams)),
                pstate=speechclip_state_from_jax(jax.tree.map(np.asarray, jstate)))


def _models(setup, precision):
    cfg = jax_config(precision)
    pm = SpeechCLIPModel(port_config_from_jax(cfg), device="cpu")
    cast = lambda t: cast_params(t, pm.compute_dtype, device="cpu")
    return JaxModel(cfg), pm, cast(setup["pparams"]), cast(setup["pstate"])


@pytest.mark.parametrize("precision", [32, 16])
def test_cascaded_encode_speech_and_retrieve_match_jax(setup, precision):
    jm, pm, pparams, pstate = _models(setup, precision)

    @jax.jit
    def run(p, s, w, l, g):
        out = jm.encode_speech(p, s, w, l)
        tops = [jax.lax.top_k(jnp.matmul(out[k], g.T, precision=jax.lax.Precision.HIGHEST),
                              TOPK)[1] for k in ("cascaded_audio_feat", "parallel_audio_feat")]
        return out, tops

    want, want_tops = run(setup["jparams"], setup["jstate"], jnp.asarray(setup["wav"]),
                          jnp.asarray(LENS), jnp.asarray(setup["gallery"]))
    got = pm.encode_speech(pparams, pstate, torch.from_numpy(setup["wav"]),
                           torch.from_numpy(LENS))
    gallery = torch.from_numpy(setup["gallery"])
    ids = got["vq_results"]["targets"][..., 0].numpy()
    want_ids = np.asarray(want["vq_results"]["targets"])[..., 0]
    assert got["keywords"].shape == (len(LENS), 4, 32)
    for key, want_top in zip(("cascaded_audio_feat", "parallel_audio_feat"), want_tops):
        feat = got[key]
        _, top = retrieve(feat, gallery, TOPK)
        assert feat.dtype == torch.float32 and feat.shape == (len(LENS), 16)
        assert torch.isfinite(feat).all()
        w = np.asarray(want[key])
        if precision == 32:
            np.testing.assert_array_equal(ids, want_ids)
            np.testing.assert_allclose(feat.numpy(), w, atol=1e-4, rtol=0)
            np.testing.assert_array_equal(top.numpy(), np.asarray(want_top))
        else:
            rows = (ids == want_ids).all(axis=1) if key == "cascaded_audio_feat" else slice(None)
            assert _row_cosine(feat.numpy()[rows], w[rows]).min() >= 0.999
    assert (ids == want_ids).mean() >= MIN_ID_AGREEMENT
    for key in ("code_perplexity", "prob_perplexity", "diversity_loss"):
        np.testing.assert_allclose(float(got["vq_results"][key]), float(want["vq_results"][key]),
                                   rtol=1e-3 if precision == 16 else 1e-5)


def test_extract_hidden_states_matches_jax(setup):
    jm, pm, pparams, _ = _models(setup, 32)
    want_last, want = jax.jit(jm.extract_hidden_states)(
        setup["jparams"], jnp.asarray(setup["wav"]), jnp.asarray(LENS))
    got_last, got = pm.extract_hidden_states(pparams, torch.from_numpy(setup["wav"]),
                                             torch.from_numpy(LENS))
    assert len(got) == len(want) == 3 + 1 + 1  # HuBERT 3, cascaded 1, parallel 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last), atol=1e-4, rtol=0)


def test_attention_weights_and_map_match_jax(setup):
    jm, pm, pparams, pstate = _models(setup, 32)
    wav, lens = setup["wav"], LENS
    want = jax.jit(jm.get_attention_weights)(setup["jparams"], jnp.asarray(wav), jnp.asarray(lens))
    got = pm.get_attention_weights(pparams, torch.from_numpy(wav), torch.from_numpy(lens))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    want_w, want_kw = jm.get_attention_map(setup["jparams"], setup["jstate"], jnp.asarray(wav),
                                           jnp.asarray(lens), top_k=5)
    got_w, got_kw = pm.get_attention_map(pparams, pstate, torch.from_numpy(wav),
                                         torch.from_numpy(lens), top_k=5)
    assert got_kw == want_kw
    assert len(got_w) == len(want_w) == len(lens)
    for g, w in zip(got_w, want_w):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5)
    special = {pm.sot_id, pm.eot_id, 0}
    assert not special & {i for utt in got_kw for kw in utt for i in kw}


def test_token_table_stays_f32_under_bf16():
    """The VQ scores keywords against the token table in f32, as the JAX
    model (whose params stay f32) does; a bf16-rounded table moved the
    scores by up to 4e-4 and flipped 0.46 % of keyword ids at the Flickr
    vocabulary's size (8112 x 512, CPU). The rest of the text tower stays
    f32 too (``forward_text`` runs in the table's dtype, as in JAX); its
    bf16 pass in the cascaded branch casts each weight where it is used."""
    cfg = port_config_from_jax(jax_config(16))
    pm = SpeechCLIPModel(cfg, device="cpu")
    params, _ = pm.init(0)
    p16 = cast_params(params, pm.compute_dtype, device="cpu")
    text = p16["clip"]["text"]
    assert pm.compute_dtype == torch.bfloat16
    assert text["token_embedding"].dtype == torch.float32
    assert text["positional_embedding"].dtype == torch.float32
    assert text["blocks"][0]["attn"]["in_proj"]["w"].dtype == torch.float32

