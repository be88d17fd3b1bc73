"""The port's whole slice — ``encode_speech`` + ``retrieve`` — against the
JAX package's ``encode_speech`` + f32 scores / top-k, at tiny dims, from ONE
``SpeechCLIPModel.init`` carried over by convert.from_jax; with precision 32
and 16, and with f32 and int16 (compact-transfer) waveforms. Also recall@k
and the rule that the port never imports jax. ``forward_audio``'s modes and
the optional branch projection are in tests/test_torch_forward_audio.py.

Tolerances: f32 — max abs diff <= 1e-4 on the features and the identical
top-10 (in order) over a 64-row gallery. bf16 — per-row cosine >= 0.999
(the JAX XLA path rounds in other places than the port's plain layers).
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speechclip_tpu.config import flagship_tiny_config
from speechclip_tpu.models.speechclip import SpeechCLIPModel as JaxModel
from speechclip_tpu.ops.retrieval import recall_at_k as jax_recall_at_k
from speechclip_tpu_torch import recall_at_k, retrieve
from speechclip_tpu_torch.convert.from_jax import speechclip_params_from_jax
from speechclip_tpu_torch.models.speechclip import SpeechCLIPModel, cast_params
from tests.test_torch_config import parallel_only, port_config_from_jax

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAV_LEN = 1200
LENS = np.array([1200, 1000, 613, 333], np.int32)
GALLERY = 64
TOPK = 10


def jax_config(precision, **audio_encoder):
    cfg = parallel_only(flagship_tiny_config())
    cfg.trainer.precision = precision
    for k, v in audio_encoder.items():
        setattr(cfg.audio_encoder, k, v)
    return cfg


@pytest.fixture(scope="module")
def slice_setup():
    jm = JaxModel(jax_config(32))
    jparams, _ = jax.jit(jm.init)(jax.random.key(0))
    pparams32 = speechclip_params_from_jax(jax.tree.map(np.asarray, jparams))
    rng = np.random.default_rng(0)
    pcm = (rng.standard_normal((len(LENS), WAV_LEN)) * 3000).astype(np.int16)
    pcm *= (np.arange(WAV_LEN)[None, :] < LENS[:, None]).astype(np.int16)
    gallery = rng.standard_normal((GALLERY, 16)).astype(np.float32)
    gallery /= np.linalg.norm(gallery, axis=1, keepdims=True)
    return dict(jparams=jparams, pparams32=pparams32, pcm=pcm, gallery=gallery)


def _wav(setup, wav_kind):
    if wav_kind == "int16":
        return jnp.asarray(setup["pcm"]), torch.from_numpy(setup["pcm"])
    wav = setup["pcm"].astype(np.float32) / 32768.0
    return jnp.asarray(wav), torch.from_numpy(wav)


def _models(setup, cfg, extra_params=None):
    jm = JaxModel(cfg)
    pm = SpeechCLIPModel(port_config_from_jax(cfg), device="cpu")
    jparams, pparams = dict(setup["jparams"]), dict(setup["pparams32"])
    for k, (jv, pv) in (extra_params or {}).items():
        jparams[k], pparams[k] = jv, pv
    return jm, jparams, pm, cast_params(pparams, pm.compute_dtype, device="cpu")


def _jax_encode_and_retrieve(jm, jparams, wav, lens, gallery):
    @jax.jit
    def run(p, w, l, g):
        feat = jm.encode_speech(p, {}, w, l)["parallel_audio_feat"]
        scores = jnp.matmul(feat, g.T, precision=jax.lax.Precision.HIGHEST)
        return feat, jax.lax.top_k(scores, TOPK)[1]

    feat, top = run(jparams, wav, lens, jnp.asarray(gallery))
    return np.asarray(feat), np.asarray(top)


def _row_cosine(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.mark.parametrize("wav_kind", ["float32", "int16"])
@pytest.mark.parametrize("precision", [32, 16])
def test_encode_speech_and_retrieve_match_jax(slice_setup, precision, wav_kind):
    jm, jparams, pm, pparams = _models(slice_setup, jax_config(precision))
    jwav, pwav = _wav(slice_setup, wav_kind)
    want_feat, want_top = _jax_encode_and_retrieve(
        jm, jparams, jwav, jnp.asarray(LENS), slice_setup["gallery"]
    )
    feat = pm.encode_speech(pparams, {}, pwav, torch.from_numpy(LENS))["parallel_audio_feat"]
    _, top = retrieve(feat, torch.from_numpy(slice_setup["gallery"]), TOPK)
    assert feat.dtype == torch.float32 and feat.shape == want_feat.shape
    assert torch.isfinite(feat).all()
    if precision == 32:
        np.testing.assert_allclose(feat.numpy(), want_feat, atol=1e-4, rtol=0)
        np.testing.assert_array_equal(top.numpy(), want_top)
    else:
        assert _row_cosine(feat.numpy(), want_feat).min() >= 0.999


def test_int16_wav_is_the_exact_rescale(slice_setup):
    """int16 PCM / 32768 in f32 equals the f32 wav bit for bit, so both
    wavs give identical features."""
    _, _, pm, pparams = _models(slice_setup, jax_config(32))
    lens = torch.from_numpy(LENS)
    feats = [
        pm.encode_speech(pparams, {}, _wav(slice_setup, kind)[1], lens)["parallel_audio_feat"]
        for kind in ("int16", "float32")
    ]
    torch.testing.assert_close(feats[0], feats[1], rtol=0, atol=0)


def test_recall_at_k_matches_jax():
    rng = np.random.default_rng(6)
    scores = rng.standard_normal((20, 30)).astype(np.float32)
    gold = rng.integers(0, 30, 20).astype(np.int32)
    cand = np.arange(30, dtype=np.int32)
    want = jax_recall_at_k(jnp.asarray(scores), jnp.asarray(gold), jnp.asarray(cand), [1, 5, 10])
    got = recall_at_k(torch.from_numpy(scores), torch.from_numpy(gold),
                      torch.from_numpy(cand), [1, 5, 10])
    assert got == pytest.approx(want)


def test_port_imports_no_jax_yaml_or_reference_package():
    """The port runs without jax, yaml, speechclip_tpu or PIL (the card's
    machine has no PyYAML and no PIL): both branches, the conv chain, the
    shipped cascaded config's vocabulary table, the gallery side
    (``forward_image`` on uint8 images) and the eval module. A subprocess:
    this test process has imported jax."""
    code = textwrap.dedent(
        """
        import sys
        import torch
        import speechclip_tpu_torch as port
        from speechclip_tpu_torch.models.speechclip import cast_params
        from speechclip_tpu_torch.kernels import _build, fused_layer  # noqa: F401
        from speechclip_tpu_torch.convert import from_jax  # noqa: F401
        from speechclip_tpu_torch.kernels import conv_frontend, flash_attention  # noqa: F401
        from speechclip_tpu_torch.models import branches, clip  # noqa: F401
        from speechclip_tpu_torch.ops import kw_bn, vq  # noqa: F401
        from speechclip_tpu_torch.data import image  # noqa: F401
        from speechclip_tpu_torch.training import evaluation

        torch.set_num_threads(1)
        model = port.SpeechCLIPModel(port.tiny_flagship_config(), device="cpu")
        params, state = model.init(0)
        params, state = (cast_params(t, model.compute_dtype, device="cpu") for t in (params, state))
        wav = torch.randn(2, 800)
        out = model.encode_speech(params, state, wav, torch.tensor([800, 500]))
        gallery = torch.nn.functional.normalize(torch.randn(8, 16), dim=-1)
        for key in ("parallel_audio_feat", "cascaded_audio_feat"):
            feat = out[key]
            _, top = port.retrieve(feat, gallery, 3)
            assert feat.shape == (2, 16) and top.shape == (2, 3)
            assert bool(torch.isfinite(feat).all())
        x = torch.randn(1, 40, 8)
        conv_frontend.fused_conv_chain(x, [torch.randn(3, 8, 8)], (3,))
        port.SpeechCLIPModel(port.shipped_cascaded_config(), device="cpu")
        images = torch.randint(0, 256, (2, 40, 36, 3), dtype=torch.uint8)
        img = model.forward_image(params, images)
        assert img.shape == (2, 16) and bool(torch.isfinite(img).all())
        collected = evaluation.collect_validation_outputs([{
            "id": torch.tensor([0, 1]), "audio_feat": out["parallel_audio_feat"],
            "image_feat": torch.nn.functional.normalize(img.float(), dim=-1)}])
        evaluation.retrieval_metrics(collected, (1,), device="cpu")
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "yaml", "speechclip_tpu", "PIL"))
        assert not bad, bad
        print("OK")
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_seeded_port_init_is_reproducible():
    pm = SpeechCLIPModel(port_config_from_jax(flagship_tiny_config()), device="cpu")
    a = pm.init(3)
    b = pm.init(3)
    leaves_a, leaves_b = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(leaves_a) == len(leaves_b)
    assert all(torch.equal(x, y) for x, y in zip(leaves_a, leaves_b))
