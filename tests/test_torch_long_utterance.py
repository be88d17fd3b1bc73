"""The slice's length-dependent routes end to end: ``encode_speech`` of the
port against the JAX package's, from one JAX init carried over by
convert.from_jax, at full layer width — HuBERT D = 768 with 12 heads and FFN
3072 (one layer), the parallel branch D = 768 with 8 heads and FFN 3072 (one
layer) — with a narrow conv frontend (16 channels, the base strides, so
320 samples per frame) and a 16-tap positional conv to keep the CPU time
down; B = 2.

- 272000 samples (17 s): HuBERT T = 849, branch T = 850. The fused gates
  fail, so both layers run unfused with ``attention_vmem``.
- 192000 samples (12 s): T = 599 / 600. ``mha_layer_block`` + the torch FFN
  chain (``ffn_eligible`` fails).
- Backend "pallas", 102400 samples (6.4 s): T = 319 / 320. Every layer
  unfused, every attention through ``flash_attention``.

The JAX side runs as on one TPU (``_on_tpu`` monkeypatched, a one-device
kernel mesh): its Pallas kernels in interpret mode. Spies on both sides show
that each took the same kernels, once per layer.

Tolerances (those of the other slice tests): f32 — max abs diff <= 1e-4 on
the L2-normalized features; bf16 — per-row cosine >= 0.999.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speechclip_tpu.config import flagship_tiny_config
from speechclip_tpu.kernels import attention_vmem as jav
from speechclip_tpu.kernels import ffn_block as jffn
from speechclip_tpu.kernels import flash_attention as jfa
from speechclip_tpu.kernels import mha_block as jmb
from speechclip_tpu.models.speechclip import SpeechCLIPModel as JaxModel
from speechclip_tpu.ops import attention as jattn
from speechclip_tpu_torch.convert.from_jax import speechclip_params_from_jax
from speechclip_tpu_torch.kernels import fused_layer as pfused
from speechclip_tpu_torch.models.speechclip import SpeechCLIPModel, cast_params
from speechclip_tpu_torch.ops import attention as pattn
from tests.test_torch_config import parallel_only, port_config_from_jax

torch.set_num_threads(2)

CONV16 = [[16, 10, 5], [16, 3, 2], [16, 3, 2], [16, 3, 2], [16, 3, 2], [16, 2, 2], [16, 2, 2]]
SCENARIOS = {  # samples, backend, kernels each side calls (one per layer)
    "vmem_t849": (272000, "auto", ["attention_vmem"] * 2),
    "mha_t599": (192000, "auto", ["mha_layer_block"] * 2),
    "flash_t319": (102400, "pallas", ["flash_attention"] * 2),
}


def jax_config(precision):
    cfg = parallel_only(flagship_tiny_config())
    cfg.trainer.precision = precision
    custom = cfg.audio_encoder.custom
    custom.conv_layers = CONV16
    custom.encoder_embed_dim = 768
    custom.encoder_layers = 1
    custom.encoder_ffn_dim = 3072
    custom.encoder_heads = 12
    custom.downsample_rate = 320
    custom.pos_conv_kernel = 16
    ta = cfg.model_settings.parallel_branch.transformer_args
    ta.d_model, ta.nhead, ta.dim_feedforward, ta.n_layers = 768, 8, 3072, 1
    return cfg


@pytest.fixture(scope="module")
def jparams():
    jm = JaxModel(jax_config(32))
    params, _ = jax.jit(jm.init)(jax.random.key(0))
    return params


@pytest.fixture
def spies(monkeypatch):
    """JAX as on one TPU; (JAX calls, port calls) of the attention kernels
    and of the FFN kernel."""
    calls = {"jax": [], "port": []}

    def spy(mod, name, side):
        real = getattr(mod, name)
        monkeypatch.setattr(
            mod, name, lambda *a, _r=real, **k: calls[side].append(name) or _r(*a, **k)
        )

    for mod, name in ((jmb, "mha_layer_block"), (jav, "attention_vmem"),
                      (jfa, "flash_attention"), (jffn, "ffn_block")):
        spy(mod, name, "jax")
    for name in ("mha_layer_block", "ffn_block"):
        spy(pfused, name, "port")
    for name in ("attention_vmem", "flash_attention"):
        spy(pattn, name, "port")
    monkeypatch.setattr(jattn, "_on_tpu", lambda: True)
    with jattn.kernel_mesh(jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))):
        yield calls


def wavs(samples):
    rng = np.random.default_rng(samples)
    lens = np.array([samples, samples - 9000], np.int32)
    wav = (0.1 * rng.standard_normal((2, samples))).astype(np.float32)
    wav *= np.arange(samples)[None, :] < lens[:, None]
    return wav, lens


@pytest.mark.parametrize("precision", [16, 32])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_encode_speech_matches_jax_on_the_route(jparams, spies, scenario, precision):
    samples, backend, kernels = SCENARIOS[scenario]
    cfg = jax_config(precision)
    jm, pm = JaxModel(cfg), SpeechCLIPModel(port_config_from_jax(cfg), device="cpu")
    assert pm.audio_cfg.encoder_embed_dim == 768 and pm.config.parallel_branch.nhead == 8
    pparams = cast_params(speechclip_params_from_jax(jax.tree.map(np.asarray, jparams)),
                          pm.compute_dtype, device="cpu")
    wav, lens = wavs(samples)
    with jattn.attention_backend(backend):
        want = jax.jit(lambda p, w, l: jm.encode_speech(p, {}, w, l)["parallel_audio_feat"])(
            jparams, jnp.asarray(wav), jnp.asarray(lens))
    with pattn.attention_backend(backend):
        got = pm.encode_speech(pparams, {}, torch.from_numpy(wav), torch.from_numpy(lens))
    got = got["parallel_audio_feat"].numpy()
    want = np.asarray(want)
    if precision == 16:
        assert spies["jax"] == spies["port"] == kernels
    else:  # f32: the fused layer is bf16-only; the unfused dispatcher decides
        assert spies["jax"] == spies["port"] and len(spies["port"]) == 2
    assert got.shape == want.shape and np.isfinite(got).all()
    if precision == 32:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    else:
        cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
        assert cos.min() >= 0.999, cos
