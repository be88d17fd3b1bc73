"""The port's HuBERT encoder and masking helpers against the JAX package at
tiny dims (``flagship_tiny_config()``, cascaded weight 0), one JAX init
carried over by convert.from_jax.

Off the TPU the JAX model runs its XLA path (kernels/fused_layer.py gates
the Pallas kernels to the TPU), so this holds the port's plain layer math
against JAX's XLA math.

Tolerances: f32 — max abs diff <= 1e-4 (same math, f32 accumulation in
another order). bf16 — per-row cosine >= 0.999: the JAX XLA path rounds in
other places (bias added in bf16, bf16 attention logits), each a relative
error of order 2^-8 per element.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speechclip_tpu.config import flagship_tiny_config
from speechclip_tpu.models import hubert as jh
from speechclip_tpu.ops import masking as jmask
from speechclip_tpu.models.speechclip import SpeechCLIPModel as JaxModel
from speechclip_tpu_torch.convert.from_jax import speechclip_params_from_jax
from speechclip_tpu_torch.models import hubert as ph
from speechclip_tpu_torch.models.speechclip import cast_params
from speechclip_tpu_torch.ops import masking as pmask
from tests.test_torch_config import parallel_only, port_config_from_jax

torch.set_num_threads(2)

F32_ATOL = 1e-4
MIN_COSINE = 0.999
WAV_LEN = 1200
LENS = np.array([1200, 910, 477], np.int32)
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(scope="module")
def towers():
    """The tiny HuBERT's JAX params (one jitted init) and the port's copy."""
    jm = JaxModel(parallel_only(flagship_tiny_config()))
    jae = jax.jit(lambda k: jh.hubert_init(k, jm.audio_cfg))(jax.random.key(0))
    pae = speechclip_params_from_jax(
        {"audio_encoder": jax.tree.map(np.asarray, jae)}
    )["audio_encoder"]
    rng = np.random.default_rng(0)
    wav = (0.1 * rng.standard_normal((3, WAV_LEN))).astype(np.float32)
    wav *= np.arange(WAV_LEN)[None, :] < LENS[:, None]
    return dict(
        jcfg=jm.audio_cfg, pcfg=port_config_from_jax(jm.config).audio, jae=jae,
        pae={dt: cast_params(pae, dt, device="cpu") for dt in DTYPES},
        wav=wav,
    )


def _inputs(towers, dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return (
        jnp.asarray(towers["wav"]).astype(jdt), jnp.asarray(LENS),
        torch.from_numpy(towers["wav"]).to(dtype), torch.from_numpy(LENS),
    )


def assert_match(got: torch.Tensor, want, dtype):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
        return
    a, b = got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-12)
    assert cos.min() >= MIN_COSINE, cos.min()

def test_masking_helpers_match_jax():
    lens = np.array([0, 1, 330, 350, 999, 2000, 5000], np.int32)
    for fn in ("key_padding_mask", "valid_mask"):
        np.testing.assert_array_equal(
            getattr(pmask, fn)(torch.from_numpy(lens), 2048).numpy(),
            np.asarray(getattr(jmask, fn)(jnp.asarray(lens), 2048)),
        )
    # 330 / 20 = 16.5 and 350 / 20 = 17.5: round half to even on both sides
    np.testing.assert_array_equal(
        pmask.hubert_feature_lengths(torch.from_numpy(lens), 20, 99).numpy(),
        np.asarray(jmask.hubert_feature_lengths(jnp.asarray(lens), 20, 99)),
    )
    np.testing.assert_array_equal(
        pmask.conv_frame_valid_lengths(torch.from_numpy(lens), 2000, 99).numpy(),
        np.asarray(jmask.conv_frame_valid_lengths(jnp.asarray(lens), 2000, 99)),
    )


def test_conv_output_length_main_path_is_319():
    assert ph.conv_output_length(ph.HUBERT_BASE, 102400) == 319
    assert jh.conv_output_length(jh.HUBERT_BASE, 102400) == 319


@pytest.mark.parametrize("dtype", DTYPES)
def test_conv_chain(towers, dtype):
    jw, _, pw, _ = _inputs(towers, dtype)
    want = jax.jit(jh._conv_chain, static_argnums=1)(
        towers["jae"]["feature_extractor"], towers["jcfg"], jw
    )
    got = ph._conv_chain(towers["pae"][dtype]["feature_extractor"], towers["pcfg"], pw)
    assert got.dtype == dtype
    assert_match(got, want, dtype)


def test_conv_batch_chunk_is_exact(towers):
    _, _, pw, _ = _inputs(towers, torch.float32)
    convs = towers["pae"][torch.float32]["feature_extractor"]
    chunked = dataclasses.replace(towers["pcfg"], conv_batch_chunk=2)
    torch.testing.assert_close(
        ph.conv_feature_extractor(convs, chunked, pw),
        ph.conv_feature_extractor(convs, towers["pcfg"], pw),
        rtol=0, atol=1e-6,
    )


@pytest.mark.parametrize("dtype", DTYPES)
def test_encoder_prelude(towers, dtype):
    jw, jl, pw, pl_ = _inputs(towers, dtype)
    jx, _, jframes = jax.jit(jh._encoder_prelude, static_argnums=1)(
        towers["jae"], towers["jcfg"], jw, jl
    )
    px, pframes = ph._encoder_prelude(towers["pae"][dtype], towers["pcfg"], pw, pl_)
    np.testing.assert_array_equal(pframes.numpy(), np.asarray(jframes))
    assert_match(px, jx, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_hubert_apply_every_state_and_lengths(towers, dtype):
    jw, jl, pw, pl_ = _inputs(towers, dtype)
    jstates, jlens = jax.jit(jh.hubert_apply, static_argnums=1)(
        towers["jae"], towers["jcfg"], jw, jl
    )
    pstates, plens = ph.hubert_apply(towers["pae"][dtype], towers["pcfg"], pw, pl_)
    assert len(pstates) == len(jstates) == towers["pcfg"].num_hidden_states
    np.testing.assert_array_equal(plens.numpy(), np.asarray(jlens))
    for p, j in zip(pstates, jstates):
        assert_match(p, j, dtype)


@pytest.mark.parametrize("method", ["method1", "method2"])
def test_normalize_hidden_states(method):
    rng = np.random.default_rng(4)
    states = [rng.standard_normal((2, 5, 8)).astype(np.float32) for _ in range(3)]
    want = jh.normalize_hidden_states(tuple(jnp.asarray(s) for s in states), method)
    got = ph.normalize_hidden_states(tuple(torch.from_numpy(s) for s in states), method)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


def test_port_seeded_init_runs_the_encoder():
    """The port's own init (explicit generator) gives finite states of the
    right shapes, and the same seed gives the same params."""
    cfg = ph.HubertConfig(
        conv_layers=((16, 10, 5), (16, 3, 2)), encoder_embed_dim=32,
        encoder_layers=1, encoder_ffn_dim=64, encoder_heads=4,
        downsample_rate=10,
    )
    a = ph.hubert_init(torch.Generator().manual_seed(7), cfg)
    b = ph.hubert_init(torch.Generator().manual_seed(7), cfg)
    torch.testing.assert_close(a["encoder"]["layers"][0]["fc1"]["w"],
                               b["encoder"]["layers"][0]["fc1"]["w"], rtol=0, atol=0)
    states, lens = ph.hubert_apply(a, cfg, torch.randn(2, 500), torch.tensor([500, 300]))
    t = ph.conv_output_length(cfg, 500)
    assert [tuple(s.shape) for s in states] == [(2, t, 32)] * 2
    assert all(torch.isfinite(s).all() for s in states)
    assert lens.tolist() == [min(50, t), 30]
    assert jax.tree.leaves(a)  # a plain nested dict of tensors
