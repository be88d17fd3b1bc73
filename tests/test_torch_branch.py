"""The port's parallel branch, weighted sum, MLP and basic ops against the
JAX package at tiny dims (``flagship_tiny_config()``'s branch: d_model 32,
4 heads, FFN 64, projection 32 -> 16), JAX params carried over by
convert.from_jax.

Tolerances: f32 — max abs diff <= 1e-4 (same math, another summation
order). bf16 — per-row cosine >= 0.999 (the JAX XLA path rounds biases and
attention logits in bf16 where the port's plain layer keeps f32).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speechclip_tpu.config import flagship_tiny_config
from speechclip_tpu.models import branches as jb
from speechclip_tpu.ops import basic as jbasic
from speechclip_tpu.ops import mlp as jmlp
from speechclip_tpu.ops import transformer as jtr
from speechclip_tpu.ops import weighted_sum as jws
from speechclip_tpu_torch.convert.from_jax import speechclip_params_from_jax
from speechclip_tpu_torch.models import branches as pb
from speechclip_tpu_torch.models.speechclip import cast_params
from speechclip_tpu_torch.ops import basic as pbasic
from speechclip_tpu_torch.ops import mlp as pmlp
from speechclip_tpu_torch.ops import transformer as ptr
from speechclip_tpu_torch.ops import weighted_sum as pws
from tests.test_torch_config import parallel_only, port_config_from_jax
from tests.test_torch_hubert import DTYPES, assert_match

torch.set_num_threads(2)

T = 37
LENS = np.array([37, 20, 1], np.int32)


@pytest.fixture(scope="module")
def branch():
    cfg = parallel_only(flagship_tiny_config())
    bcfg = cfg.model_settings.parallel_branch
    jparams = jax.jit(lambda k: jb.parallel_branch_init(k, bcfg, 32, 16))(
        jax.random.key(1)
    )
    pparams = speechclip_params_from_jax(
        {"parallel_branch": jax.tree.map(np.asarray, jparams)}
    )["parallel_branch"]
    rng = np.random.default_rng(1)
    feat = rng.standard_normal((3, T, 32)).astype(np.float32)
    return dict(
        jcfg=bcfg, pcfg=port_config_from_jax(cfg).parallel_branch,
        jparams=jparams, pparams={dt: cast_params(pparams, dt, device="cpu") for dt in DTYPES},
        feat=feat,
    )


def _jdt(dtype):
    return jnp.float32 if dtype == torch.float32 else jnp.bfloat16


@pytest.mark.parametrize("dtype", DTYPES)
def test_parallel_branch_apply(branch, dtype):
    want = jax.jit(lambda p, f, l: jb.parallel_branch_apply(p, branch["jcfg"], f, l))(
        branch["jparams"], jnp.asarray(branch["feat"]).astype(_jdt(dtype)),
        jnp.asarray(LENS),
    )
    got = pb.parallel_branch_apply(
        branch["pparams"][dtype], branch["pcfg"],
        torch.from_numpy(branch["feat"]).to(dtype), torch.from_numpy(LENS),
    )
    assert got.shape == (3, 16) and got.dtype == dtype
    assert_match(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_transformer_encoder_apply(branch, dtype):
    """The branch body alone, CLS already prepended, lengths + 1."""
    ta = branch["jcfg"].transformer_args
    feat = branch["feat"]
    want = jax.jit(
        lambda p, x, l: jtr.transformer_encoder_apply(
            p, x, nhead=ta.nhead, key_valid_lens=l,
            key_padding_mask=jnp.arange(T)[None, :] >= l[:, None],
        )[0]
    )(branch["jparams"]["transformer"], jnp.asarray(feat).astype(_jdt(dtype)),
      jnp.asarray(LENS))
    got = ptr.transformer_encoder_apply(
        branch["pparams"][dtype]["transformer"], torch.from_numpy(feat).to(dtype),
        nhead=ta.nhead, key_valid_lens=torch.from_numpy(LENS),
    )
    assert_match(got, want, dtype)


def test_prepend_cls(branch):
    p = branch["pparams"][torch.float32]
    src = pb._prepend_cls(p, torch.from_numpy(branch["feat"]))
    assert src.shape == (3, T + 1, 32)
    np.testing.assert_array_equal(src[:, 0].numpy(), np.broadcast_to(p["cls"][0].numpy(), (3, 32)))
    np.testing.assert_array_equal(src[:, 1:].numpy(), branch["feat"])


def _states(dtype, n=5, seed=2):
    rng = np.random.default_rng(seed)
    states = [rng.standard_normal((2, 7, 16)).astype(np.float32) for _ in range(n)]
    logits = rng.standard_normal(n).astype(np.float32)
    jdt = _jdt(dtype)
    return (
        {"weights": jnp.asarray(logits)}, tuple(jnp.asarray(s).astype(jdt) for s in states),
        {"weights": torch.from_numpy(logits)}, tuple(torch.from_numpy(s).to(dtype) for s in states),
    )


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", ["chain", "stacked", "normalized"])
def test_weighted_sum(dtype, form):
    jp, jstates, pp, pstates = _states(dtype)
    if form == "stacked":
        jstates, pstates = jnp.stack(jstates), torch.stack(pstates)
    norm = form == "normalized"
    want = jws.weighted_sum_apply(jp, jstates, normalize_features=norm)
    got = pws.weighted_sum_apply(pp, pstates, normalize_features=norm)
    assert got.dtype == dtype
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    else:  # same rounding points: at most one bf16 ulp apart
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)), rtol=2.0**-7,
            atol=2.0**-7,
        )


def test_mlp_apply_eval():
    jparams = jmlp.mlp_init(jax.random.key(3), [16, 32, 8])
    pparams = speechclip_params_from_jax(
        {"p_branch_proj": jax.tree.map(np.asarray, jparams)}
    )["p_branch_proj"]
    x = np.random.default_rng(3).standard_normal((4, 16)).astype(np.float32)
    want = jmlp.mlp_apply(jparams, jnp.asarray(x), train=False)
    got = pmlp.mlp_apply(pparams, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_basic_ops(dtype):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 24)).astype(np.float32)
    w = rng.standard_normal((24, 8)).astype(np.float32)
    b = rng.standard_normal(8).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(24)).astype(np.float32)
    jx, px = jnp.asarray(x).astype(_jdt(dtype)), torch.from_numpy(x).to(dtype)
    pairs = [
        (pbasic.linear({"w": torch.from_numpy(w), "b": torch.from_numpy(b)}, px),
         jbasic.linear({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jx)),
        (pbasic.layer_norm({"scale": torch.from_numpy(g), "bias": torch.zeros(24)}, px),
         jbasic.layer_norm({"scale": jnp.asarray(g), "bias": jnp.zeros(24)}, jx)),
        (pbasic.layer_norm(None, px), jbasic.layer_norm(None, jx)),
        (pbasic.l2_normalize(px), jbasic.l2_normalize(jx)),
    ]
    for got, want in pairs:
        assert got.dtype == dtype
        assert_match(got, want, dtype)
