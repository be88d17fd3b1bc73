"""The port's plain ``ffn_block`` against the JAX Pallas kernel in interpret
mode on the CPU, at real widths (D = 768, F = 3072), B = 2, T in {64, 67},
in the three LayerNorm modes and in f32 and bf16.

Tolerances: f32 — max abs diff <= 1e-4 (erf GELU on both sides; only the
summation order differs). bf16 — per-row cosine >= 0.999 and max abs diff
<= 0.0625 (tanh GELU on both sides; an intermediate bf16 rounding can flip,
2 ulp at |y| ~ 4 after LayerNorm).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speechclip_tpu.kernels.ffn_block import ffn_block as jax_ffn_block
from speechclip_tpu_torch.kernels.ffn_block import ffn_block, ffn_block_plain
from speechclip_tpu_torch.ops.basic import gelu
from tests.test_torch_mha_block import assert_close

torch.set_num_threads(2)

D, F = 768, 3072


def make_inputs(t, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, t, D)).astype(np.float32)
    mk = lambda *s: (rng.standard_normal(s) * s[0] ** -0.5).astype(np.float32)
    w = dict(
        w1=mk(D, F), b1=0.1 * mk(F), w2=mk(F, D), b2=0.1 * mk(D),
        ln_g=(1 + 0.1 * rng.standard_normal(D)).astype(np.float32),
        ln_b=(0.1 * rng.standard_normal(D)).astype(np.float32),
    )
    return x, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["post", "pre", "none"])
@pytest.mark.parametrize("t", [64, 67])
def test_plain_matches_jax_kernel(dtype, mode, t):
    x, w = make_inputs(t, seed=t)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    want = jax_ffn_block(
        jnp.asarray(x).astype(jdt),
        *(jnp.asarray(w[k]) for k in ("w1", "b1", "w2", "b2", "ln_g", "ln_b")),
        mode, 1e-5,
    )
    want = np.asarray(want.astype(jnp.float32))
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    for k in ("w1", "w2"):
        tw[k] = tw[k].to(tdt)
    got = ffn_block(
        torch.from_numpy(x).to(tdt), tw["w1"], tw["b1"], tw["w2"], tw["b2"],
        tw["ln_g"], tw["ln_b"], mode, 1e-5,
    )
    assert got.dtype == tdt and got.shape == x.shape
    assert_close(got, want, dtype)


def test_cpu_wrapper_takes_plain_path_without_counting():
    x, w = make_inputs(8, seed=1)
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    args = (torch.from_numpy(x), tw["w1"], tw["b1"], tw["w2"], tw["b2"],
            tw["ln_g"], tw["ln_b"], "post", 1e-5)
    before = ffn_block.launches
    torch.testing.assert_close(ffn_block(*args), ffn_block_plain(*args), rtol=0, atol=0)
    assert ffn_block.launches == before


def test_bad_ln_mode_raises():
    x, w = make_inputs(8, seed=2)
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    with pytest.raises(ValueError, match="ln_mode"):
        ffn_block(torch.from_numpy(x), tw["w1"], tw["b1"], tw["w2"], tw["b2"],
                  tw["ln_g"], tw["ln_b"], "sandwich", 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_is_tanh_for_bf16_and_erf_for_f32(dtype):
    """The parity contract of speechclip_tpu/ops/basic.py:22-36."""
    from speechclip_tpu.ops.basic import gelu as jax_gelu

    x = np.linspace(-4, 4, 257).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = np.asarray(jax_gelu(jnp.asarray(x).astype(jdt)).astype(jnp.float32))
    got = gelu(torch.from_numpy(x).to(getattr(torch, dtype))).float().numpy()
    # f32: erf on both sides to f32 rounding; bf16: tanh on both, <= 1 ulp
    atol = 1e-6 if dtype == "float32" else 2.0**-7 * 4
    np.testing.assert_allclose(got, want, atol=atol)
