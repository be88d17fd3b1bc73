"""The port's plain ``mha_layer_block`` against the JAX Pallas kernel, run in
interpret mode on the CPU (as tests/test_kernels.py runs it), at real
widths: D = 768 with H = 12 (Dh = 64, HuBERT-base) and H = 8 (Dh = 96, the
parallel branch); B = 2, T in {64, 67}, with and without key lengths, in the
three LayerNorm modes and in f32 (here) and bf16
(tests/test_torch_mha_block_bf16.py).

Tolerances: f32 — max abs diff <= 1e-4 (same math in f32; only summation
order differs). bf16 — per-row cosine >= 0.999 and max abs diff <= 0.0625:
the rounding points are the same, but a different summation order can flip
an intermediate bf16 rounding (1 ulp = 2^-8 relative), and outputs after
LayerNorm reach |y| ~ 4, where 2 ulp = 0.0625.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speechclip_tpu.kernels.mha_block import mha_layer_block as jax_mha_layer_block
from speechclip_tpu_torch.kernels import _build
from speechclip_tpu_torch.kernels.mha_block import (
    mha_layer_block,
    mha_layer_block_plain,
)
from speechclip_tpu_torch.kernels.fused_layer import fused_encoder_layer

torch.set_num_threads(2)

D = 768
F32_ATOL = 1e-4
BF16_ATOL = 0.0625
MIN_COSINE = 0.999


def make_inputs(t, seed, with_lens):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, t, D)).astype(np.float32)
    mk = lambda *s: (rng.standard_normal(s) * s[0] ** -0.5).astype(np.float32)
    w = dict(
        w_in=mk(D, 3 * D), b_in=0.1 * mk(3 * D), w_out=mk(D, D), b_out=0.1 * mk(D),
        ln_g=(1 + 0.1 * rng.standard_normal(D)).astype(np.float32),
        ln_b=(0.1 * rng.standard_normal(D)).astype(np.float32),
    )
    lens = np.array([t, t // 2 + 1], np.int32) if with_lens else None
    return x, w, lens


def assert_close(got: torch.Tensor, want: np.ndarray, dtype):
    got = got.float().numpy()
    err = np.abs(got - want).max()
    if dtype == "float32":
        assert err <= F32_ATOL, err
        return
    a, b = got.reshape(-1, D), want.reshape(-1, D)
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    assert cos.min() >= MIN_COSINE, cos.min()
    assert err <= BF16_ATOL, err


# Every mode runs both head layouts; T and lens alternate so that each head
# layout meets both T values and both mask settings. The bf16 cases live in
# tests/test_torch_mha_block_bf16.py (one file per dtype keeps each short).
def cases(dtype):
    out = [
        (dtype, mode, heads, t, with_lens)
        for mode in ("post", "pre", "none")
        for heads, t, with_lens in ((12, 67, True), (8, 64, False))
    ]
    if dtype == "bfloat16":  # the main path's mode, with the other pairings
        out += [(dtype, "post", 12, 64, False), (dtype, "post", 8, 67, True)]
    return out


def check_against_jax(dtype, mode, heads, t, with_lens):
    x, w, lens = make_inputs(t, seed=heads * 100 + t, with_lens=with_lens)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    want = jax_mha_layer_block(
        jnp.asarray(x).astype(jdt),
        *(jnp.asarray(w[k]) for k in ("w_in", "b_in", "w_out", "b_out", "ln_g", "ln_b")),
        None if lens is None else jnp.asarray(lens),
        heads, mode, 1e-5,
    )
    want = np.asarray(want.astype(jnp.float32))
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    for k in ("w_in", "w_out"):
        tw[k] = tw[k].to(tdt)
    got = mha_layer_block(
        torch.from_numpy(x).to(tdt), tw["w_in"], tw["b_in"], tw["w_out"],
        tw["b_out"], tw["ln_g"], tw["ln_b"],
        None if lens is None else torch.from_numpy(lens), heads, mode, 1e-5,
    )
    assert got.dtype == tdt and got.shape == x.shape
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype, mode, heads, t, with_lens", cases("float32"))
def test_plain_matches_jax_kernel(dtype, mode, heads, t, with_lens):
    check_against_jax(dtype, mode, heads, t, with_lens)


def test_cpu_wrapper_takes_plain_path_without_counting():
    x, w, lens = make_inputs(16, seed=0, with_lens=True)
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    args = (torch.from_numpy(x), tw["w_in"], tw["b_in"], tw["w_out"], tw["b_out"],
            tw["ln_g"], tw["ln_b"], torch.from_numpy(lens), 12, "post", 1e-5)
    before = mha_layer_block.launches
    torch.testing.assert_close(mha_layer_block(*args), mha_layer_block_plain(*args),
                               rtol=0, atol=0)
    assert mha_layer_block.launches == before


def test_fully_masked_rows_stay_finite():
    """lens = 0: finfo.min masking makes the row a uniform average, not NaN
    (the reference's convention)."""
    x, w, _ = make_inputs(16, seed=3, with_lens=False)
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    out = mha_layer_block_plain(
        torch.from_numpy(x), tw["w_in"], tw["b_in"], tw["w_out"], tw["b_out"],
        tw["ln_g"], tw["ln_b"], torch.tensor([0, 16], dtype=torch.int32), 12,
        "post", 1e-5,
    )
    assert torch.isfinite(out).all()


def test_non_cpu_non_cuda_tensors_raise():
    """A tensor the kernels cannot take never falls back to the plain path."""
    x = torch.empty(2, 8, 32, device="meta")
    w = torch.empty(32, 96, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        mha_layer_block(x, w, None, w, None, None, None, None, 4, "post", 1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        fused_encoder_layer(
            x, None, heads=4, mode="post", eps=1e-5,
            attn={"in_proj": {"w": w, "b": None}, "out_proj": {"w": w, "b": None}},
            fc1={"w": w, "b": None}, fc2={"w": w, "b": None},
            ln1={"scale": None, "bias": None}, ln2={"scale": None, "bias": None},
        )


def test_build_command_targets_sm90a_and_sources_exist():
    """The kernel build (not run here: no nvcc) compiles every csrc/*.cu
    for sm_90a into a library under build/kernels/."""
    cmd = _build.nvcc_command("nvcc", _build.BUILD_DIR / "lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    srcs = _build.sources()
    names = {p.name for p in srcs}
    assert {"attention_core.cu", "gemm_epilogue.cu", "common.cuh"} <= names
    assert all(p.exists() for p in srcs)
    assert all(str(p) in cmd for p in srcs if p.suffix == ".cu")
    assert _build.BUILD_DIR.parts[-2:] == ("build", "kernels")
