"""The port's ``fused_conv_chain`` (its plain version: what a CPU tensor
runs) against the JAX Pallas kernel in interpret mode, at the shapes of
tests/test_conv_frontend.py — (3, 3, 2) at T = 1300, HuBERT's conv1..6
(3, 3, 3, 3, 2, 2) at T = 2100, (2, 2) at T = 640, a ragged T = 413 — in
f32, and HuBERT's chain at C = 512 in bf16 (B = 2, 16 output frames); also
``window_for``, the CPU wrapper's routing and the agreement check.

Tolerances: f32 — max abs diff <= 1e-4 (the same sums in another order).
bf16 — per-row cosine >= 0.999 and max abs <= 0.0625: each layer rounds to
bf16 on both sides, and another summation order flips some roundings,
which the next layers carry on.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speechclip_tpu.kernels import conv_frontend as jcf
from speechclip_tpu_torch.kernels import conv_frontend as pcf

torch.set_num_threads(2)

HUBERT = (3, 3, 3, 3, 2, 2)


def make_chain(kernels, c, seed, scale=0.25):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((k, c, c)) * scale).astype(np.float32) for k in kernels]


def run_both(kernels, x, weights, dtype, out_block):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jcf.fused_conv_chain(jnp.asarray(x).astype(jdt), [jnp.asarray(w) for w in weights],
                                kernels, out_block=out_block)
    got = pcf.fused_conv_chain(torch.from_numpy(x).to(dtype),
                               [torch.from_numpy(w) for w in weights], kernels)
    assert got.dtype == dtype and got.shape == want.shape
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("kernels, t, blk", [
    ((3, 3, 2), 1300, 32),
    (HUBERT, 2100, 16),
    ((2, 2), 640, 40),
    ((3, 2), 413, 32),  # T_out not a multiple of the TPU's output block
])
def test_plain_matches_jax_kernel_f32(kernels, t, blk):
    x = np.random.default_rng(1).standard_normal((2, t, 16)).astype(np.float32)
    got, want = run_both(kernels, x, make_chain(kernels, 16, seed=0), torch.float32, blk)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_plain_matches_jax_kernel_bf16_at_hubert_width():
    t = pcf.window_for(16, HUBERT)
    assert pcf.chain_out_len(t, HUBERT) == 16
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, t, 512)).astype(np.float32)
    weights = [(rng.standard_normal((k, 512, 512)) * (k * 512) ** -0.5).astype(np.float32)
               for k in HUBERT]
    got, want = run_both(HUBERT, x, weights, torch.bfloat16, 16)
    a, b = got.reshape(-1, 512), want.reshape(-1, 512)
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    assert cos.min() >= 0.999, cos.min()
    assert np.abs(got - want).max() <= 0.0625


def test_window_for_matches_jax():
    for out_block in (1, 2, 16, 64):
        for kernels in (HUBERT, (3, 3, 2), (2, 2)):
            assert pcf.window_for(out_block, kernels) == jcf.window_for(out_block, kernels)
    assert pcf.window_for(64, HUBERT) == 4112  # the TPU kernel's VMEM window


def test_gelu_is_exact_erf_on_the_f32_sum():
    """One layer by hand: f32 sums of the stride-2 frames, erf GELU, one
    rounding; not HuBERT's bf16 chain (tanh GELU of a rounded conv)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 41, 8)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((3, 8, 8)).astype(np.float32)).bfloat16()
    frames = torch.stack([x[0, 2 * t:2 * t + 3].reshape(-1) for t in range(20)]).double()
    want = torch.nn.functional.gelu(frames @ w.double().reshape(24, 8)).bfloat16()
    got = pcf.fused_conv_chain(x, [w], (3,))[0]
    assert (got.float() - want.float()).abs().max() <= 2.0 ** -7 * want.float().abs().max()


def test_cpu_wrapper_takes_plain_path_without_counting():
    x = torch.randn(2, 100, 8)
    ws = [torch.randn(3, 8, 8), torch.randn(2, 8, 8)]
    before = pcf.fused_conv_chain.launches
    torch.testing.assert_close(pcf.fused_conv_chain(x, ws, (3, 2)),
                               pcf.fused_conv_chain_plain(x, ws, (3, 2)), rtol=0, atol=0)
    assert pcf.fused_conv_chain.launches == before


def test_non_cpu_non_cuda_tensors_raise():
    x = torch.empty(1, 64, 8, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pcf.fused_conv_chain(x, [torch.empty(3, 8, 8, device="meta")], (3,))
    with pytest.raises(ValueError, match="kernel sizes"):
        pcf.fused_conv_chain(x, [], (3,))


def test_agreement_check_fails_tanh_gelu():
    """The per-layer check passes an f32 summation in another order and
    fails GELU computed with tanh (the fault the card's test plants)."""
    rng = np.random.default_rng(4)
    x = torch.nn.functional.gelu(torch.from_numpy(
        rng.standard_normal((2, 1201, 512)).astype(np.float32))).bfloat16()
    w = torch.from_numpy((rng.standard_normal((3, 512, 512)) / np.sqrt(1536)).astype(np.float32))
    frames = x.float().as_strided((2, 600, 1536), (1201 * 512, 1024, 1))
    sums = frames.double() @ w.bfloat16().double().reshape(1536, 512)
    ref = torch.nn.functional.gelu(sums).bfloat16()
    sound = pcf.conv_chain_agreement(pcf.fused_conv_chain(x, [w.bfloat16()], (3,)), ref)
    tanh = pcf.conv_chain_agreement(
        torch.nn.functional.gelu(sums.float(), approximate="tanh").bfloat16(), ref)
    assert sound["mismatch"] <= pcf.MAX_LAYER_MISMATCH / 5, sound
    assert tanh["mismatch"] > 2 * pcf.MAX_LAYER_MISMATCH, tanh
