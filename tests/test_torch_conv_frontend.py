"""The port's ``fused_conv_chain`` (its plain version: what a CPU tensor
runs) against the JAX Pallas kernel in interpret mode, at the shapes of
tests/test_conv_frontend.py — (3, 3, 2) at T = 1300, HuBERT's conv1..6
(3, 3, 3, 3, 2, 2) at T = 2100, (2, 2) at T = 640, a ragged T = 413 — in
f32, and HuBERT's chain at C = 512 in bf16 (B = 2, 16 output frames); also
``window_for``, the CPU wrapper's routing and the agreement check. The
kernel's A operand, the stride-2 fold as ``fold_segments`` describes it,
is built into the layer's GEMM here from exactly those views (f32, odd and
even T, two batch elements): the card's kernel reads nothing else.

Tolerances: f32 — max abs diff <= 1e-4 (the same sums in another order).
bf16 — per-row cosine >= 0.999 and max abs <= 0.0625: each layer rounds to
bf16 on both sides, and another summation order flips some roundings,
which the next layers carry on.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speechclip_tpu.kernels import conv_frontend as jcf
from speechclip_tpu_torch.kernels import _build
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


def fold_gemm(x, w, k, segments):
    """One layer built from exactly the views ``segments`` describe, as the
    kernel's TMA maps read them: each segment's (B, rows, cols) view of x,
    rows past the view's own read as zeros, against its weight rows; f32
    sums, erf GELU, one rounding to x's dtype."""
    b, t, c = x.shape
    t_out = pcf.layer_out_len(t, k)
    w2 = w.float().reshape(k * c, -1)
    acc = torch.zeros(b, t_out, w2.shape[1])
    for s in segments:
        view = torch.as_strided(x, (b, s.rows, s.cols), (s.batch_stride, s.row_stride, 1))
        rows = torch.zeros(b, t_out, s.cols)
        n = max(0, min(t_out, s.rows - s.row_offset))
        rows[:, :n] = view[:, s.row_offset:s.row_offset + n].float()
        acc += rows @ w2[s.w_row:s.w_row + s.cols]
    return torch.nn.functional.gelu(acc).to(x.dtype)


def _fold_inputs(t, c, k, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((2, t, c)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((k, c, c)) * (k * c) ** -0.5).astype(np.float32))
    return x, w


@pytest.mark.parametrize("c", [16, 136])
@pytest.mark.parametrize("t", [40, 41, 413])  # 20479's parity at small size, and even
@pytest.mark.parametrize("k", [2, 3])
def test_fold_views_build_the_plain_layer(k, t, c):
    """The A operand the wrapper hands the kernel (``fold_segments``: the
    segment views, their row offsets, widths and map extents), built into
    the GEMM in f32 on two batch elements, is the plain layer; and no view
    reaches past its own batch element."""
    x, w = _fold_inputs(t, c, k, seed=t + c + k)
    segments = pcf.fold_segments(t, c, k)
    assert [s.w_row for s in segments] == [0, 2 * c][:len(segments)]
    assert sum(s.cols for s in segments) == k * c
    for s in segments:
        assert (s.rows - 1) * s.row_stride + s.cols <= s.batch_stride == t * c
        assert s.row_stride % 8 == 0 and s.batch_stride % 8 == 0  # 16-byte TMA strides
    got = fold_gemm(x, w, k, segments)
    want = pcf.fused_conv_chain_plain(x, [w], (k,))
    assert got.shape == want.shape == (2, pcf.layer_out_len(t, k), c)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=0)


def test_fold_check_catches_the_odd_t_trap():
    """A third-tap view of floor(T/2) full rows leaves out an odd T's last
    frame: the fold check above fails it in the last output row only."""
    t, c = 41, 16
    x, w = _fold_inputs(t, c, 3, seed=5)
    first, third = pcf.fold_segments(t, c, 3)
    short = dataclasses.replace(third, rows=t // 2)
    want = pcf.fused_conv_chain_plain(x, [w], (3,))
    bad = (fold_gemm(x, w, 3, (first, short)) - want).abs().amax(dim=(0, 2))
    assert float(bad[:-1].max()) <= 1e-4 < float(bad[-1])


def test_fold_takes_kernel_sizes_two_and_three():
    for k in (1, 4):
        with pytest.raises(ValueError, match="kernel sizes"):
            pcf.fold_segments(101, 16, k)


def _cu_constant(name):
    text = (_build.CSRC_DIR / "conv_chain.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


@pytest.mark.parametrize("tile", [0, 1])
def test_conv_plan_fits_shared_memory_and_tma_limits(tile):
    """The kernel's plan: a ring of at least 3 stages beside the epilogue's
    staging rows in one block's shared memory, TMA boxes within the
    128-byte swizzle's inner limit and 256 rows, warpgroup tiles wgmma
    takes; the plan's constants are the kernel's."""
    from speechclip_tpu_torch.kernels._attention_common import SMEM_LIMIT

    assert (pcf.CONV_BK, SMEM_LIMIT) == tuple(_cu_constant(n) for n in ("BK", "SMEM_LIMIT"))
    assert pcf.CONV_STAGING_BYTES == 8 * 16 * _cu_constant("STAGE_LD") * 2
    p = pcf.conv_plan(tile)
    rows, cols = pcf.CONV_TILES[tile]
    assert 3 <= p["stages"] <= 8 and p["smem_bytes"] <= SMEM_LIMIT - 1024  # 256 B of barriers
    assert p["smem_bytes"] >= p["stages"] * (rows + cols) * pcf.CONV_BK * 2 + pcf.CONV_STAGING_BYTES
    assert rows % 64 == 0 and rows <= 256 and cols in (128, 256) and pcf.CONV_BK * 2 == 128
    assert rows * cols // 128 <= 128  # f32 accumulators a consumer thread holds


def test_conv_tile_takes_the_fewer_tiles():
    """HuBERT's chain at 6.4 s: 128 x 128 tiles up to layer 5 (a tie),
    64 x 256 for layer 6's 319 rows; 128 x 128 wherever C_out <= 128."""
    t, tiles = 20479, []
    for k in HUBERT:
        t = pcf.layer_out_len(t, k)
        tiles.append(pcf.CONV_TILES[pcf.conv_tile(t, 512)])
    assert tiles == [(128, 128)] * 5 + [(64, 256)]
    assert [pcf.conv_tile(t, c) for t, c in ((319, 128), (64, 64), (65, 136), (63, 256))] == [
        1, 1, 1, 0]


def test_epilogue_probe_swaps_the_kernels_gelu():
    """scripts/torch_conv_epilogue_probe.py times the chain with the body of
    ``gelu_erf`` swapped: the body it replaces is the kernel's, and every
    variant is a body of its own."""
    import importlib.util

    path = _build.PKG_DIR.parent / "scripts" / "torch_conv_epilogue_probe.py"
    spec = importlib.util.spec_from_file_location("probe", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    assert (_build.CSRC_DIR / "conv_chain.cu").read_text().count(probe.ERFF) == 1
    assert probe.VARIANTS["erff"] == probe.ERFF
    assert len(set(probe.VARIANTS.values())) == len(probe.VARIANTS)
