"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card. Every test here needs an NVIDIA GPU (marker ``gpu``) and skips
without one. On a machine with the card, and without jax installed, run:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py

(``--noconftest``: tests/conftest.py sets up jax's CPU platform, which these
tests do not use.) This file imports torch only.

Tolerance: bf16 outputs, same rounding points on both sides; a different
summation order can flip an intermediate bf16 rounding, so per-row cosine
>= 0.999 and max abs diff <= 0.125 (4 ulp at |y| ~ 4-8 after LayerNorm).
"""

import pytest
import torch

pytestmark = pytest.mark.gpu

ATOL = 0.125
MIN_COSINE = 0.999


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA device")
    return torch.device("cuda")


def _close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got).all()
    g, w = got.float().flatten(0, -2), want.float().flatten(0, -2)
    cos = torch.nn.functional.cosine_similarity(g, w, dim=-1, eps=1e-12)
    assert float((g - w).abs().max()) <= ATOL
    assert float(cos.min()) >= MIN_COSINE


def _mha_args(dev, b, t, d, heads, mode, with_lens, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    bf = torch.bfloat16
    lens = (
        torch.randint(1, t + 1, (b,), generator=g, device=dev).to(torch.int32)
        if with_lens else None
    )
    return (rn(b, t, d).to(bf), (rn(d, 3 * d) * d**-0.5).to(bf), 0.1 * rn(3 * d),
            (rn(d, d) * d**-0.5).to(bf), 0.1 * rn(d), 1 + 0.1 * rn(d), 0.1 * rn(d),
            lens, heads, mode, 1e-5)


@pytest.mark.parametrize("mode", ["post", "pre", "none"])
@pytest.mark.parametrize("heads, t", [(12, 319), (8, 320), (12, 67), (8, 17)])
@pytest.mark.parametrize("with_lens", [True, False])
def test_mha_layer_block_kernel_matches_plain(cuda, mode, heads, t, with_lens):
    from speechclip_tpu_torch.kernels.mha_block import (
        mha_layer_block,
        mha_layer_block_plain,
    )

    args = _mha_args(cuda, 3, t, 768, heads, mode, with_lens)
    before = mha_layer_block.launches
    got = mha_layer_block(*args)
    torch.cuda.synchronize()
    assert mha_layer_block.launches == before + 1
    _close(got, mha_layer_block_plain(*args))


@pytest.mark.parametrize("mode", ["post", "pre", "none"])
@pytest.mark.parametrize("t", [319, 67, 1])
def test_ffn_block_kernel_matches_plain(cuda, mode, t):
    from speechclip_tpu_torch.kernels.ffn_block import ffn_block, ffn_block_plain

    g = torch.Generator(device=cuda).manual_seed(1)
    rn = lambda *s: torch.randn(*s, generator=g, device=cuda)
    d, f, bf = 768, 3072, torch.bfloat16
    args = (rn(3, t, d).to(bf), (rn(d, f) * d**-0.5).to(bf), 0.1 * rn(f),
            (rn(f, d) * f**-0.5).to(bf), 0.1 * rn(d), 1 + 0.1 * rn(d), 0.1 * rn(d),
            mode, 1e-5)
    before = ffn_block.launches
    got = ffn_block(*args)
    torch.cuda.synchronize()
    assert ffn_block.launches == before + 1
    _close(got, ffn_block_plain(*args))


@pytest.mark.parametrize("m, n, k", [(100, 72, 40), (1, 8, 8), (300, 2304, 768)])
def test_gemm_ragged_edges(cuda, m, n, k):
    from speechclip_tpu_torch.kernels.mha_block import EPI_BIAS, gemm

    g = torch.Generator(device=cuda).manual_seed(2)
    a = torch.randn(m, k, generator=g, device=cuda).bfloat16()
    w = torch.randn(k, n, generator=g, device=cuda).bfloat16()
    bias = torch.randn(n, generator=g, device=cuda)
    got = gemm(a, w, bias, EPI_BIAS)
    want = (a.float() @ w.float() + bias).bfloat16()
    torch.testing.assert_close(got.float(), want.float(), rtol=2**-7, atol=2**-7 * k**0.5)


def test_fully_masked_rows_match_plain(cuda):
    from speechclip_tpu_torch.kernels.mha_block import (
        mha_layer_block,
        mha_layer_block_plain,
    )

    args = list(_mha_args(cuda, 2, 67, 768, 12, "post", True, seed=3))
    args[7] = torch.tensor([0, 67], dtype=torch.int32, device=cuda)
    _close(mha_layer_block(*args), mha_layer_block_plain(*args))


def test_cuda_inputs_the_kernels_do_not_take_raise(cuda):
    from speechclip_tpu_torch.kernels.mha_block import mha_layer_block

    args = list(_mha_args(cuda, 2, 64, 768, 12, "post", True))
    with pytest.raises(TypeError, match="bf16"):
        mha_layer_block(args[0].float(), *args[1:])
    args[0] = args[0].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="grad"):
        mha_layer_block(*args)
    args[0] = args[0].detach()
    with pytest.raises(ValueError, match="attention core"):
        mha_layer_block(*(args[:8] + [96] + args[9:]))  # Dh = 8: not a multiple of 16


def test_gemm_rejects_misaligned_operands(cuda):
    from speechclip_tpu_torch.kernels.mha_block import EPI_BIAS, gemm

    bf = torch.bfloat16
    a = torch.zeros(65, dtype=bf, device=cuda)[1:].view(4, 16)  # 2-byte offset
    w = torch.zeros(16, 8, dtype=bf, device=cuda)
    bias = torch.zeros(8, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        gemm(a, w, bias, EPI_BIAS)
    with pytest.raises(ValueError, match="K % 8"):
        gemm(a.clone(), w[:8], bias, EPI_BIAS)
