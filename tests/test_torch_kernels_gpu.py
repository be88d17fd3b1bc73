"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card. Every test here needs an NVIDIA GPU (marker ``gpu``) and skips
without one. On a machine with the card, and without jax installed, run:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels_gpu.py

(``--noconftest``: tests/conftest.py sets up jax's CPU platform, which these
tests do not use.) This file imports torch only.

Tolerance: bf16 outputs, same rounding points on both sides; a different
summation order can flip an intermediate bf16 rounding. Layer outputs
(``mha_layer_block``, ``ffn_block``): per-row cosine >= 0.999 and max abs
diff <= 0.125 (4 ulp at |y| ~ 4-8 after LayerNorm). Attention outputs
(``attention_vmem``, ``flash_attention``) are means of v, far smaller, so
they are held to limits tied to their own scale (``attention_agrees``: per
row max abs <= 2 ulp of the row's largest |value|, cosine >= 0.99999, at
most 5 % of elements differing); the planted-fault tests show that check
failing on a one-key mask error, on other rounding points and on a
dropped 128-wide head-dim chunk. The conv chain (``fused_conv_chain``) is
held, layer by layer on the same input, to at most 0.5 % of elements
differing (``MAX_LAYER_MISMATCH``), and as a whole chain to the layer
limits; a tanh GELU planted in its plain version fails the first.
``pos_conv`` (HuBERT's grouped k = 128 conv with its bias, GELU and
residual) sums in f32 in another order than cuDNN, so at most one bf16
rounding of the conv flips before the epilogue's steps: it is held to at
most ``MAX_STEPS`` bf16 steps of max(|x|, |term|, |out|, 1) and at most
``MAX_MISMATCH`` of elements differing (``pos_conv_agrees``), and to the
layer limits; a plain version without the conv's rounding, or with the taps
shifted by one, fails it. The image preprocessing on the card is held to
its CPU result (max abs 1e-4, normalized units).
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


def _attn_close(got, want):
    from speechclip_tpu_torch.kernels._attention_common import (
        attention_agreement,
        attention_agrees,
    )

    assert got.dtype == want.dtype and got.shape == want.shape
    stats = attention_agreement(got, want)
    assert attention_agrees(stats), stats


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
    # an input that requires grad is taken: the forward launches the kernel,
    # the gradient comes from the plain recompute
    x = args[0].clone().requires_grad_(True)
    launches = mha_layer_block.launches
    mha_layer_block(x, *args[1:]).float().sum().backward()
    assert mha_layer_block.launches == launches + 1 and torch.isfinite(x.grad).all()
    with pytest.raises(ValueError, match="attention core"):
        mha_layer_block(*(args[:8] + [4] + args[9:]))  # Dh = 192: over the gate's 128


def test_fused_conv_chain_stays_forward_only(cuda):
    """JAX gives fused_conv_chain no VJP (it is on no model path): an input
    that requires grad raises on the card."""
    from speechclip_tpu_torch.kernels.conv_frontend import fused_conv_chain

    x = torch.zeros(1, 64, 512, dtype=torch.bfloat16, device=cuda, requires_grad=True)
    w = [torch.zeros(3, 512, 512, dtype=torch.bfloat16, device=cuda)]
    with pytest.raises(RuntimeError, match="forward-only"):
        fused_conv_chain(x, w, (3,))


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


@pytest.mark.parametrize("heads, t", [(12, 600), (8, 600), (12, 782), (8, 782), (96, 600)])
@pytest.mark.parametrize("mode", ["post", "none"])
def test_mha_layer_block_at_repaired_lengths(cuda, heads, t, mode):
    """T past the rows the first whole-key core held (512 at Dh = 64, 448 at
    Dh = 96, and Dh % 16 != 0) up to the gate's largest T = 782: the
    whole-row core streams K/V."""
    from speechclip_tpu_torch.kernels.mha_block import (
        block_eligible,
        mha_layer_block,
        mha_layer_block_plain,
    )

    assert block_eligible(2, t, 768, heads)
    args = _mha_args(cuda, 2, t, 768, heads, mode, True, seed=t)
    got = mha_layer_block(*args)
    torch.cuda.synchronize()
    _close(got, mha_layer_block_plain(*args))


@pytest.mark.parametrize("heads", [16, 8])  # HuBERT-large; the large branch (Dh = 128)
def test_mha_layer_block_at_d1024_gate_limit(cuda, heads):
    from speechclip_tpu_torch.kernels.mha_block import (
        block_eligible,
        mha_layer_block,
        mha_layer_block_plain,
    )

    assert block_eligible(2, 460, 1024, heads) and not block_eligible(2, 461, 1024, heads)
    args = _mha_args(cuda, 2, 460, 1024, heads, "pre", True, seed=heads)
    _close(mha_layer_block(*args), mha_layer_block_plain(*args))


def test_smem_formulas_match_the_library(cuda):
    from speechclip_tpu_torch.kernels import _build, attention_vmem, mha_block

    lib = _build.load()
    for dh in (8, 64, 72, 96, 128):
        assert attention_vmem.smem_bytes(dh) == lib.scl_rowwise_smem_bytes(dh)
    for bn in mha_block.GEMM_BLOCK_NS:
        for epilogue in range(4):
            plan = mha_block.gemm_plan(768, epilogue, bn)
            assert plan["smem_bytes"] == lib.scl_gemm_smem_bytes(epilogue, bn)


def _gemm_want(a, w, bias, epilogue, resid):
    """The f32 product plus the epilogue with the kernel's rounding points."""
    from speechclip_tpu_torch.kernels import mha_block as mb
    from speechclip_tpu_torch.ops.basic import gelu

    y = a.float() @ w.float() + bias
    if epilogue == mb.EPI_BIAS_GELU:
        return gelu(y.bfloat16())
    if epilogue in (mb.EPI_BIAS_RESID_F32, mb.EPI_BIAS_RESID):
        y = y + resid.float()
    return y if epilogue == mb.EPI_BIAS_RESID_F32 else y.bfloat16()


def _gemm_case(dev, m, n, k, epilogue, seed, block_n=0):
    """bf16 operands at unit output scale (weights ~ K^-0.5); the kernel's
    output against ``_gemm_want``. bf16 outputs: rtol 2^-7 (one rounding
    flip) and atol 2^-5 (a flipped bf16 GELU input of |x| ~ 4 moves the
    output by one input ulp, 2^-5, plus the output's rounding). f32 outputs
    differ only in summation order: 1e-3."""
    from speechclip_tpu_torch.kernels import mha_block as mb

    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn(m, k, generator=g, device=dev).bfloat16()
    w = (torch.randn(k, n, generator=g, device=dev) * k**-0.5).bfloat16()
    bias = 0.1 * torch.randn(n, generator=g, device=dev)
    resid = torch.randn(m, n, generator=g, device=dev).bfloat16()
    uses_resid = epilogue in (mb.EPI_BIAS_RESID_F32, mb.EPI_BIAS_RESID)
    got = mb.gemm(a, w, bias, epilogue, resid if uses_resid else None, block_n=block_n)
    torch.cuda.synchronize()
    want = _gemm_want(a, w, bias, epilogue, resid)
    assert got.dtype == want.dtype and got.shape == (m, n)
    assert torch.isfinite(got).all()
    tol = dict(rtol=1e-3, atol=1e-3) if got.dtype == torch.float32 else dict(
        rtol=2**-7, atol=2**-5)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("epilogue", [0, 1, 2, 3])
@pytest.mark.parametrize("m, n, k", [
    (1, 8, 8), (1, 768, 3072), (100, 72, 40), (129, 136, 200), (255, 264, 72),
    (300, 2304, 768), (383, 776, 1000),
])
@pytest.mark.parametrize("block_n", [0, 128])
def test_gemm_every_epilogue_at_ragged_shapes(cuda, epilogue, m, n, k, block_n):
    """M not a multiple of 128 (and M = 1), N not a multiple of the tile,
    K not a multiple of 64: TMA zero-fills the loads, the epilogue guards
    the stores."""
    _gemm_case(cuda, m, n, k, epilogue, seed=m + n + k + epilogue, block_n=block_n)


def test_gemm_gelu_over_every_bf16_input(cuda):
    """fc1's GELU epilogue at every finite bf16 input: a one-hot row times a
    weight row holding each value, so the GELU input is the value itself.
    Against torch's tanh GELU in f32 rounded to bf16: the two may contract
    the polynomial into FMAs differently, so a result may differ by one bf16
    ulp in a few inputs, never more."""
    from speechclip_tpu_torch.kernels import mha_block as mb

    vals = torch.arange(-(2**15), 2**15, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    vals = vals[torch.isfinite(vals.float())]
    vals = vals[: vals.numel() // 8 * 8].to(cuda)
    n = vals.numel()
    w = torch.zeros(8, n, dtype=torch.bfloat16, device=cuda)
    w[0] = vals
    a = torch.zeros(1, 8, dtype=torch.bfloat16, device=cuda)
    a[0, 0] = 1
    got = mb.gemm(a, w, torch.zeros(n, device=cuda), mb.EPI_BIAS_GELU)[0].float()
    want = torch.nn.functional.gelu(vals.float(), approximate="tanh").bfloat16().float()
    ulp = torch.finfo(torch.bfloat16).eps * want.abs().clamp(min=2**-126)
    assert torch.isfinite(got).all()
    assert bool(((got - want).abs() <= ulp).all())
    assert float((got != want).float().mean()) <= 1e-3


@pytest.mark.parametrize("name, n, k, epilogue", [
    ("qkv", 2304, 768, 0), ("out-proj", 768, 768, 2), ("fc1", 3072, 768, 1),
    ("fc2", 768, 3072, 2),
])
def test_gemm_main_path_products(cuda, name, n, k, epilogue):
    """The four products of the main path at M = 64 x 319 rows."""
    _gemm_case(cuda, 64 * 319, n, k, epilogue, seed=n + k)


@pytest.mark.parametrize("rows, d", [(20416, 768), (5, 1024), (33, 8), (7, 1032)])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_rows_matches_plain(cuda, rows, d, x_dtype):
    from speechclip_tpu_torch.kernels.mha_block import layer_norm_rows, ln_rows

    g = torch.Generator(device=cuda).manual_seed(rows + d)
    x = (3 * torch.randn(rows, d, generator=g, device=cuda) + 1).to(x_dtype)
    gamma = 1 + 0.1 * torch.randn(d, generator=g, device=cuda)
    beta = 0.1 * torch.randn(d, generator=g, device=cuda)
    got = layer_norm_rows(x, gamma, beta, 1e-5)
    want = ln_rows(x.float(), gamma, beta, 1e-5).bfloat16()
    torch.testing.assert_close(got.float(), want.float(), rtol=2**-7, atol=2**-6)


def _qkv(dev, b, h, l, s, dh, seed, lens="random", packed=False, dtype=torch.bfloat16):
    """bf16 (or ``dtype``) (B, H, rows, Dh) q, k, v (head-split views of one
    packed buffer when ``packed``, as the dispatcher passes them) and int32
    lens."""
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = dtype
    if packed:
        assert l == s
        qkv = torch.randn(b, l, 3, h, dh, generator=g, device=dev).to(bf)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    else:
        q = torch.randn(b, h, l, dh, generator=g, device=dev).to(bf)
        k, v = (torch.randn(b, h, s, dh, generator=g, device=dev).to(bf) for _ in range(2))
    if lens == "random":
        lens = torch.randint(s // 2, s + 1, (b,), generator=g, device=dev).to(torch.int32)
    elif lens == "zero_row":
        lens = torch.full((b,), s, dtype=torch.int32, device=dev)
        lens[0] = 0
    return q, k, v, lens


ATTENTION_SHAPES = [  # (b, h, l, s, dh, lens, causal, packed)
    (16, 12, 849, 849, 64, "random", False, True),   # long-utterance HuBERT
    (16, 8, 850, 850, 96, "random", False, True),    # long-utterance branch
    (64, 8, 256, 256, 64, None, True, False),        # causal
    (4, 4, 300, 300, 128, "random", False, False),   # Dh = 128
    (4, 8, 200, 333, 96, "random", False, False),    # L != S
    (4, 8, 333, 200, 64, "random", True, False),     # L != S, causal
    (3, 6, 140, 140, 72, "zero_row", False, False),  # a lens = 0 row; Dh % 16 != 0
    (3, 6, 140, 140, 64, "zero_row", True, False),
    (2, 2, 934, 934, 8, "random", False, False),     # the gate's longest row, Dh = 8
    (2, 4, 2048, 2048, 64, "random", False, False),  # past the old score-row cap
    (2, 2, 2048, 2048, 128, "zero_row", True, False),
]


@pytest.mark.parametrize("b, h, l, s, dh, lens, causal, packed", ATTENTION_SHAPES)
def test_attention_vmem_kernel_matches_plain(cuda, b, h, l, s, dh, lens, causal, packed):
    from speechclip_tpu_torch.kernels.attention_vmem import attention_vmem, attention_vmem_plain

    q, k, v, lens_t = _qkv(cuda, b, h, l, s, dh, seed=l + dh, lens=lens, packed=packed)
    before = attention_vmem.launches
    got = attention_vmem(q, k, v, lens_t, causal)
    torch.cuda.synchronize()
    assert attention_vmem.launches == before + 1
    _attn_close(got, attention_vmem_plain(q, k, v, lens_t, causal))


FLASH_SHAPES = ATTENTION_SHAPES + [
    (64, 12, 319, 319, 64, "random", False, True),   # the flash-backend encode
    (64, 8, 77, 77, 64, None, True, False),          # the CLIP text tower
    (2, 4, 1500, 1500, 64, "random", True, False),   # longer than any whole-row plan
    (64, 1, 327, 327, 768, "random", False, True),   # the cascaded branch's one head
    (4, 1, 200, 200, 768, "zero_row", False, False),  # a lens = 0 row at Dh = 768
    (3, 1, 333, 120, 768, "random", False, False),   # L != S at Dh = 768
    (2, 2, 150, 150, 200, "random", True, False),    # wide, not a multiple of 128, causal
    (64, 8, 10, 10, 64, None, True, True),           # the text tower over K + 2 tokens
    (3, 6, 100, 128, 72, "zero_row", False, False),  # one block per head: L, S <= 128
    (5, 3, 128, 40, 128, "random", True, False),
    (4, 2, 1, 1, 64, None, True, False),
    (2, 2, 150, 150, 1152, "random", False, False),  # wider than eight 128-wide chunks
    (3, 1, 90, 200, 1152, "zero_row", True, False),
    (4, 3, 200, 200, 136, "random", True, False),    # one chunk and 8 columns
    (256, 12, 50, 50, 64, None, False, True),        # ViT-B/32 under "pallas"
    (64, 16, 257, 257, 64, None, False, True),       # ViT-L/14 under "pallas"
]


@pytest.mark.parametrize("b, h, l, s, dh, lens, causal, packed", FLASH_SHAPES)
def test_flash_attention_kernel_matches_plain(cuda, b, h, l, s, dh, lens, causal, packed):
    from speechclip_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    q, k, v, lens_t = _qkv(cuda, b, h, l, s, dh, seed=l + dh + 1, lens=lens, packed=packed)
    before = flash_attention.launches
    got = flash_attention(q, k, v, lens_t, causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    _attn_close(got, flash_attention_plain(q, k, v, lens_t, causal))


FLASH_F32_SHAPES = [  # (b, h, l, s, dh, lens, causal, packed)
    (256, 8, 77, 77, 64, None, True, True),          # forward_text under "pallas"
    (3, 6, 140, 140, 72, "zero_row", False, False),  # a lens = 0 row; Dh % 32 != 0
    (3, 6, 140, 140, 64, "zero_row", True, False),
    (4, 8, 200, 333, 96, "random", False, False),    # L != S
    (4, 8, 333, 200, 64, "random", True, False),
    (2, 2, 150, 150, 200, "random", True, False),    # wide, Dh % 32 != 0
    (4, 1, 200, 200, 768, "zero_row", False, True),  # the cascaded branch's one head
    (2, 1, 90, 90, 520, "random", True, False),      # past 512: 8 rows a block
    (64, 1, 327, 327, 768, "random", False, True),   # the cascaded head, its shape
    (4, 2, 1, 1, 8, None, True, False),
    (64, 1, 327, 327, 1024, "random", False, True),  # the large cascaded head: K, V in turn
    (4, 1, 200, 120, 1024, "zero_row", True, False),  # L != S, a lens = 0 row at Dh = 1024
    (2, 2, 90, 90, 776, "random", False, False),     # just past 768
]


@pytest.mark.parametrize("b, h, l, s, dh, lens, causal, packed", FLASH_F32_SHAPES)
def test_flash_attention_f32_kernel_matches_plain(cuda, b, h, l, s, dh, lens, causal, packed):
    """The f32 form (f32 in and out, f32 arithmetic throughout) against the
    plain version on the same f32 inputs: ``attention_agrees``' f32 limits."""
    from speechclip_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    q, k, v, lens_t = _qkv(cuda, b, h, l, s, dh, seed=l + dh + 3, lens=lens, packed=packed,
                           dtype=torch.float32)
    before = flash_attention.launches
    got = flash_attention(q, k, v, lens_t, causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == torch.float32
    _attn_close(got, flash_attention_plain(q, k, v, lens_t, causal))


def test_flash_f32_check_fails_a_planted_fault(cuda):
    """At the text shape the f32 form passes; against a plain version whose
    causal mask lets each row see one key too many it fails."""
    from speechclip_tpu_torch.kernels._attention_common import (
        attention_agreement,
        attention_agrees,
    )
    from speechclip_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    q, k, v, _ = _qkv(cuda, 64, 8, 77, 77, 64, seed=77, lens=None, packed=True,
                      dtype=torch.float32)
    got = flash_attention(q, k, v, None, True)
    assert attention_agrees(attention_agreement(got, flash_attention_plain(q, k, v, None, True)))
    # row r sees keys 0..r+1
    scores = (q.float() @ k.float().transpose(-1, -2)) / 8.0
    ok = torch.ones(77, 77, dtype=torch.bool, device=cuda).tril(1)
    faulty = torch.softmax(scores.masked_fill(~ok, float("-inf")), dim=-1) @ v.float()
    stats = attention_agreement(got, faulty)
    assert not attention_agrees(stats), stats


@pytest.mark.parametrize("b, h, l, s, dh, lens", [
    (2, 4, 2048, 2048, 64, "random"),   # past the old score-row cap
    (2, 2, 2048, 2048, 128, "zero_row"),
    (16, 12, 600, 600, 64, "random"),   # the 12 s core
    (3, 6, 140, 333, 72, "random"),     # L != S, Dh % 16 != 0
])
def test_rowwise_core_matches_masked_sdpa(cuda, b, h, l, s, dh, lens):
    """The whole-row kernel with masked_sdpa's rounding points (the long-row
    core of ``mha_layer_block``) against masked_sdpa, at rows of any length."""
    from speechclip_tpu_torch.kernels._sdpa_ref import masked_sdpa
    from speechclip_tpu_torch.kernels.attention_vmem import rowwise_attention
    from speechclip_tpu_torch.kernels._attention_common import empty_heads_out

    q, k, v, lens_t = _qkv(cuda, b, h, l, s, dh, seed=s + dh + 2, lens=lens)
    out = empty_heads_out(b, h, l, dh, cuda)
    rowwise_attention(q, k, v, lens_t, out, causal=False, vmem_rounding=False)
    torch.cuda.synchronize()
    _attn_close(out, masked_sdpa(q, k, v, lens_t))


@pytest.mark.parametrize("heads", [12, 8])
def test_mha_layer_block_past_the_old_row_cap(cuda, heads):
    """T = 1600 is past the longest row the whole-row kernel used to hold
    (1536 at Dh = 64, 1472 at Dh = 96); its plan no longer depends on T."""
    from speechclip_tpu_torch.kernels.mha_block import (
        attention_core_max_t,
        mha_layer_block,
        mha_layer_block_plain,
    )

    assert attention_core_max_t(768 // heads) >= 1600
    args = _mha_args(cuda, 2, 1600, 768, heads, "post", True, seed=heads + 1)
    _close(mha_layer_block(*args), mha_layer_block_plain(*args))


@pytest.mark.parametrize("b", [64, 3])
def test_mha_layer_block_at_vit_l14_rows(cuda, b):
    """ViT-L/14 under "auto": 257 rows (one past a power of two: a ragged
    last tile for the GEMMs and the whole-row core), 1024 wide, 16 heads,
    "none", no key lengths."""
    from speechclip_tpu_torch.kernels.mha_block import (
        block_eligible,
        mha_layer_block,
        mha_layer_block_plain,
    )

    assert block_eligible(b, 257, 1024, 16)
    args = _mha_args(cuda, b, 257, 1024, 16, "none", False, seed=257 + b)
    before = mha_layer_block.launches
    got = mha_layer_block(*args)
    torch.cuda.synchronize()
    assert mha_layer_block.launches == before + 1
    _close(got, mha_layer_block_plain(*args))


@pytest.mark.parametrize("hw", [(256, 256), (200, 300), (180, 180)])
def test_device_clip_preprocess_on_the_card(cuda, hw):
    """The resize and normalize run on the card, with no copy to the host,
    and agree with the CPU result."""
    from torch.profiler import ProfilerActivity, profile

    from speechclip_tpu_torch.data.image import device_clip_preprocess

    g = torch.Generator().manual_seed(hw[0])
    images = torch.randint(0, 256, (4, *hw, 3), generator=g, dtype=torch.uint8)
    on_card = images.to(cuda)
    device_clip_preprocess(on_card)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = device_clip_preprocess(on_card)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    assert not [n for n in names if "DtoH" in n], names
    assert got.device.type == "cuda" and got.dtype == torch.float32
    want = device_clip_preprocess(images)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("kernel, fault", [
    ("attention_vmem", "lens_off_by_one"),
    ("attention_vmem", "mha_rounding"),
    ("flash_attention", "lens_off_by_one"),
    ("flash_attention", "bf16_p"),
])
def test_attention_check_fails_planted_faults(cuda, kernel, fault):
    """The kernel, sound, passes against its plain version at the 17 s
    HuBERT shape and fails against the plain version with a planted fault:
    a mask one key too long, masked_sdpa's rounding, or bf16 p in P V."""
    from speechclip_tpu_torch.kernels import attention_vmem as av
    from speechclip_tpu_torch.kernels import flash_attention as fa
    from speechclip_tpu_torch.kernels._attention_common import (
        attention_agreement,
        attention_agrees,
    )
    from tests.test_torch_attention_agreement import faulty_plain

    kern, plain = {"attention_vmem": (av.attention_vmem, av.attention_vmem_plain),
                   "flash_attention": (fa.flash_attention, fa.flash_attention_plain)}[kernel]
    q, k, v, lens = _qkv(cuda, 16, 12, 849, 849, 64, seed=5, packed=True)
    lens = lens.clamp(max=848)  # every batch has a key past its length
    got = kern(q, k, v, lens)
    assert attention_agrees(attention_agreement(got, plain(q, k, v, lens)))
    stats = attention_agreement(got, faulty_plain(kernel, fault, q, k, v, lens))
    assert not attention_agrees(stats), stats


def test_attention_kernels_raise_on_what_they_do_not_take(cuda):
    """``attention_vmem`` stops at Dh = 128 (the cascaded branch's 768-wide
    head raises there); ``flash_attention`` takes it and raises only on Dh
    % 8 != 0 (and, in f32, past 1024). ``attention_vmem`` runs bf16 only;
    ``flash_attention`` bf16 or f32, never mixed."""
    from speechclip_tpu_torch.kernels.attention_vmem import attention_vmem
    from speechclip_tpu_torch.kernels.flash_attention import flash_attention

    q, k, v, lens = _qkv(cuda, 1, 1, 16, 16, 768, seed=0)
    with pytest.raises(ValueError, match="head dim"):
        attention_vmem(q, k, v, lens)
    assert flash_attention(q, k, v, lens).shape == q.shape
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q[..., :100], k[..., :100], v[..., :100], lens)
    with pytest.raises(TypeError, match="bf16"):
        attention_vmem(q[..., :64].float(), k[..., :64].float(), v[..., :64].float(), lens)
    for bad in ((q.half(), k.half(), v.half()), (q.float(), k, v)):
        with pytest.raises(TypeError, match="bf16 or f32"):
            flash_attention(*bad, lens)
    wide = torch.zeros(1, 1, 16, 1032, device=cuda)
    with pytest.raises(ValueError, match="up to 1024"):
        flash_attention(wide, wide, wide)


def test_flash_check_fails_a_dropped_head_dim_chunk(cuda):
    """At the cascaded shape the sound wide kernel passes; against a plain
    version whose scores leave out one 128-wide chunk of Dh it fails."""
    from speechclip_tpu_torch.kernels._attention_common import (
        attention_agreement,
        attention_agrees,
    )
    from speechclip_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    q, k, v, lens = _qkv(cuda, 64, 1, 327, 327, 768, seed=9, packed=True)
    got = flash_attention(q, k, v, lens)
    assert attention_agrees(attention_agreement(got, flash_attention_plain(q, k, v, lens)))
    keep = torch.ones(768, device=cuda)
    keep[256:384] = 0  # the third chunk's products left out of Q K^T
    qd = (q.float() * keep).to(q.dtype)
    faulty = flash_attention_plain(qd, k, v, lens)
    stats = attention_agreement(got, faulty)
    assert not attention_agrees(stats), stats


def _conv_inputs(dev, b, t, c, kernels, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.nn.functional.gelu(torch.randn(b, t, c, generator=g, device=dev)).bfloat16()
    ws = [(torch.randn(k, c, c, generator=g, device=dev) * (k * c) ** -0.5).bfloat16()
          for k in kernels]
    return x, ws


def _conv_agrees(got, want, layer):
    from speechclip_tpu_torch.kernels.conv_frontend import (
        MAX_LAYER_MISMATCH,
        conv_chain_agreement,
    )

    st = conv_chain_agreement(got, want)
    ok = st["finite"] and st["max_abs_err"] <= ATOL and st["min_cosine"] >= MIN_COSINE
    return ok and (not layer or st["mismatch"] <= MAX_LAYER_MISMATCH), st


@pytest.mark.parametrize("b, t, c, kernels", [
    (3, 2100, 512, (3, 3, 3, 3, 2, 2)),  # HuBERT conv1..6, ragged T_out
    (2, 413, 64, (3, 2)),
    (1, 1301, 136, (2, 3, 2)),
    (5, 20479, 512, (3,)),  # conv1 at 6.4 s
    (64, 20479, 512, (3, 3, 3, 3, 2, 2)),  # the whole chain at 6.4 s, B = 64
])
def test_conv_chain_kernel_matches_plain(cuda, b, t, c, kernels):
    from speechclip_tpu_torch.kernels.conv_frontend import (
        chain_out_len,
        fused_conv_chain,
        fused_conv_chain_plain,
    )

    x, ws = _conv_inputs(cuda, b, t, c, kernels, seed=t)
    before = fused_conv_chain.launches
    got = fused_conv_chain(x, ws, kernels)
    torch.cuda.synchronize()
    assert fused_conv_chain.launches == before + 1
    assert got.shape == (b, chain_out_len(t, kernels), c)
    ok, st = _conv_agrees(got, fused_conv_chain_plain(x, ws, kernels), layer=False)
    assert ok, st
    h = x  # each layer alone, on the plain chain's input to it
    for w, k in zip(ws, kernels):
        want = fused_conv_chain_plain(h, [w], (k,))
        ok, st = _conv_agrees(fused_conv_chain(h, [w], (k,)), want, layer=True)
        assert ok, (k, st)
        h = want


def test_conv_chain_check_fails_tanh_gelu(cuda):
    """The per-layer check passes the sound kernel and fails a plain
    version with tanh GELU in place of erf."""
    from speechclip_tpu_torch.kernels.conv_frontend import fused_conv_chain

    x, ws = _conv_inputs(cuda, 4, 4001, 512, (3,), seed=1)
    got = fused_conv_chain(x, ws, (3,))
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = torch.nn.functional.conv1d(x.float().transpose(1, 2),
                                       ws[0].float().permute(2, 1, 0), stride=2)
    sound = torch.nn.functional.gelu(y).transpose(1, 2).bfloat16()
    tanh = torch.nn.functional.gelu(y, approximate="tanh").transpose(1, 2).bfloat16()
    assert _conv_agrees(got, sound, layer=True)[0]
    ok, st = _conv_agrees(got, tanh, layer=True)
    assert not ok, st


def test_conv_chain_raises_on_what_it_does_not_take(cuda):
    from speechclip_tpu_torch.kernels.conv_frontend import fused_conv_chain

    x, ws = _conv_inputs(cuda, 1, 100, 16, (3,), seed=2)
    with pytest.raises(TypeError, match="bf16"):
        fused_conv_chain(x.float(), ws, (3,))
    with pytest.raises(ValueError, match="multiples of 8"):
        fused_conv_chain(x[..., :12], [w[:, :12, :12] for w in ws], (3,))
    with pytest.raises(ValueError, match="window"):
        fused_conv_chain(x[:, :2], ws, (3,))
    for k in (1, 4):  # the fold takes k = 2 and 3, as the TPU kernel does
        w = torch.zeros(k, 16, 16, dtype=torch.bfloat16, device=cuda)
        with pytest.raises(ValueError, match="kernel sizes"):
            fused_conv_chain(x, [w], (k,))
    from speechclip_tpu_torch.kernels.conv_frontend import conv_layer

    with pytest.raises(ValueError, match="bf16 CUDA"):
        conv_layer(x.cpu(), ws[0], 3)


@pytest.mark.parametrize("tile", [0, 1])
@pytest.mark.parametrize("b, t, c, k", [
    (2, 41, 16, 3), (2, 40, 16, 3), (3, 413, 136, 3), (3, 413, 136, 2), (2, 1279, 512, 2),
    (4, 20479, 512, 3), (64, 639, 512, 2), (1, 9, 8, 3), (2, 130, 64, 2),
])
def test_conv_layer_both_tiles_match_plain(cuda, tile, b, t, c, k):
    """Each warpgroup tile (64 x 256, 128 x 128) at odd and even T, ragged
    C and T_out, one N tile, one row of output, against the plain layer on
    the same input; the launch count is the chain's, not the layer's."""
    from speechclip_tpu_torch.kernels.conv_frontend import (
        conv_layer,
        fused_conv_chain,
        fused_conv_chain_plain,
    )

    x, ws = _conv_inputs(cuda, b, t, c, (k,), seed=t + tile)
    before = fused_conv_chain.launches
    got = conv_layer(x, ws[0], k, tile=tile)
    torch.cuda.synchronize()
    assert fused_conv_chain.launches == before
    ok, st = _conv_agrees(got, fused_conv_chain_plain(x, ws, (k,)), layer=True)
    assert ok, st


def test_conv_plan_matches_the_library(cuda):
    import ctypes

    from speechclip_tpu_torch.kernels import _build
    from speechclip_tpu_torch.kernels.conv_frontend import CONV_TILES, conv_plan

    lib = _build.load()
    for tile in range(len(CONV_TILES)):
        stages = ctypes.c_int(0)
        smem = lib.scl_conv_chain_plan(tile, ctypes.byref(stages))
        assert (smem, stages.value) == (conv_plan(tile)["smem_bytes"], conv_plan(tile)["stages"])


# ---------------------------------------------------------------------------
# pos_conv (csrc/pos_conv.cu)
# ---------------------------------------------------------------------------
def _pos_conv_args(dev, b, t, d, seed=0):
    """x ~ N(0, 1) in bf16, w (D, D / 16, 128) with HuBERT's init scale, a
    bias in f32 (the model's params before the cast)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, t, d, generator=g, device=dev).bfloat16()
    w = (0.02 * torch.randn(d, d // 16, 128, generator=g, device=dev)).bfloat16()
    return x, w, 0.1 * torch.randn(d, generator=g, device=dev)


def _pos_conv_agrees(got, want, x):
    from speechclip_tpu_torch.kernels.pos_conv import pos_conv_agreement, pos_conv_agrees

    st = pos_conv_agreement(got, want, x)
    return pos_conv_agrees(st), st


@pytest.mark.parametrize("b, t, d", [
    (256, 319, 768),  # the encode cell's batch (HuBERT-base)
    (256, 319, 1024), (256, 299, 1024), (256, 199, 1024),  # the large train cell's buckets
    (32, 849, 768), (32, 849, 1024),  # a served 17 s batch
    (3, 130, 768), (2, 65, 1024), (4, 64, 768), (5, 1, 768), (2, 321, 1024),  # ragged T
])
def test_pos_conv_kernel_matches_plain(cuda, b, t, d):
    """The op on the card against its plain version (cuDNN's grouped conv,
    then the bias, GELU and residual passes): one launch a call, the
    output's shape and dtype, ``pos_conv_agrees`` and the layer limits."""
    from speechclip_tpu_torch.kernels.pos_conv import pos_conv, pos_conv_plain

    x, w, bias = _pos_conv_args(cuda, b, t, d, seed=t)
    before = pos_conv.launches
    got = pos_conv(x, w, bias)
    torch.cuda.synchronize()
    assert pos_conv.launches == before + 1
    want = pos_conv_plain(x, w, bias)
    ok, st = _pos_conv_agrees(got, want, x)
    assert ok, st
    _close(got, want)


def test_pos_conv_launches_count_the_calls(cuda):
    """``pos_conv.launches`` counts each call on the card once, and no
    call at B = 0."""
    from speechclip_tpu_torch.kernels.pos_conv import pos_conv

    x, w, bias = _pos_conv_args(cuda, 2, 100, 768)
    before = pos_conv.launches
    for _ in range(3):
        pos_conv(x, w, bias)
    assert pos_conv(x[:0], w, bias).shape == (0, 100, 768)
    torch.cuda.synchronize()
    assert pos_conv.launches == before + 3


@pytest.mark.parametrize("fault", ["no conv rounding", "taps shifted by one"])
def test_pos_conv_check_fails_planted_faults(cuda, fault):
    """The check passes the sound plain version and fails one without the
    conv's bf16 rounding (the f32 sum straight into the bias add) and one
    whose taps are shifted by one step."""
    import torch.nn.functional as F

    from speechclip_tpu_torch.kernels.pos_conv import pos_conv, pos_conv_plain

    x, w, bias = _pos_conv_args(cuda, 8, 319, 768, seed=3)
    got = pos_conv(x, w, bias)
    assert _pos_conv_agrees(got, pos_conv_plain(x, w, bias), x)[0]
    if fault == "no conv rounding":
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            y = F.conv1d(x.float().transpose(1, 2), w.float(), padding=64, groups=16)
        y = (y + bias.bfloat16().float()[None, :, None])[:, :, :-1].bfloat16()
        want = x + F.gelu(y.transpose(1, 2), approximate="tanh")
    else:
        want = pos_conv_plain(x, torch.roll(w, 1, dims=2), bias)
    ok, st = _pos_conv_agrees(got, want, x)
    assert not ok, st


def test_pos_conv_plan_matches_the_library(cuda):
    """The wrapper's shared-memory formula is the kernel's (the CPU tests
    hold it to two blocks an SM)."""
    from speechclip_tpu_torch.kernels import _build
    from speechclip_tpu_torch.kernels.pos_conv import MAX_WARPS, WIDTHS, smem_bytes

    lib = _build.load()
    for c in WIDTHS:
        for warps in range(1, MAX_WARPS + 1):
            assert lib.scl_pos_conv_smem_bytes(c, warps) == smem_bytes(c, warps)


def test_pos_conv_raises_on_what_it_does_not_take(cuda):
    from speechclip_tpu_torch.kernels.pos_conv import pos_conv

    x, w, bias = _pos_conv_args(cuda, 1, 50, 768)
    with pytest.raises(TypeError, match="bf16"):
        pos_conv(x.float(), w, bias)
    with pytest.raises(ValueError, match="C in"):
        pos_conv(x[..., :512], w[:512, :32], bias[:512])
    with pytest.raises(ValueError, match="C in"):
        pos_conv(x, w[..., :64], bias)


def test_pos_conv_gradient_is_the_plain_versions(cuda):
    """With an input that requires grad: the kernel forward, the plain
    version's gradients bit for bit (``PosConvFn``), one recompute. cuDNN's
    conv backward may sum in a run-dependent order: both sides run it
    deterministic."""
    from speechclip_tpu_torch.kernels.pos_conv import pos_conv, pos_conv_plain

    x, w, bias = _pos_conv_args(cuda, 2, 319, 768)
    g = torch.randn(x.shape, device=cuda).bfloat16()
    leaves = [t.detach().requires_grad_(True) for t in (x, w, bias)]
    plain = [t.detach().requires_grad_(True) for t in (x, w, bias)]
    before = (pos_conv.launches, pos_conv.recomputes)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True):
        got = torch.autograd.grad(pos_conv(*leaves), leaves, g)
        want = torch.autograd.grad(pos_conv_plain(*plain), plain, g)
    assert (pos_conv.launches, pos_conv.recomputes) == (before[0] + 1, before[1] + 1)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d, dtype, plain, launches", [
    (768, torch.bfloat16, False, 1), (1024, torch.bfloat16, False, 1),
    (768, torch.float32, False, 0), (768, torch.bfloat16, True, 0), (512, torch.bfloat16, False, 0),
])
def test_hubert_routes_pos_conv(cuda, d, dtype, plain, launches):
    """``pos_conv_residual``: the kernel for bf16 at HuBERT-base's and
    -large's widths, the model's own code for f32, ``plain`` and other
    widths; both routes agree."""
    import dataclasses

    from speechclip_tpu_torch.kernels.pos_conv import pos_conv
    from speechclip_tpu_torch.models.hubert import HUBERT_BASE, pos_conv_apply, pos_conv_residual

    cfg = dataclasses.replace(HUBERT_BASE, encoder_embed_dim=d)
    x, w, bias = _pos_conv_args(cuda, 4, 199, d, seed=d)
    params = {"w": w, "b": bias}
    x = x.to(dtype)
    before = pos_conv.launches
    got = pos_conv_residual(params, cfg, x, plain)
    torch.cuda.synchronize()
    assert pos_conv.launches == before + launches
    want = x + pos_conv_apply(params, cfg, x)
    if launches:
        assert _pos_conv_agrees(got, want, x)[0]
    else:
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the kernels as custom ops (kernels/_ops.py) and in an exported graph
# ---------------------------------------------------------------------------
def _op_cases(dev, b):
    """name -> (the op's arguments, the plain version) for each kernel at
    batch ``b`` at a shape of its main path."""
    from speechclip_tpu_torch.kernels import attention_vmem as av
    from speechclip_tpu_torch.kernels import conv_frontend as cf
    from speechclip_tpu_torch.kernels import ffn_block as fb
    from speechclip_tpu_torch.kernels import flash_attention as fa
    from speechclip_tpu_torch.kernels import mha_block as mb
    from speechclip_tpu_torch.kernels import pos_conv as pc

    x, w_in, b_in, w_out, b_out, ln_g, ln_b, lens, heads, mode, eps = _mha_args(
        dev, max(b, 1), 319, 768, 12, "post", True)
    x, lens = x[:b], lens[:b]
    g = torch.Generator(device=dev).manual_seed(1)
    w1 = (torch.randn(768, 3072, generator=g, device=dev) * 768 ** -0.5).bfloat16()
    w2 = (torch.randn(3072, 768, generator=g, device=dev) * 3072 ** -0.5).bfloat16()
    b1 = 0.1 * torch.randn(3072, generator=g, device=dev)
    q, k, v, qlens = _qkv(dev, max(b, 1), 12, 849, 849, 64, seed=2, packed=True)
    tq, tk, tv, _ = _qkv(dev, max(b, 1), 8, 77, 77, 64, seed=3, dtype=torch.float32)
    cx, cws = _conv_inputs(dev, max(b, 1), 2100, 512, (3, 3, 2), seed=4)
    px, pw, pb = _pos_conv_args(dev, max(b, 1), 319, 768, seed=5)
    return {
        "mha_layer_block": ((x, w_in, b_in, w_out, b_out, ln_g, ln_b, lens, heads, mode, eps),
                            mb.mha_layer_block_plain),
        "ffn_block": ((x, w1, b1, w2, b_out, ln_g, ln_b, mode, eps), fb.ffn_block_plain),
        "attention_vmem": ((q[:b], k[:b], v[:b], qlens[:b], False), av.attention_vmem_plain),
        "flash_attention": ((q[:b], k[:b], v[:b], qlens[:b], False), fa.flash_attention_plain),
        "flash_attention f32": ((tq[:b], tk[:b], tv[:b], None, True), fa.flash_attention_plain),
        "fused_conv_chain": ((cx[:b], cws, [3, 3, 2]), cf.fused_conv_chain_plain),
        "pos_conv": ((px[:b], pw, pb), pc.pos_conv_plain),
    }


def _counter(name):
    from chip_smoke import _counters
    from speechclip_tpu_torch.kernels.pos_conv import pos_conv

    return {**_counters(), "pos_conv": pos_conv}[name.split()[0]]


@pytest.mark.parametrize("name", ["mha_layer_block", "ffn_block", "attention_vmem",
                                  "flash_attention", "flash_attention f32", "fused_conv_chain",
                                  "pos_conv"])
def test_zero_rows_return_the_plain_empty_output(cuda, name):
    """B = 0 (a custom op's fake implementation admits it): the op returns
    the plain version's empty output, with no launch and no count (it was
    ``CUDA error 9``, an empty launch grid)."""
    args, plain = _op_cases(cuda, 0)[name]
    counter = _counter(name)
    before = counter.launches
    got = getattr(torch.ops.speechclip, name.split()[0])(*args)
    torch.cuda.synchronize()
    want = plain(*args)
    assert counter.launches == before
    assert got.shape == want.shape and got.dtype == want.dtype and got.numel() == 0
    assert got.device == want.device


def test_clip_wrapper_encodes_no_captions_under_pallas(cuda, tmp_path):
    """``ClipWrapper.prep_text([])`` then ``encode_text`` under "pallas":
    (0, 512) f32, as the plain path gives, no flash launch."""
    import chip_smoke
    from speechclip_tpu_torch.kernels.flash_attention import flash_attention
    from speechclip_tpu_torch.models import clip as clip_mod
    from speechclip_tpu_torch.models.clip_api import ClipWrapper
    from speechclip_tpu_torch.models.tokenizer import CLIPTokenizer
    from speechclip_tpu_torch.ops.attention import attention_backend

    tok = CLIPTokenizer(chip_smoke.write_synthetic_merges(str(tmp_path / "m.txt.gz")))
    clip = ClipWrapper("ViT-B/32", tokenizer=tok, seed=0)
    ids, eot = clip.prep_text([])
    before = flash_attention.launches
    with attention_backend("pallas"):
        got = clip.encode_text(ids, eot)
        torch.cuda.synchronize()
        want = clip_mod.encode_text(clip.params, clip.cfg.text, ids, eot, plain=True)
    assert flash_attention.launches == before
    assert got.shape == want.shape == (0, 512) and got.dtype == want.dtype == torch.float32


@pytest.mark.parametrize("name", ["mha_layer_block", "ffn_block", "attention_vmem",
                                  "flash_attention", "flash_attention f32", "fused_conv_chain",
                                  "pos_conv"])
def test_each_op_is_bitwise_the_wrappers_kernel(cuda, name):
    """``torch.ops.speechclip.<kernel>`` on the card is the kernel module's
    CUDA implementation, bit for bit, and counts one launch."""
    import importlib

    module = {"mha_layer_block": "mha_block", "fused_conv_chain": "conv_frontend"}.get(
        name.split()[0], name.split()[0])
    cuda_impl = getattr(importlib.import_module(f"speechclip_tpu_torch.kernels.{module}"),
                        f"{name.split()[0]}_cuda")
    args, _ = _op_cases(cuda, 2)[name]
    counter = _counter(name)
    before = counter.launches
    got = getattr(torch.ops.speechclip, name.split()[0])(*args)
    assert counter.launches == before + 1
    want = cuda_impl(*args)
    torch.cuda.synchronize()
    assert got.stride() == want.stride() and torch.equal(got, want)


def _phase2_rows(dev):
    """(label, op name, args) at every shape phase 2 of chip_smoke.py
    launches a kernel at."""
    import chip_smoke as cs

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    layers = {"hubert": dict(cs.HUBERT_SHAPE, mode="post"), "branch": dict(cs.BRANCH_SHAPE,
                                                                          mode="post"),
              "vit-l/14": dict(cs.VIT_L14_SHAPE, mode="none")}
    layers.update({k: dict(v, mode="post") for k, v in cs.REPAIR_SHAPES.items()})
    layers.update(cs.LARGE_LAYER_SHAPES)
    for label, shape in layers.items():
        x, lens, mha, ffn = cs._layer_inputs(shape, gen)
        rows.append((label, "mha_layer_block", (x, *mha.values(), lens, shape["heads"],
                                                shape["mode"], 1e-5)))
        rows.append((label, "ffn_block", (x, *ffn.values(), shape["mode"], 1e-5)))
    attention = [(f"{name} {label}", name, spec, None)
                 for name, specs in cs.ATTENTION_SHAPES.items() for label, spec in specs.items()]
    attention += [(f"gallery {label}", "flash_attention", spec, None)
                  for label, spec in cs.GALLERY_FLASH_SHAPES.items()]
    attention += [("large 1024", "flash_attention", cs.LARGE_FLASH_SHAPE, None),
                  ("large 1024 f32", "flash_attention", cs.LARGE_FLASH_SHAPE, torch.float32),
                  ("text f32", "flash_attention", cs.TEXT_F32_FLASH_SHAPE, torch.float32)]
    for label, name, (b, h, l, dh, with_lens, causal, packed), dtype in attention:
        q, k, v, lens = cs._attention_inputs(b, h, l, dh, with_lens, packed, gen, dtype)
        rows.append((label, name, (q, k, v, lens, causal)))
    x, ws = cs._conv_inputs(gen)
    rows.append(("conv chain", "fused_conv_chain", (x, ws, list(cs.CONV_KERNELS))))
    for label, (b, t, d) in cs.POS_CONV_SHAPES.items():
        rows.append((label, "pos_conv", _pos_conv_args(dev, b, t, d, seed=t)))
    return rows


def test_fake_shapes_equal_real_shapes_at_phase_2_rows(cuda):
    """Each op's fake implementation (what ``torch.export`` traces with)
    gives the shape, dtype, strides and device of its CUDA implementation's
    output at every row of phase 2."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._pytree import tree_map

    for label, name, args in _phase2_rows(cuda):
        op = getattr(torch.ops.speechclip, name)
        real = op(*args)
        with FakeTensorMode(allow_non_fake_inputs=False) as mode:
            fake_args = tree_map(lambda a: mode.from_tensor(a) if torch.is_tensor(a) else a,
                                 args)
            fake = op(*fake_args)
        got = (tuple(fake.shape), fake.dtype, fake.stride(), fake.device)
        want = (tuple(real.shape), real.dtype, real.stride(), real.device)
        assert got == want, (label, name, got, want)
        del real
    torch.cuda.synchronize()


class _Layer(torch.nn.Module):
    """One HuBERT post-norm layer on the fused path (``mha_layer_block`` +
    ``ffn_block``), its weights as buffers."""

    def __init__(self, dev):
        super().__init__()
        cases = _op_cases(dev, 1)
        mha, ffn = cases["mha_layer_block"][0], cases["ffn_block"][0]
        for i, t in enumerate(mha[1:7] + ffn[1:5]):
            self.register_buffer(f"w{i}", t.clone())
        x, lens = mha[0], mha[7]
        self.example = (torch.cat([x, x.flip(0)]), torch.cat([lens, lens.flip(0)]))

    def forward(self, x, lens):
        from speechclip_tpu_torch.kernels.ffn_block import ffn_block
        from speechclip_tpu_torch.kernels.mha_block import mha_layer_block

        w = [getattr(self, f"w{i}") for i in range(10)]
        h = mha_layer_block(x, *w[:6], lens, 12, "post", 1e-5)
        return ffn_block(h, w[6], w[7], w[8], w[9], w[4], w[5], "post", 1e-5)


def test_an_exported_artifact_runs_its_kernels_on_the_card(cuda):
    """A layer exported on the card and loaded back holds one node per
    kernel, launches each once a call, and equals the direct call bitwise;
    the planted fault, the same graph with ``mha_layer_block`` decomposed
    into its plain version, fails the node count."""
    import io

    from speechclip_tpu_torch.export import kernel_nodes, load_program
    from speechclip_tpu_torch.kernels.ffn_block import ffn_block
    from speechclip_tpu_torch.kernels.mha_block import mha_layer_block, mha_layer_block_plain

    layer = _Layer(cuda)
    x, lens = layer.example
    program = torch.export.export(layer, (x, lens))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    loaded = load_program(buf.getvalue())
    expected = {"mha_layer_block": 1, "ffn_block": 1}
    assert kernel_nodes(loaded) == expected
    before = (mha_layer_block.launches, ffn_block.launches)
    got = loaded.module()(x, lens)
    assert (mha_layer_block.launches, ffn_block.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got, layer(x, lens))
    decomposed = program.run_decompositions(
        {torch.ops.speechclip.mha_layer_block.default: mha_layer_block_plain})
    assert kernel_nodes(decomposed) != expected
    assert kernel_nodes(decomposed) == {"ffn_block": 1}


def test_an_artifact_moves_between_the_cpu_and_the_card(cuda):
    """``load_exported(..., device=)``: the layer exported on the CPU runs
    its kernels on the card (one launch each, bitwise the layer's direct
    call there), and exported on the card it runs the plain versions on the
    CPU (bitwise the direct call on the CPU)."""
    import copy
    import io

    from speechclip_tpu_torch.export import load_exported
    from speechclip_tpu_torch.kernels.ffn_block import ffn_block
    from speechclip_tpu_torch.kernels.mha_block import mha_layer_block

    layer = _Layer(cuda)
    x, lens = layer.example
    on_cpu = copy.deepcopy(layer).to("cpu")
    blobs = {}
    for device, module, args in (("cpu", on_cpu, (x.cpu(), lens.cpu())), ("cuda", layer, (x, lens))):
        buf = io.BytesIO()
        torch.export.save(torch.export.export(module, args), buf)
        blobs[device] = buf.getvalue()
    before = (mha_layer_block.launches, ffn_block.launches)
    got = load_exported(blobs["cpu"], device=cuda)(x, lens)
    assert got.device.type == "cuda"
    assert (mha_layer_block.launches, ffn_block.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got, layer(x, lens))
    got = load_exported(blobs["cuda"], device="cpu")(x.cpu(), lens.cpu())
    assert got.device.type == "cpu" and torch.equal(got, on_cpu(x.cpu(), lens.cpu()))


@pytest.mark.parametrize("precision", [32, "bf16"])
def test_a_speech_artifact_moves_between_the_cpu_and_the_card_only_in_f32(cuda, precision):
    """A tiny speech artifact, HuBERT's conv front end and positional conv
    included. In f32 its trace takes no device branch: exported on either
    device and moved to the other, it is bitwise the direct call there.
    Under bf16 compute the convolutions branch on the device (an f32 upcast
    on the CPU, cuDNN's bf16 convolution on the card), the graph keeps the
    traced branch, and each move raises."""
    import dataclasses

    from speechclip_tpu_torch.config import tiny_config
    from speechclip_tpu_torch.export import export_encode_speech, load_exported
    from speechclip_tpu_torch.models.speechclip import SpeechCLIPModel, cast_params

    cfg = dataclasses.replace(tiny_config(), precision=precision)
    params, state = SpeechCLIPModel(cfg, device="cpu").init(0)
    gen = torch.Generator().manual_seed(0)
    wav, wav_len = torch.randn(2, 2000, generator=gen), torch.tensor([2000, 1500], dtype=torch.int32)
    blobs, direct = {}, {}
    for dev in ("cpu", "cuda"):
        model = SpeechCLIPModel(cfg, device=dev)
        p, s = (cast_params(t, model.compute_dtype, dev) for t in (params, state))
        blobs[dev] = export_encode_speech(model, p, s, 2, 2000)
        direct[dev] = model.encode_speech(p, s, wav.to(dev), wav_len.to(dev))
    for source, target in (("cpu", "cuda"), ("cuda", "cpu")):
        if precision == "bf16":
            with pytest.raises(ValueError, match=f"traced on {source} through branches that "
                                                 r"depend on the device \(kernels/pos_conv\.py "
                                                 r"pos_conv_term, models/hubert\.py"):
                load_exported(blobs[source], device=target)
            continue
        got = load_exported(blobs[source], device=target)(wav.to(target), wav_len.to(target))
        assert sorted(got) == sorted(k for k in direct[target] if k != "vq_results")
        for key in got:
            assert got[key].device.type == target
            assert torch.equal(got[key], direct[target][key]), (source, target, key)
