"""The port's plain ``flash_attention`` against the JAX Pallas kernel, run in
interpret mode on the CPU (``_flash_forward``), over the grid of
tests/test_torch_attention_vmem.py (H/Dh = 12/64, 8/96, 4/128; L = S in
{128, 160}; one cross shape; key lengths, none, causal with key lengths; f32
and bf16), plus rows that are not a multiple of the TPU's 128-row block,
the CLIP text tower's causal L = 77 and K + 2 = 10, ViT-B/32's 50 rows
without key lengths, and the cascaded
branch's single 768-wide head with key lengths (the TPU kernel pads no
head dim away: Dh = 768 is six of its 128-lane blocks).

Tolerances are those of tests/test_torch_attention_vmem.py. The JAX kernel
works in f32 throughout and rounds once, as the port's plain version does,
so in bf16 the outputs differ only by the final rounding (a flipped last
bit), well inside them.
"""

import pytest
import torch

from speechclip_tpu.kernels import flash_attention as jfa
from speechclip_tpu_torch.kernels import flash_attention as pfa
from tests.test_torch_attention_vmem import HEADS, MASKS, make_qkv, run_both

torch.set_num_threads(2)


def jax_flash(q, k, v, lens, causal):
    return jfa._flash_forward(q, k, v, lens, causal, interpret=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", [128, 160])
@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("heads, dh", HEADS)
def test_plain_matches_jax_kernel(heads, dh, mask, length, dtype):
    run_both(jax_flash, pfa.flash_attention_plain, (2, heads, length, length, dh),
             mask, dtype, seed=heads + length)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape, mask", [
    ((2, 8, 96, 176, 96), "lens"),  # cross shape, L != S
    ((2, 8, 176, 96, 96), "causal"),
    ((2, 12, 100, 100, 64), "lens"),  # rows not a multiple of 128
    ((2, 12, 319, 319, 64), "lens"),  # the flash-backend HuBERT shape
    ((2, 8, 77, 77, 64), "causal"),  # the CLIP text tower
    ((2, 8, 77, 77, 64), "none"),
    ((2, 8, 10, 10, 64), "causal"),  # the text tower over K + 2 tokens
    ((2, 12, 50, 50, 64), "none"),  # the ViT-B/32 image tower under "pallas"
    ((2, 1, 75, 75, 768), "lens"),  # the cascaded branch's one head
    ((2, 1, 40, 40, 200), "lens"),  # a wide head that is not a multiple of 128
])
def test_plain_matches_jax_kernel_odd_shapes(shape, mask, dtype):
    run_both(jax_flash, pfa.flash_attention_plain, shape, mask, dtype, seed=sum(shape))


def test_causal_without_lens_matches_jax():
    q, k, v, _, _ = make_qkv(2, 8, 77, 77, 64, seed=5, mask="none")
    run_both(lambda q, k, v, lens, c: jax_flash(q, k, v, None, True),
             lambda q, k, v, lens, c: pfa.flash_attention_plain(q, k, v, None, True),
             (2, 8, 77, 77, 64), "none", "float32", seed=5)


def test_cpu_wrapper_takes_plain_path_without_counting():
    q, k, v, lens, _ = make_qkv(2, 4, 64, 80, 32, seed=1, mask="lens")
    args = [torch.from_numpy(x) for x in (q, k, v, lens)]
    before = pfa.flash_attention.launches
    torch.testing.assert_close(pfa.flash_attention(*args, causal=True),
                               pfa.flash_attention_plain(*args, causal=True), rtol=0, atol=0)
    assert pfa.flash_attention.launches == before


def test_fully_masked_row_is_the_mean_of_v():
    q, k, v, _, _ = make_qkv(2, 2, 16, 24, 8, seed=2, mask="none")
    out = pfa.flash_attention_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                    torch.tensor([0, 24], dtype=torch.int32))
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out[0], torch.from_numpy(v[0]).mean(dim=1, keepdim=True)
                               .expand(2, 16, 8), rtol=0, atol=1e-6)


def test_non_cpu_non_cuda_tensors_raise():
    x = torch.empty(2, 2, 16, 8, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pfa.flash_attention(x, x, x)


def test_smem_plan_fits_two_blocks_per_sm():
    for dh in list(range(8, 129, 8)) + [136, 768, 1024, 1152]:
        assert 2 * pfa.smem_bytes(dh) <= 228 * 1024


def test_wide_scores_scratch_covers_whole_tiles():
    """The wide kernels' f32 score scratch holds every 64 x 64 tile the
    score pass writes and the P V pass reads: L and S rounded up to 64."""
    assert pfa.wide_scores_shape(64, 1, 327, 327) == (64, 1, 384, 384)
    assert pfa.wide_scores_shape(3, 2, 64, 65) == (3, 2, 64, 128)
    assert pfa.wide_scores_shape(1, 1, 1, 1) == (1, 1, 64, 64)


def test_head_dim_rule_takes_any_width_that_divides_by_8():
    """The flash wrapper raises only on head dims the kernel cannot take
    (Dh % 8 != 0), whatever the width; ``attention_vmem`` keeps its 128."""
    from speechclip_tpu_torch.kernels._attention_common import check_head_dim

    for dh in (8, 64, 128, 136, 200, 768, 1024):
        check_head_dim(dh, "flash_attention", None)
    for dh in (100, 770):
        with pytest.raises(ValueError, match=f"head dim {dh}"):
            check_head_dim(dh, "flash_attention", None)
    with pytest.raises(ValueError, match="up to 128"):
        check_head_dim(768, "attention_vmem", 128)
