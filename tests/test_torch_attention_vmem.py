"""The port's plain ``attention_vmem`` against the JAX Pallas kernel, run in
interpret mode on the CPU (``_forward``, as tests/test_kernels.py runs it),
at the model's head layouts: H/Dh = 12/64 (HuBERT-base), 8/96 (the parallel
branch) and 4/128 (the large branch's head width); B = 2, L = S in {128,
160} and one cross shape L != S, with key lengths, without, and causal with
key lengths; in f32 and bf16. Also the gate ``vmem_eligible`` against the
JAX gate, and the CPU wrapper's routing.

Tolerances: f32 — max abs diff <= 1e-4 (same math in f32; only summation
order differs). bf16 — per-row cosine >= 0.999 and max abs diff <= 0.0625:
the rounding points are the same (bf16 q * bf16 scale, bf16 p, f32 sums),
but another summation order can flip a bf16 rounding of p (2^-8 relative).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from speechclip_tpu.kernels import attention_vmem as jav
from speechclip_tpu_torch.kernels import attention_vmem as pav

torch.set_num_threads(2)

F32_ATOL = 1e-4
BF16_ATOL = 0.0625
MIN_COSINE = 0.999
HEADS = [(12, 64), (8, 96), (4, 128)]
MASKS = ["lens", "none", "causal"]


def make_qkv(b, h, l, s, dh, seed, mask):
    """(q, k, v) as f32 numpy, lens (or None) and the causal flag."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, n, dh)).astype(np.float32) for n in (l, s, s))
    lens = np.array([s, s // 2 + 1], np.int32)[:b] if mask != "none" else None
    return q, k, v, lens, mask == "causal"


def to_jax(x, dtype):
    return jnp.asarray(x).astype(jnp.float32 if dtype == "float32" else jnp.bfloat16)


def to_torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def assert_close(got: torch.Tensor, want, dtype):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    if dtype == "float32":
        assert err <= F32_ATOL, err
        return
    a, b = got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-12)
    assert cos.min() >= MIN_COSINE, cos.min()
    assert err <= BF16_ATOL, err


def run_both(jax_fn, port_fn, shape, mask, dtype, seed):
    q, k, v, lens, causal = make_qkv(*shape, seed=seed, mask=mask)
    want = jax_fn(
        to_jax(q, dtype), to_jax(k, dtype), to_jax(v, dtype),
        None if lens is None else jnp.asarray(lens), causal,
    )
    got = port_fn(
        to_torch(q, dtype), to_torch(k, dtype), to_torch(v, dtype),
        None if lens is None else torch.from_numpy(lens), causal,
    )
    assert got.dtype == getattr(torch, dtype)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", [128, 160])
@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("heads, dh", HEADS)
def test_plain_matches_jax_kernel(heads, dh, mask, length, dtype):
    run_both(
        lambda *a: jav._forward(*a, group=2, interpret=True), pav.attention_vmem_plain,
        (2, heads, length, length, dh), mask, dtype, seed=heads + length,
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mask", ["lens", "causal"])
def test_plain_matches_jax_kernel_cross_shape(mask, dtype):
    run_both(
        lambda *a: jav._forward(*a, group=2, interpret=True), pav.attention_vmem_plain,
        (2, 8, 96, 176, 96), mask, dtype, seed=7,
    )


def test_rounding_points_differ_from_masked_sdpa():
    """bf16 p rounded before the normalization is not masked_sdpa's
    normalize-then-round: the plain version must not be the shared core."""
    from speechclip_tpu_torch.kernels._sdpa_ref import masked_sdpa

    q, k, v, lens, _ = make_qkv(2, 8, 128, 128, 96, seed=3, mask="lens")
    args = [to_torch(x, "bfloat16") for x in (q, k, v)] + [torch.from_numpy(lens)]
    assert not torch.equal(pav.attention_vmem_plain(*args), masked_sdpa(*args))


@pytest.mark.parametrize("b, h, l, s, d, itemsize", [
    (16, 12, 849, 849, 64, 2), (16, 8, 850, 850, 96, 2), (16, 12, 934, 934, 64, 2),
    (16, 12, 935, 935, 64, 2), (2, 12, 849, 849, 64, 4), (3, 1, 300, 300, 64, 2),
    (64, 8, 77, 77, 64, 2), (1, 2, 128, 128, 128, 2), (1, 2, 127, 129, 136, 2),
    (4, 12, 127, 128, 64, 2), (4, 12, 128, 128, 72, 2), (2, 8, 600, 600, 100, 2),
])
def test_gate_matches_jax(b, h, l, s, d, itemsize):
    assert pav.vmem_eligible(b, h, l, s, d, itemsize) == jav.vmem_eligible(b, h, l, s, d, itemsize)
    assert pav._group_size(b * h, l, s, d, itemsize) == jav._group_size(b * h, l, s, d, itemsize)


def test_whole_row_kernel_holds_every_admitted_row():
    """The kernel's shared-memory plan depends on the head dim alone (it
    streams K twice and keeps its scores in registers), so it holds the
    longest row the gate admits (L = S <= 934) and any longer one, with at
    least two blocks per SM at every admitted head dim."""
    import inspect

    from speechclip_tpu_torch.kernels._attention_common import SMEM_LIMIT

    assert pav.vmem_eligible(16, 12, 934, 934, 64) and not pav.vmem_eligible(16, 12, 935, 935, 64)
    assert list(inspect.signature(pav.smem_bytes).parameters) == ["dh"]
    assert not hasattr(pav, "max_keys")
    for dh in range(8, 129, 8):
        assert 2 * pav.smem_bytes(dh) <= 228 * 1024
        assert pav.smem_bytes(dh) <= SMEM_LIMIT
    assert pav.smem_bytes(64) == (64 + 4 * 64) * 72 * 2  # 45 KB: 4 blocks per SM
    assert pav.smem_bytes(128) == (64 + 4 * 64) * 136 * 2  # 85 KB: 2 blocks per SM


def test_cpu_wrapper_takes_plain_path_without_counting():
    q, k, v, lens, _ = make_qkv(2, 4, 64, 64, 32, seed=1, mask="lens")
    args = [torch.from_numpy(x) for x in (q, k, v, lens)]
    before = pav.attention_vmem.launches
    torch.testing.assert_close(pav.attention_vmem(*args, causal=True),
                               pav.attention_vmem_plain(*args, causal=True), rtol=0, atol=0)
    assert pav.attention_vmem.launches == before


def test_fully_masked_row_is_the_mean_of_v():
    q, k, v, _, _ = make_qkv(2, 2, 16, 24, 8, seed=2, mask="none")
    out = pav.attention_vmem_plain(*(torch.from_numpy(x) for x in (q, k, v)),
                                   torch.tensor([0, 24], dtype=torch.int32))
    torch.testing.assert_close(out[0], torch.from_numpy(v[0]).mean(dim=1, keepdim=True)
                               .expand(2, 16, 8), rtol=0, atol=1e-6)


def test_non_cpu_non_cuda_tensors_raise():
    x = torch.empty(2, 2, 16, 8, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pav.attention_vmem(x, x, x)
