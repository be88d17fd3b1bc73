"""The check by which an attention kernel's bf16 output is held to its plain
version (``attention_agreement`` / ``attention_agrees``), on the CPU.

A sound change of summation order must pass it: each plain version is
recomputed in float64 at the same rounding points and compared with the f32
one. The faults a kernel could hide under a loose absolute limit must fail
it: a key mask one key too long, another kernel's rounding points, and P V
through bf16 p alone in the f32 flash kernel. ``faulty_plain`` is shared
with the GPU tests, which plant the same faults against the kernels.

Inputs: B = 4, H = 4, L = S = 300, Dh = 64, key lengths drawn from
[S/2, S - 1], bf16, from a seeded generator. This file imports torch only.
"""

import math

import pytest
import torch

from speechclip_tpu_torch.kernels._attention_common import (
    attention_agreement,
    attention_agrees,
    key_mask,
)
from speechclip_tpu_torch.kernels._sdpa_ref import NEG_INF, masked_sdpa
from speechclip_tpu_torch.kernels.attention_vmem import attention_vmem_plain
from speechclip_tpu_torch.kernels.flash_attention import flash_attention_plain

torch.set_num_threads(2)

FAULTS = ["lens_off_by_one", "mha_rounding", "bf16_p"]


def faulty_plain(kernel: str, fault: str, q, k, v, lens, causal=False):
    """The plain version of ``kernel`` ("attention_vmem" or
    "flash_attention") with one planted fault."""
    if fault == "lens_off_by_one":  # col > len masked instead of col >= len
        plain = attention_vmem_plain if kernel == "attention_vmem" else flash_attention_plain
        return plain(q, k, v, (lens + 1).clamp(max=k.shape[2]), causal)
    if fault == "mha_rounding":  # f32 softmax normalized, then rounded
        assert kernel == "attention_vmem" and not causal
        return masked_sdpa(q, k, v, lens)
    assert fault == "bf16_p" and kernel == "flash_attention"
    s = (q.float() * (1.0 / math.sqrt(q.shape[-1]))) @ k.float().transpose(-1, -2)
    ok = key_mask(lens, causal, q.shape[2], k.shape[2], q.device)
    if ok is not None:
        s = s.masked_fill(~ok, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    acc = p.to(torch.bfloat16).float() @ v.float()
    return (acc / p.sum(dim=-1, keepdim=True).clamp(min=1e-30)).to(q.dtype)


def _f64_plain(kernel: str, q, k, v, lens, causal=False):
    """The plain version at its own rounding points, summed in float64."""
    ok = key_mask(lens, causal, q.shape[2], k.shape[2], q.device)
    if kernel == "attention_vmem":
        scale = torch.full((), 1.0 / math.sqrt(q.shape[-1]), dtype=q.dtype)
        s = (q * scale).double() @ k.double().transpose(-1, -2)
    else:
        s = (q.double() * (1.0 / math.sqrt(q.shape[-1]))) @ k.double().transpose(-1, -2)
    if ok is not None:
        s = s.masked_fill(~ok, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    if kernel == "attention_vmem":
        p = p.to(q.dtype).double()
    return ((p @ v.double()) / p.sum(dim=-1, keepdim=True).clamp(min=1e-30)).to(q.dtype)


def _inputs(seed=0, b=4, h=4, l=300, dh=64):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, h, l, dh, generator=g).bfloat16() for _ in range(3))
    lens = torch.randint(l // 2, l, (b,), generator=g).to(torch.int32)
    return q, k, v, lens


PLAINS = {"attention_vmem": attention_vmem_plain, "flash_attention": flash_attention_plain}


@pytest.mark.parametrize("kernel", sorted(PLAINS))
@pytest.mark.parametrize("causal", [False, True])
def test_another_summation_order_agrees(kernel, causal):
    q, k, v, lens = _inputs()
    want = PLAINS[kernel](q, k, v, lens, causal)
    stats = attention_agreement(_f64_plain(kernel, q, k, v, lens, causal), want)
    assert attention_agrees(stats), stats
    assert attention_agrees(attention_agreement(want, want))


@pytest.mark.parametrize("kernel, fault", [
    ("attention_vmem", "lens_off_by_one"),
    ("attention_vmem", "mha_rounding"),
    ("flash_attention", "lens_off_by_one"),
    ("flash_attention", "bf16_p"),
])
def test_planted_faults_fail_the_check(kernel, fault):
    q, k, v, lens = _inputs(seed=1)
    stats = attention_agreement(faulty_plain(kernel, fault, q, k, v, lens),
                                PLAINS[kernel](q, k, v, lens))
    assert not attention_agrees(stats), stats


def test_agreement_numbers():
    want = torch.tensor([[0.5, -0.25, 0.125, 0.0], [1.0, 2.0, 0.0, 0.0]]).bfloat16()
    got = want.clone()
    got[0, 0] = 0.5 + 2**-8  # one ulp at 0.5: 2^-8 = 1 * 2^-7 * max|row| (0.5)
    stats = attention_agreement(got, want)
    assert stats["max_abs_err"] == 2**-8
    assert stats["row_ulps"] == 1.0
    assert stats["mismatch"] == 1 / 8
    assert stats["finite"] and attention_agrees(dict(stats, mismatch=0.0))
    got[1, 0] = float("nan")
    assert not attention_agrees(attention_agreement(got, want))


@pytest.mark.parametrize("causal", [False, True])
def test_f32_outputs_agree_under_another_summation_order(causal):
    """flash_attention's f32 form is held to F32_MAX_ABS and the cosine: a
    float64 re-summation of the plain version passes, every bit may differ."""
    q, k, v, lens = (t.float() if t.is_floating_point() else t for t in _inputs(seed=2))
    want = flash_attention_plain(q, k, v, lens, causal)
    stats = attention_agreement(_f64_plain("flash_attention", q, k, v, lens, causal), want)
    assert stats["f32"] and attention_agrees(stats), stats


@pytest.mark.parametrize("fault", ["lens_off_by_one", "bf16_p"])
def test_f32_planted_faults_fail_the_check(fault):
    """In f32 a mask one key too long fails, and so does p rounded to bf16
    for P V (what the bf16 kernel's tensor cores would do to f32 inputs)."""
    q, k, v, lens = (t.float() if t.is_floating_point() else t for t in _inputs(seed=3))
    stats = attention_agreement(faulty_plain("flash_attention", fault, q, k, v, lens),
                                flash_attention_plain(q, k, v, lens))
    assert stats["f32"] and not attention_agrees(stats), stats
