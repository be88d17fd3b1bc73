"""The op ``speechclip::pos_conv`` (``kernels/pos_conv.py``) on the CPU:
its registration and fake implementation, its plain version against the
model's own ``x + pos_conv_apply(...)`` (bitwise) and against the conv as
the model wrote it before the op, the route ``models/hubert.py`` takes and
its counters, the kernel's weight packing and tap order in float64, its
tile plan, and the gradient through ``PosConvFn``. The kernel itself runs
only on the card (``tests/test_torch_kernels_gpu.py``, marker ``gpu``);
``_encoder_prelude`` against JAX is ``tests/test_torch_hubert.py``."""

import dataclasses

import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode

from speechclip_tpu_torch.kernels import _ops
from speechclip_tpu_torch.kernels import pos_conv as pc
from speechclip_tpu_torch.models import hubert
from speechclip_tpu_torch.utils import tracing


def _cfg(d: int, **kw) -> hubert.HubertConfig:
    return dataclasses.replace(hubert.HUBERT_BASE, encoder_embed_dim=d, **kw)


def _inputs(b: int, t: int, d: int, seed: int = 0, k: int = 128, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, t, d, generator=g).to(dtype)
    w = 0.02 * torch.randn(d, d // 16, k, generator=g)
    return x, w, 0.1 * torch.randn(d, generator=g)


def _conv_as_written(x, w, b):
    """The model's pos_conv and residual as ``models/hubert.py`` wrote them
    before the op: an f32 conv of the upcast operands rounded to bf16, the
    bias add in bf16, SamePad's trim, tanh GELU, the residual add."""
    y = F.conv1d(x.transpose(1, 2).float(), w.to(x.dtype).float(), padding=64,
                 groups=16).to(x.dtype)
    y = (y + b.to(x.dtype)[None, :, None])[:, :, :-1]
    return x + F.gelu(y.transpose(1, 2), approximate="tanh")


def test_the_op_is_registered():
    assert hasattr(torch.ops.speechclip, "pos_conv")
    assert _ops.op_name(torch.ops.speechclip.pos_conv.default) == "pos_conv"


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("b, t, d", [(3, 319, 768), (0, 199, 1024), (2, 1, 1024)])
def test_the_fake_gives_the_outputs_shape_dtype_and_layout(device, b, t, d):
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = torch.empty(b, t, d, dtype=torch.bfloat16, device=device)
        w = torch.empty(d, d // 16, 128, dtype=torch.bfloat16, device=device)
        out = torch.ops.speechclip.pos_conv(x, w, torch.empty(d, device=device))
    assert (tuple(out.shape), out.dtype, out.stride(), out.device.type) == (
        (b, t, d), torch.bfloat16, x.stride(), device)


def test_the_fake_refuses_what_the_kernel_does_not_take():
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = torch.empty(2, 10, 512, dtype=torch.bfloat16, device="cuda")
        w = torch.empty(512, 32, 128, dtype=torch.bfloat16, device="cuda")
        with pytest.raises(ValueError, match="C in"):
            torch.ops.speechclip.pos_conv(x, w, torch.empty(512, device="cuda"))
        with pytest.raises(TypeError, match="bf16"):
            torch.ops.speechclip.pos_conv(x.float(), w, torch.empty(512, device="cuda"))


@pytest.mark.parametrize("d", [768, 1024])
@pytest.mark.parametrize("t", [1, 63, 64, 65, 199, 319])
@pytest.mark.parametrize("b", [0, 3])
def test_the_plain_version_is_the_models_pos_conv_bitwise(d, t, b):
    """On a CPU tensor the op, the wrapper and ``pos_conv_residual`` on
    either route are ``x + pos_conv_apply(...)`` bit for bit, and that is
    the conv as the model wrote it."""
    x, w, bias = _inputs(b, t, d, seed=t + d)
    cfg, params = _cfg(d), {"w": w, "b": bias}
    want = x + hubert.pos_conv_apply(params, cfg, x)
    assert torch.equal(want, _conv_as_written(x, w, bias))
    assert torch.equal(torch.ops.speechclip.pos_conv(x, w, bias), want)
    assert torch.equal(pc.pos_conv(x, w, bias), want)
    assert torch.equal(pc.pos_conv_plain(x, w, bias), want)
    assert torch.equal(hubert.pos_conv_residual(params, cfg, x), want)


def _fake_cuda(d: int, dtype=torch.bfloat16):
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        return torch.empty(2, 10, d, dtype=dtype, device="cuda")


@pytest.mark.parametrize("d, dtype, k, groups, device, takes", [
    (768, torch.bfloat16, 128, 16, "cuda", True),  # HuBERT-base
    (1024, torch.bfloat16, 128, 16, "cuda", True),  # HuBERT-large
    (768, torch.float32, 128, 16, "cuda", False),  # precision 32
    (768, torch.float16, 128, 16, "cuda", False),
    (512, torch.bfloat16, 128, 16, "cuda", False),  # another width
    (1280, torch.bfloat16, 128, 16, "cuda", False),
    (768, torch.bfloat16, 127, 16, "cuda", False),  # another kernel size
    (768, torch.bfloat16, 64, 16, "cuda", False),
    (768, torch.bfloat16, 128, 8, "cuda", False),  # another group count
    (768, torch.bfloat16, 128, 16, "cpu", False),  # the CPU: the model's own code
])
def test_the_route(d, dtype, k, groups, device, takes):
    x = _fake_cuda(d, dtype) if device == "cuda" else torch.zeros(2, 10, d, dtype=dtype)
    assert pc.kernel_takes(x, k, groups) is takes


@pytest.mark.parametrize("route", ["kernel", "plain"])
def test_the_counters_count_each_call_once_on_its_route(monkeypatch, route):
    """Under a profiler session each ``pos_conv_residual`` call adds one to
    ``speechclip.pos_conv.kernel`` (the op; on the CPU its plain version)
    or ``speechclip.pos_conv.plain``, and nothing to the other; ``plain``
    takes the plain route whatever the route says."""
    x, w, bias = _inputs(2, 65, 768)
    cfg, params = _cfg(768), {"w": w, "b": bias}
    monkeypatch.setattr(hubert, "kernel_takes", lambda *a: route == "kernel")
    want = x + hubert.pos_conv_apply(params, cfg, x)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        outs = [hubert.pos_conv_residual(params, cfg, x) for _ in range(3)]
        outs.append(hubert.pos_conv_residual(params, cfg, x, plain=True))
    counters = tracing.totals()["counters"]
    kernel = 3 if route == "kernel" else 0
    assert counters.get("speechclip.pos_conv.kernel", 0) == kernel
    assert counters.get("speechclip.pos_conv.plain", 0) == 4 - kernel
    assert all(torch.equal(o, want) for o in outs)


def test_the_encoder_prelude_takes_the_route_and_the_plain_flag(monkeypatch):
    """``_encoder_prelude`` sends pos_conv through ``pos_conv_residual``
    with its ``plain`` flag, inside the span ``speechclip.hubert.pos_conv``."""
    cfg = dataclasses.replace(hubert.HUBERT_BASE, encoder_embed_dim=32, encoder_layers=1,
                              encoder_ffn_dim=64, encoder_heads=2,
                              conv_layers=((32, 10, 5), (32, 3, 2)))
    params = hubert.hubert_init(torch.Generator().manual_seed(0), cfg)
    wav = torch.randn(2, 1600, generator=torch.Generator().manual_seed(1))
    lens = torch.tensor([1600, 1200])
    seen = []
    real = hubert.pos_conv_residual
    monkeypatch.setattr(hubert, "pos_conv_residual",
                        lambda p, c, x, plain=False: seen.append(plain) or real(p, c, x, plain))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        hubert._encoder_prelude(params, cfg, wav, lens)
        hubert.hubert_apply(params, cfg, wav, lens, plain=True)
    assert seen == [False, True]
    totals = tracing.totals()
    assert totals["spans"]["speechclip.hubert.pos_conv"]["calls"] == 2
    assert totals["counters"] == {"speechclip.pos_conv.plain": 2}


@pytest.mark.parametrize("c, t", [(48, 70), (64, 9)])
def test_the_packed_weight_in_the_kernels_tap_order_is_the_conv(c, t):
    """The kernel's walk in float64: for each ring stage (group g, j0, k16
    slice kk, 8 taps s) of ``pack_weight``'s blocks, tap j = j0 + 8 s reads
    the window shifted by j rows (row t - 64 + j of x, zero outside) against
    the stage's (C n, 16 ci) weight; the sum over stages is the conv."""
    d = 16 * c
    x, w, _ = _inputs(2, t, d, seed=c, dtype=torch.float64)
    w = w.bfloat16().double()
    wp = pc.pack_weight(w, c).double()
    assert wp.shape == (16, 8, c // 16, 16, c, 16) and pc.pack_weight(w, c).is_contiguous()
    xpad = F.pad(x, (0, 0, 64, 64))  # (B, T + 128, D): row t + 64 is x[t]
    got = torch.zeros(2, t, d, dtype=torch.float64)
    stage = wp.reshape(16, -1, 8, c, 16)  # ring stages in the kernel's order
    for g in range(16):
        for st in range(stage.shape[1]):
            j0, kk, half = st // (2 * (c // 16)), (st // 2) % (c // 16), st % 2
            for sl in range(8):
                j = j0 + 8 * (8 * half + sl)
                a = xpad[:, j:j + t, g * c + 16 * kk:g * c + 16 * kk + 16]
                got[:, :, g * c:(g + 1) * c] += a @ stage[g, st, sl].T
    want = F.conv1d(x.transpose(1, 2), w, padding=64, groups=16)[:, :, :-1].transpose(1, 2)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("t, plan", [
    (1, (1, 1)), (64, (1, 1)), (65, (1, 2)), (199, (1, 4)), (299, (1, 5)), (319, (1, 5)),
    (320, (1, 5)), (321, (2, 3)), (849, (3, 5)), (1000, (4, 4)),
])
def test_the_tile_plan_covers_each_utterance_once(t, plan):
    """Blocks of ``warps`` 64-row subtiles cover T with no block wholly past
    it (what the launcher checks), at most MAX_WARPS a block."""
    tiles, warps = pc.tile_plan(t)
    assert (tiles, warps) == plan
    assert 1 <= warps <= pc.MAX_WARPS
    assert tiles * warps * pc.WARP_ROWS >= t > (tiles - 1) * warps * pc.WARP_ROWS


def test_the_plan_fits_two_blocks_on_an_sm():
    """Two blocks of the largest plan share an H100 SM's 228 KB (1 KB of it
    reserved a block); csrc/pos_conv.cu's own formula is held to this one
    on the card."""
    for c in pc.WIDTHS:
        assert 2 * (pc.smem_bytes(c, pc.MAX_WARPS) + 1024) <= 233472
    assert (pc.smem_bytes(48, 5), pc.smem_bytes(64, 5)) == (105360, 113520)


def test_the_gradient_is_the_plain_versions_through_pos_conv_fn():
    """With an input that requires grad, the wrapper goes through
    ``PosConvFn``: on the CPU its forward is the plain version and its
    backward the plain version's gradients, bit for bit; one recompute."""
    x, w, bias = _inputs(2, 65, 768, dtype=torch.float32)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(3))
    leaves = [t.clone().requires_grad_(True) for t in (x, w, bias)]
    before = pc.pos_conv.recomputes
    out = pc.pos_conv(*leaves)
    assert out.grad_fn is not None and type(out.grad_fn).__name__.startswith("PosConvFn")
    got = torch.autograd.grad(out, leaves, g)
    assert pc.pos_conv.recomputes == before + 1
    plain = [t.clone().requires_grad_(True) for t in (x, w, bias)]
    want = torch.autograd.grad(pc.pos_conv_plain(*plain), plain, g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
