"""The port's attention dispatcher (``ops/attention.py``) and the gates
behind it against the JAX package.

- ``sdpa_plain`` against ``sdpa_xla``: bf16 without weights, f32 and bf16
  with weights, key-padding and additive or bool masks, a fully masked row.
- ``multi_head_attention`` against JAX's on each route: "mha_block",
  "attention_vmem", "flash_attention" (backend "pallas") and "sdpa"
  (backend "xla", ``need_weights``, an ``attn_mask``, short rows). The JAX
  side runs as tests/test_kernels.py runs it: ``_on_tpu`` monkeypatched to
  True and a one-device kernel mesh registered, so its dispatcher calls the
  Pallas kernels in interpret mode; spies on the JAX kernels show which one
  ran, and the port's ``attention_route`` must name the same.
- The gates ``block_eligible``, ``ffn_eligible`` and ``vmem_eligible``
  equal the JAX gates over a grid that holds every threshold of the
  length-dependent routes, and the route table at full base width.
- The attention core of ``mha_layer_block`` takes every T its gate admits.

Tolerances: f32 — max abs diff <= 1e-4; bf16 — per-row cosine >= 0.999 and
max abs diff <= 0.0625 (same rounding points, another summation order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speechclip_tpu.kernels import attention_vmem as jav
from speechclip_tpu.kernels import ffn_block as jffn
from speechclip_tpu.kernels import flash_attention as jfa
from speechclip_tpu.kernels import mha_block as jmb
from speechclip_tpu.ops import attention as jattn
from speechclip_tpu_torch.kernels import attention_vmem as pav
from speechclip_tpu_torch.kernels import ffn_block as pffn
from speechclip_tpu_torch.kernels import mha_block as pmb
from speechclip_tpu_torch.ops import attention as pattn
from tests.test_torch_attention_vmem import assert_close, to_jax, to_torch

torch.set_num_threads(2)

NEG = float(np.finfo(np.float32).min)


@pytest.fixture
def jax_kernels(monkeypatch):
    """JAX dispatches its Pallas kernels (interpret mode) as on one TPU;
    returns the names of the kernels it called."""
    called = []
    for mod, name in ((jmb, "mha_block"), (jav, "attention_vmem"), (jfa, "flash_attention")):
        real = getattr(mod, name)
        monkeypatch.setattr(
            mod, name, lambda *a, _r=real, _n=name, **k: called.append(_n) or _r(*a, **k)
        )
    monkeypatch.setattr(jattn, "_on_tpu", lambda: True)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    with jattn.kernel_mesh(mesh):
        yield called


def mha_params(d, seed):
    rng = np.random.default_rng(seed)
    mk = lambda *s: (rng.standard_normal(s) * s[0] ** -0.5).astype(np.float32)
    return {"in_proj": {"w": mk(d, 3 * d), "b": 0.1 * mk(3 * d)},
            "out_proj": {"w": mk(d, d), "b": 0.1 * mk(d)}}


def params_for(p, framework):
    conv = jnp.asarray if framework == "jax" else torch.from_numpy
    return {k: {kk: conv(vv) for kk, vv in v.items()} for k, v in p.items()}


# (route, b, l, s, d, heads, self-attention, masks, causal, backend, need_weights)
MHA_CASES = {
    "mha_block": (2, 130, 130, 64, 8, True, "lens", False, "auto", False),
    "mha_block_nomask": (2, 128, 128, 64, 4, True, "none", False, "auto", False),
    "attention_vmem_causal": (2, 130, 130, 64, 8, True, "lens", True, "auto", False),
    "attention_vmem_cross": (2, 128, 136, 64, 8, False, "lens", False, "auto", False),
    "flash_attention": (2, 100, 100, 64, 8, True, "lens", False, "pallas", False),
    "flash_attention_causal": (2, 77, 77, 64, 8, True, "none", True, "pallas", False),
    "sdpa_xla_backend": (2, 130, 130, 64, 8, True, "lens", False, "xla", False),
    "sdpa_weights": (2, 130, 130, 64, 8, True, "lens", False, "auto", True),
    "sdpa_attn_mask": (2, 40, 40, 64, 4, True, "attn_mask", False, "auto", False),
    "sdpa_short": (2, 50, 50, 64, 4, True, "kpm", True, "auto", False),
}
EXPECTED_KERNEL = {"mha_block": "mha_block", "attention_vmem": "attention_vmem",
                   "flash_attention": "flash_attention", "sdpa": None}


def run_mha(case, dtype, framework, plain=False):
    b, l, s, d, heads, self_attn, masks, causal, backend, need_weights = MHA_CASES[case]
    rng = np.random.default_rng(l + s + d)
    xq = rng.standard_normal((b, l, d)).astype(np.float32)
    xk = xq if self_attn else rng.standard_normal((b, s, d)).astype(np.float32)
    xv = xq if self_attn else rng.standard_normal((b, s, d)).astype(np.float32)
    lens = np.array([s, s // 2 + 1], np.int32)
    kpm = np.arange(s)[None, :] >= lens[:, None]
    attn_mask = np.triu(np.full((l, s), NEG, np.float32), 1) if masks == "attn_mask" else None
    p = mha_params(d, seed=d)
    if framework == "jax":
        conv, mod, cast = jnp.asarray, jattn, (lambda x: to_jax(x, dtype))
    else:
        conv, mod, cast = torch.from_numpy, pattn, (lambda x: to_torch(x, dtype))
    q = cast(xq)
    k, v = (q, q) if self_attn else (cast(xk), cast(xv))
    kwargs = dict(
        key_valid_lens=conv(lens) if masks == "lens" else None,
        key_padding_mask=conv(kpm) if masks == "kpm" else None,
        attn_mask=None if attn_mask is None else conv(attn_mask),
        causal=causal, need_weights=need_weights,
    )
    if framework == "torch":
        kwargs["plain"] = plain
    with mod.attention_backend(backend):
        return mod.multi_head_attention(params_for(p, framework), q, k, v, heads, **kwargs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(MHA_CASES))
def test_multi_head_attention_matches_jax_on_each_route(jax_kernels, case, dtype):
    b, l, s, d, heads, self_attn, masks, causal, backend, need_weights = MHA_CASES[case]
    isz = 4 if dtype == "float32" else 2
    route = pattn.attention_route(
        b, l, s, d, heads, isz, self_attention=self_attn, causal=causal, backend=backend,
        structured=not need_weights and masks in ("lens", "none"),
    )
    want, want_w = run_mha(case, dtype, "jax")
    assert jax_kernels == ([EXPECTED_KERNEL[route]] if EXPECTED_KERNEL[route] else [])
    assert case.startswith(route)
    got, got_w = run_mha(case, dtype, "torch")
    assert got.dtype == getattr(torch, dtype)
    assert_close(got, want, dtype)
    if need_weights:
        assert got_w.shape == want_w.shape == (b, l, s)
        np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=1e-5)
    else:
        assert got_w is None and want_w is None


def test_plain_flag_is_the_cpu_body():
    for case in ("mha_block", "attention_vmem_causal", "flash_attention"):
        torch.testing.assert_close(run_mha(case, "bfloat16", "torch")[0],
                                   run_mha(case, "bfloat16", "torch", plain=True)[0],
                                   rtol=0, atol=0)


def test_unaveraged_weights_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 20, 32)).astype(np.float32)
    p = mha_params(32, seed=2)
    lens = np.array([20, 7], np.int32)
    want = jattn.multi_head_attention(params_for(p, "jax"), *(jnp.asarray(x),) * 3, 4,
                                      key_valid_lens=jnp.asarray(lens), need_weights=True,
                                      average_attn_weights=False)
    x_t = torch.from_numpy(x)
    got = pattn.multi_head_attention(params_for(p, "torch"), x_t, x_t, x_t, 4,
                                     key_valid_lens=torch.from_numpy(lens), need_weights=True,
                                     average_attn_weights=False)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4)
    assert got[1].shape == (2, 4, 20, 20)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-5)


@pytest.mark.parametrize("dtype, weights", [("bfloat16", False), ("bfloat16", True),
                                            ("float32", True), ("float32", False)])
@pytest.mark.parametrize("masks", ["kpm", "attn_bool", "attn_add", "both"])
def test_sdpa_plain_matches_sdpa_xla(dtype, weights, masks):
    rng = np.random.default_rng(3)
    b, h, l, s, dh = 2, 4, 24, 40, 16
    q, k, v = (rng.standard_normal((b, h, n, dh)).astype(np.float32) for n in (l, s, s))
    kpm = np.arange(s)[None, :] >= np.array([s, 9])[:, None] if masks in ("kpm", "both") else None
    attn = None
    if masks in ("attn_bool", "both"):
        attn = rng.random((l, s)) < 0.3
    elif masks == "attn_add":
        attn = (0.5 * rng.standard_normal((l, s))).astype(np.float32)
    jbias = jattn.padding_bias(None if kpm is None else jnp.asarray(kpm),
                               None if attn is None else jnp.asarray(attn))
    pbias = pattn.padding_bias(None if kpm is None else torch.from_numpy(kpm),
                               None if attn is None else torch.from_numpy(attn))
    np.testing.assert_array_equal(pbias.numpy(), np.asarray(jbias))
    want, want_w = jattn.sdpa_xla(*(to_jax(x, dtype) for x in (q, k, v)), jbias, weights)
    got, got_w = pattn.sdpa_plain(*(to_torch(x, dtype) for x in (q, k, v)), pbias, weights)
    assert_close(got, want, dtype)
    if weights:
        np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=1e-5)


def test_causal_bias_and_fully_masked_rows():
    np.testing.assert_array_equal(pattn.causal_bias(7).numpy(), np.asarray(jattn.causal_bias(7)))
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 20, 32)).astype(np.float32)
    p = params_for(mha_params(32, seed=5), "torch")
    for dtype in (torch.float32, torch.bfloat16):
        for backend in ("auto", "pallas", "xla"):
            xt = torch.from_numpy(x).to(dtype)
            with pattn.attention_backend(backend):
                out, _ = pattn.multi_head_attention(p, xt, xt, xt, 4, causal=True,
                                                    key_valid_lens=torch.tensor([0, 20]))
            assert torch.isfinite(out).all()


def test_backend_switch():
    assert pattn.get_attention_backend() == "auto"
    with pattn.attention_backend("pallas"):
        assert pattn.get_attention_backend() == "pallas"
    assert pattn.get_attention_backend() == "auto"
    with pytest.raises(ValueError):
        pattn.set_attention_backend("cudnn")


GATE_T = [127, 128, 319, 320, 449, 460, 461, 477, 478, 600, 782, 783, 849, 850, 934, 935, 1000]


@pytest.mark.parametrize("d, heads", [(768, 12), (768, 8), (1024, 16), (1024, 8), (768, 1), (512, 8)])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_gates_equal_jax_gates(d, heads, itemsize):
    for b in (1, 3, 16):
        for t in GATE_T:
            assert pmb.block_eligible(b, t, d, heads, itemsize) == jmb.block_eligible(
                b, t, d, heads, itemsize), (b, t)
            assert pffn.ffn_eligible(b, t, d, 4 * d, itemsize) == jffn.ffn_eligible(
                b, t, d, 4 * d, itemsize), (b, t)
            for s in (t, t + 1, 77):
                assert pav.vmem_eligible(b, heads, t, s, d // heads, itemsize) == (
                    jav.vmem_eligible(b, heads, t, s, d // heads, itemsize)), (b, t, s)


def layer_route(b, t, d, heads, ffn_dim, dtype, backend="auto"):
    """(attention body, FFN body) of one self-attention encoder layer: the
    fused layer's gate (bf16 and ``attention_route`` = "mha_block"), with
    ``ffn_block`` where ``ffn_eligible`` admits the FFN, else the unfused
    layer's ``attention_route`` and the torch FFN chain."""
    isz = torch.finfo(dtype).bits // 8
    route = pattn.attention_route(b, t, t, d, heads, isz, backend=backend)
    if dtype == torch.bfloat16 and route == "mha_block":
        return "mha_layer_block", "ffn_block" if pffn.ffn_eligible(b, t, d, ffn_dim, isz) else "torch"
    return route, "torch"


def base_route(t):
    """The route of one base-width bf16 layer over T rows, backend "auto",
    from the table of length-dependent routes."""
    if t < 128:
        return ("sdpa", "torch")
    if t <= 477:
        return ("mha_layer_block", "ffn_block")
    if t <= 782:
        return ("mha_layer_block", "torch")
    if t <= 934:
        return ("attention_vmem", "torch")
    return ("sdpa", "torch")


@pytest.mark.parametrize("heads", [12, 8])  # HuBERT-base; the parallel branch (T + 1)
def test_route_table_at_base_width(heads):
    for t in range(100, 1101):
        for b in (16, 64):
            assert layer_route(b, t, 768, heads, 3072, torch.bfloat16, "auto") == base_route(t), t
            assert layer_route(b, t, 768, heads, 3072, torch.bfloat16, "pallas") == (
                "flash_attention", "torch")
            assert layer_route(b, t, 768, heads, 3072, torch.bfloat16, "xla") == ("sdpa", "torch")
    # 17 s of audio: HuBERT T = 849, branch 850; 12 s: 599 / 600; 6.4 s: 319 / 320
    assert layer_route(16, 849, 768, 12, 3072, torch.bfloat16) == ("attention_vmem", "torch")
    assert layer_route(16, 850, 768, 8, 3072, torch.bfloat16) == ("attention_vmem", "torch")
    assert layer_route(16, 600, 768, 8, 3072, torch.bfloat16) == ("mha_layer_block", "torch")
    assert layer_route(64, 320, 768, 8, 3072, torch.bfloat16) == ("mha_layer_block", "ffn_block")


@pytest.mark.parametrize("d, heads, t_max", [(768, 12, 782), (768, 8, 782), (1024, 16, 460),
                                             (1024, 8, 460)])
def test_attention_core_takes_every_t_the_gate_admits(d, heads, t_max):
    """The repair: ``mha_layer_block``'s core used to stop at T = 512 (Dh =
    64) or 448 (Dh = 96); the gate admits T <= 782 at D = 768 and T <= 460
    at D = 1024."""
    admitted = [t for t in range(1, 2000) if pmb.block_eligible(16, t, d, heads)]
    assert max(admitted) == t_max
    assert pmb.attention_core_max_t(d // heads) >= t_max
    for dh in range(8, 129, 8):  # every head dim the gate admits
        assert pmb.attention_core_max_t(dh) >= 782


def test_attention_core_max_t_depends_on_the_head_dim_alone():
    """The whole-row kernel's shared memory no longer grows with the row, so
    the core takes every T at a head dim it takes at all (Dh % 8 == 0, Dh <=
    128): the limit is the launchers' int row count, the same at every Dh."""
    from speechclip_tpu_torch.kernels._attention_common import MAX_ROWS

    taken = [dh for dh in range(1, 200) if pmb.attention_core_max_t(dh)]
    assert taken == list(range(8, 129, 8))
    assert {pmb.attention_core_max_t(dh) for dh in taken} == {MAX_ROWS}
    for t in (1536, 1600, 2048, 100_000):  # past the old score-row cap (1536 at Dh = 64)
        assert t <= pmb.attention_core_max_t(64)
