"""The kernels' gradients: each ``torch.autograd.Function`` of the port
(``MhaLayerBlockFn``, ``FfnBlockFn``, ``AttentionVmemFn``,
``FlashAttentionFn``), run on the CPU (forward: the wrapper's dispatch, here
the plain version; backward: the recompute through the plain version),
against ``jax.vjp`` of the JAX kernel, whose forward runs its Pallas kernel
in interpret mode on the CPU (as tests/test_kernels.py runs it) and whose
``custom_vjp`` backward recomputes through its XLA reference. The same
numpy-seeded inputs and upstream gradient go to both.

Tolerances: f32 — max abs diff <= 1e-4 in units of max(1, max |want|) per
gradient (the sums over rows that form a weight's gradient reach |g| ~ 10;
only the summation order differs); bf16 — per-row cosine >= 0.999 (the JAX
recompute rounds at other points than the port's plain versions: a bias
added in bf16, the attention weights rounded before P V). A backward that
returns a gradient for the wrong input fails the same check.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speechclip_tpu.kernels.attention_vmem import attention_vmem as jax_attention_vmem
from speechclip_tpu.kernels.ffn_block import ffn_block as jax_ffn_block
from speechclip_tpu.kernels.flash_attention import flash_attention as jax_flash_attention
from speechclip_tpu.kernels.mha_block import mha_layer_block as jax_mha_layer_block
from speechclip_tpu_torch.kernels import attention_vmem as pav
from speechclip_tpu_torch.kernels import ffn_block as pffn
from speechclip_tpu_torch.kernels import flash_attention as pfa
from speechclip_tpu_torch.kernels import mha_block as pmb

torch.set_num_threads(2)

F32_ATOL = 1e-4
MIN_COSINE = 0.999
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def check_grads(got, want, dtype):
    """Each gradient in ``got`` (torch) against its JAX counterpart."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        assert g.shape == w.shape, i
        assert np.isfinite(g).all(), i
        if dtype == "float32":
            err = np.abs(g - w).max()
            assert err <= F32_ATOL * max(1.0, np.abs(w).max()), (i, err)
        else:
            a, b = g.reshape(-1, g.shape[-1]), w.reshape(-1, w.shape[-1])
            na, nb = np.linalg.norm(a, axis=-1), np.linalg.norm(b, axis=-1)
            live = nb > 1e-6 * nb.max()
            cos = (a * b).sum(-1)[live] / (na * nb)[live]
            assert cos.min() >= MIN_COSINE, (i, cos.min())


def _grads_through(fn, args, cot, diff):
    """torch: the gradients of ``sum(fn(*args) * cot)`` w.r.t. args[i] for i
    in ``diff``, and the output's grad_fn name."""
    out = fn(*args)
    grads = torch.autograd.grad(out, [args[i] for i in diff], cot)
    return grads, type(out.grad_fn).__name__


def _layer_inputs(b, t, d, f, seed):
    rng = np.random.default_rng(seed)
    mk = lambda *s: (rng.standard_normal(s) * s[0] ** -0.5).astype(np.float32)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    ln = ((1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
          (0.1 * rng.standard_normal(d)).astype(np.float32))
    mha = (mk(d, 3 * d), 0.1 * mk(3 * d), mk(d, d), 0.1 * mk(d)) + ln
    ffn = (mk(d, f), 0.1 * mk(f), mk(f, d), 0.1 * mk(d)) + ln
    cot = (0.1 * rng.standard_normal((b, t, d))).astype(np.float32)
    return x, mha, ffn, cot


def _torch(arrays, dtype, first_dtype=None):
    """x in ``first_dtype`` (the activations), the rest f32 (master weights;
    the wrappers cast the matrices to the activations' dtype), all leaves
    that require grad."""
    out = []
    for i, a in enumerate(arrays):
        t = torch.from_numpy(a).to(first_dtype if i == 0 and first_dtype else torch.float32)
        out.append(t.requires_grad_(True))
    return out


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mode", ["post", "pre", "none"])
def test_mha_layer_block_grads_match_jax(mode, dtype):
    tdt, jdt = DTYPES[dtype]
    b, t, d, heads = 2, 19, 128, 2
    x, mha, _, cot = _layer_inputs(b, t, d, 4 * d, seed=0)
    lens = np.array([t, 11], np.int32)
    if mode == "none":
        mha = mha[:4]
    n = 1 + len(mha)

    def jfn(*a):
        lg, lb = (a[5], a[6]) if mode != "none" else (None, None)
        return jax_mha_layer_block(a[0], *a[1:5], lg, lb, jnp.asarray(lens), heads, mode, 1e-5)

    jargs = [jnp.asarray(x).astype(jdt)] + [jnp.asarray(a) for a in mha]
    _, vjp = jax.vjp(jfn, *jargs)
    want = vjp(jnp.asarray(cot).astype(jdt))
    targs = _torch([x, *mha], tdt, tdt)
    lg, lb = (targs[5], targs[6]) if mode != "none" else (None, None)
    call = lambda *a: pmb.mha_layer_block(a[0], *a[1:5], lg, lb, torch.from_numpy(lens),
                                          heads, mode, 1e-5)
    before = pmb.mha_layer_block.recomputes
    got, fn_name = _grads_through(call, targs, torch.from_numpy(cot).to(tdt), range(5))
    if mode != "none":
        got += tuple(torch.autograd.grad(call(*targs), [lg, lb], torch.from_numpy(cot).to(tdt)))
    assert fn_name == "MhaLayerBlockFnBackward"
    assert pmb.mha_layer_block.recomputes > before
    check_grads(got, want[:n], dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("mode", ["post", "pre"])
def test_ffn_block_grads_match_jax(mode, dtype):
    tdt, jdt = DTYPES[dtype]
    x, _, ffn, cot = _layer_inputs(2, 17, 64, 256, seed=1)
    jargs = [jnp.asarray(x).astype(jdt)] + [jnp.asarray(a) for a in ffn]
    _, vjp = jax.vjp(lambda *a: jax_ffn_block(*a, mode, 1e-5), *jargs)
    want = vjp(jnp.asarray(cot).astype(jdt))
    targs = _torch([x, *ffn], tdt, tdt)
    got, fn_name = _grads_through(lambda *a: pffn.ffn_block(*a, mode, 1e-5), targs,
                                  torch.from_numpy(cot).to(tdt), range(7))
    assert fn_name == "FfnBlockFnBackward"
    check_grads(got, want, dtype)


def _qkv(b, h, l, dh, seed):
    rng = np.random.default_rng(seed)
    q, k, v = rng.standard_normal((3, b, h, l, dh)).astype(np.float32)
    cot = rng.standard_normal((b, h, l, dh)).astype(np.float32)
    return q, k, v, cot


ATTENTION_CASES = {
    "attention_vmem": (pav.attention_vmem, jax_attention_vmem, "AttentionVmemFnBackward",
                       [("lens", 2, 3, 21, 64, True, False), ("causal", 2, 2, 16, 32, False, True)]),
    "flash_attention": (pfa.flash_attention, jax_flash_attention, "FlashAttentionFnBackward",
                        [("lens", 2, 3, 21, 64, True, False),
                         ("causal", 2, 2, 10, 64, False, True),
                         ("Dh 768", 2, 1, 13, 768, True, False)]),
}


def _attention_cases():
    for name, (_, _, _, shapes) in ATTENTION_CASES.items():
        for shape in shapes:
            for dtype in sorted(DTYPES):
                yield pytest.param(name, shape[1:], dtype, id=f"{name}-{shape[0]}-{dtype}")


def _attention_grads(name, shape, dtype, fn=None):
    port, jax_kernel, fn_name, _ = ATTENTION_CASES[name]
    tdt, jdt = DTYPES[dtype]
    b, h, l, dh, with_lens, causal = shape
    q, k, v, cot = _qkv(b, h, l, dh, seed=2)
    lens = np.array([l, l // 2 + 1], np.int32)[:b] if with_lens else None
    jl = None if lens is None else jnp.asarray(lens)
    _, vjp = jax.vjp(lambda q, k, v: jax_kernel(q, k, v, jl, causal),
                     *(jnp.asarray(a).astype(jdt) for a in (q, k, v)))
    want = vjp(jnp.asarray(cot).astype(jdt))
    targs = [torch.from_numpy(a).to(tdt).requires_grad_(True) for a in (q, k, v)]
    tl = None if lens is None else torch.from_numpy(lens)
    call = fn or (lambda q, k, v: port(q, k, v, tl, causal))
    got, name_got = _grads_through(call, targs, torch.from_numpy(cot).to(tdt), range(3))
    return got, want, name_got, fn_name


@pytest.mark.parametrize("name, shape, dtype", list(_attention_cases()))
def test_attention_grads_match_jax(name, shape, dtype):
    got, want, fn_got, fn_want = _attention_grads(name, shape, dtype)
    assert fn_got == fn_want
    check_grads(got, want, dtype)


class _WrongInputFn(torch.autograd.Function):
    """FlashAttentionFn with the gradients of q and k swapped: a backward
    that returns a gradient for the wrong input."""

    forward = staticmethod(pfa.FlashAttentionFn.forward)

    @staticmethod
    def backward(ctx, grad_out):
        grads = list(pfa.FlashAttentionFn.backward(ctx, grad_out))
        grads[0], grads[1] = grads[1], grads[0]
        return tuple(grads)


def test_a_gradient_for_the_wrong_input_fails_the_check():
    shape = (2, 3, 21, 64, True, False)
    lens = torch.tensor([21, 11], dtype=torch.int32)
    faulty = lambda q, k, v: _WrongInputFn.apply(q, k, v, lens, False)
    got, want, _, _ = _attention_grads("flash_attention", shape, "float32", faulty)
    with pytest.raises(AssertionError):
        check_grads(got, want, "float32")


def test_function_gradients_are_the_plain_versions_own():
    """The backward IS the plain recompute: bitwise the plain version's
    autograd gradients for the same upstream gradient."""
    x, mha, _, cot = _layer_inputs(2, 19, 64, 256, seed=3)
    lens = torch.tensor([19, 7], dtype=torch.int32)
    args = _torch([x, *mha], torch.float32)
    g = torch.from_numpy(cot)
    for fn in (pmb.mha_layer_block, pmb.mha_layer_block_plain):
        out = fn(*args[:7], lens, 2, "post", 1e-5)
        grads = torch.autograd.grad(out, args, g)
        if fn is pmb.mha_layer_block:
            first = grads
    for a, b in zip(first, grads):
        assert torch.equal(a, b)


def test_no_graph_without_grad():
    """Under no_grad, or with no input that requires grad, the wrapper calls
    the dispatch directly: no Function, no saved inputs."""
    q, k, v, _ = _qkv(1, 1, 8, 16, seed=4)
    tq = torch.from_numpy(q).requires_grad_(True)
    with torch.no_grad():
        assert pfa.flash_attention(tq, tq, tq).grad_fn is None
        assert pav.attention_vmem(tq, tq, tq).grad_fn is None
    assert pfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v)).grad_fn is None
