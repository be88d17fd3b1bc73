"""The port's pooling heads (speechclip_tpu_torch/ops/pooling.py) against
the JAX package's at f32 (1e-5) from one JAX init carried across:
``mean_pooling`` with and without lengths and projections,
``attentive_pooling_mask``, paired and cross-batch attentive pooling with
and without a mask, the degraded (identity) form."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from speechclip_tpu.ops import pooling as jax_pool
from speechclip_tpu_torch.ops import pooling as port_pool

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(tree):
    return jax.tree.map(lambda x: None if x is None else torch.from_numpy(np.array(x)), tree,
                        is_leaf=lambda x: x is None)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("pre, post, bias", [(True, True, True), (False, True, True),
                                             (True, False, False), (False, False, True)])
@pytest.mark.parametrize("with_len", [True, False])
def test_mean_pooling(pre, post, bias, with_len):
    params = jax_pool.mean_pooling_init(jax.random.key(0), 12, 8, bias, pre, post)
    x = np.random.default_rng(0).standard_normal((3, 7, 12)).astype(np.float32)
    lens = np.array([7, 3, 0]) if with_len else None
    want = jax_pool.mean_pooling_apply(params, jnp.asarray(x),
                                       None if lens is None else jnp.asarray(lens))
    got = port_pool.mean_pooling_apply(_t(params), torch.from_numpy(x),
                                       None if lens is None else torch.from_numpy(lens))
    _close(got, want)


def test_mean_pooling_init_structure():
    gen = torch.Generator().manual_seed(0)
    for args in ((12, 8, True, True, True), (12, 8, False, False, True), (0, 0, True, True, True)):
        got = port_pool.mean_pooling_init(gen, *args)
        want = jax_pool.mean_pooling_init(jax.random.key(0), *args)
        shapes = lambda t: jax.tree.map(lambda x: None if x is None else tuple(x.shape), t,
                                        is_leaf=lambda x: x is None)
        assert shapes(got) == shapes(want)


@pytest.mark.parametrize("a_lens, b_lens", [([5, 2], [4, 1]), ([5, 2], None), (None, [4, 4])])
def test_mask(a_lens, b_lens):
    as_j = lambda v: None if v is None else jnp.asarray(v)
    as_t = lambda v: None if v is None else torch.tensor(v)
    want = jax_pool.attentive_pooling_mask(as_j(a_lens), as_j(b_lens), 5, 4)
    got = port_pool.attentive_pooling_mask(as_t(a_lens), as_t(b_lens), 5, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("batch", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("degraded", [False, True])
def test_attentive_pooling(batch, masked, degraded):
    rng = np.random.default_rng(1)
    dim_b = 6 if degraded else 10
    params = jax_pool.attentive_pooling_init(jax.random.key(2), 6, dim_b, degraded)
    a = rng.standard_normal((3, 6, 5)).astype(np.float32)
    b = rng.standard_normal((3 if not batch else 4, dim_b, 4)).astype(np.float32)
    msk = None
    if masked:
        msk = np.array(jax_pool.attentive_pooling_mask(jnp.asarray([5, 2, 3]),
                                                         None if batch else jnp.asarray([4, 1, 2]),
                                                         5, 4))
    fn_j = jax_pool.attentive_pooling_batch_apply if batch else jax_pool.attentive_pooling_apply
    fn_p = port_pool.attentive_pooling_batch_apply if batch else port_pool.attentive_pooling_apply
    want = fn_j(params, jnp.asarray(a), jnp.asarray(b), None if msk is None else jnp.asarray(msk))
    got = fn_p(_t(params), torch.from_numpy(a), torch.from_numpy(b),
               None if msk is None else torch.from_numpy(msk))
    for g, w in zip(got, want):
        _close(g, w)


def test_attentive_pooling_init():
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(port_pool.attentive_pooling_init(gen, 4, 4, degraded=True)["U"],
                       torch.eye(4))
    assert port_pool.attentive_pooling_init(gen, 4, 6)["U"].shape == (4, 6)
    with pytest.raises(ValueError, match="dim_a == dim_b"):
        port_pool.attentive_pooling_init(gen, 4, 6, degraded=True)
    with pytest.raises(ValueError, match="a_lens or b_lens"):
        port_pool.attentive_pooling_mask(None, None, 2, 2)
