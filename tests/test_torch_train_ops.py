"""The port's training ops against the JAX package's, on the same numpy-seeded
inputs: the contrastive losses (value and gradients), kw-BN in train mode
(batch statistics, the running-statistic update, row weights, replica
groups), the VQ's train forms (straight-through forward and gradient,
scheduled and learnable temperatures, the Gumbel form), the LR schedules,
and dropout. The random forms (dropout, Gumbel noise) cannot match JAX draw
for draw (other generators): they are held to their distributions and to
their seeds.

Tolerances: f32 values and gradients 1e-5 (abs and relative); the
schedules exactly (both compute in f32); distributions within 3 sigma on
10^6 draws.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speechclip_tpu.ops import kw_bn as jkw
from speechclip_tpu.ops import losses as jloss
from speechclip_tpu.ops import schedules as jsched
from speechclip_tpu.ops import vq as jvq
from speechclip_tpu_torch.ops import basic as pbasic
from speechclip_tpu_torch.ops import kw_bn as pkw
from speechclip_tpu_torch.ops import losses as ploss
from speechclip_tpu_torch.ops import schedules as psched
from speechclip_tpu_torch.ops import vq as pvq

torch.set_num_threads(2)

TOL = 1e-5
N_DRAWS = 10**6
EULER_GAMMA = 0.5772156649015329


def _features(n=8, d=16, seed=0):
    rng = np.random.default_rng(seed)
    a, b = rng.standard_normal((2, n, d)).astype(np.float32)
    return (a / np.linalg.norm(a, axis=1, keepdims=True),
            b / np.linalg.norm(b, axis=1, keepdims=True))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL, rtol=TOL)


LOSS_CASES = {
    "unique ids": dict(ids=np.arange(8)),
    "repeated ids": dict(ids=np.arange(8) // 2),
    "no ids": dict(ids=None),
    "margin": dict(ids=np.arange(8) // 2, margin=0.2),
    "dcl": dict(ids=np.arange(8) // 2, dcl=True),
    "a2b only": dict(ids=np.arange(8) // 2, b2a=False),
    "b2a only": dict(ids=np.arange(8) // 2, a2b=False),
    "trainable temperature": dict(ids=np.arange(8) // 2, temperature_trainable=True),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_masked_contrastive_loss_value_and_gradients_match_jax(case):
    kw = dict(LOSS_CASES[case])
    ids = kw.pop("ids")
    a, b = _features()
    trainable = kw.get("temperature_trainable", False)
    jparams = jloss.contrastive_temp_init(0.07, trainable)
    pparams = ploss.contrastive_temp_init(0.07, trainable)
    assert set(jparams) == set(pparams)

    def jfn(p, fa, fb):
        return jloss.masked_contrastive_loss(p, fa, fb, None if ids is None else jnp.asarray(ids),
                                             temperature=0.07, **kw)

    want, want_grads = jax.value_and_grad(jfn, argnums=(0, 1, 2))(
        jparams, jnp.asarray(a), jnp.asarray(b))
    ta, tb = (torch.from_numpy(x).requires_grad_(True) for x in (a, b))
    pparams = {k: v.requires_grad_(True) for k, v in pparams.items()}
    got = ploss.masked_contrastive_loss(pparams, ta, tb,
                                        None if ids is None else torch.from_numpy(ids),
                                        temperature=0.07, **kw)
    _close(got.detach(), want)
    leaves = [ta, tb] + list(pparams.values())
    grads = torch.autograd.grad(got, leaves)
    _close(grads[0], want_grads[1])
    _close(grads[1], want_grads[2])
    if trainable:
        _close(grads[2], want_grads[0]["log_inv_temp"])
        _close(ploss.contrastive_temperature(pparams, 0.07, True).detach(),
               jloss.contrastive_temperature(jparams, 0.07, True))


@pytest.mark.parametrize("contrast_mode", ["all", "one"])
@pytest.mark.parametrize("labels", [True, False])
def test_supcon_loss_value_and_gradients_match_jax(contrast_mode, labels):
    a, b = _features(seed=1)
    feats = np.stack([a, b], axis=1)
    ids = np.arange(8) // 2 if labels else None
    temp = 0.1

    def jfn(f, t):
        return jloss.supcon_loss(f, t, labels=None if ids is None else jnp.asarray(ids),
                                 contrast_mode=contrast_mode, base_temperature=0.07)

    want, (want_f, want_t) = jax.value_and_grad(jfn, argnums=(0, 1))(jnp.asarray(feats),
                                                                     jnp.asarray(temp))
    tf = torch.from_numpy(feats).requires_grad_(True)
    tt = torch.tensor(temp, requires_grad=True)
    got = ploss.supcon_loss(tf, tt, labels=None if ids is None else torch.from_numpy(ids),
                            contrast_mode=contrast_mode, base_temperature=0.07)
    _close(got.detach(), want)
    gf, gt = torch.autograd.grad(got, [tf, tt])
    _close(gf, want_f)
    _close(gt, want_t)


def test_supcon_mask_form_and_errors():
    a, b = _features(seed=2)
    feats = np.stack([a, b], axis=1)
    mask = (np.arange(8)[:, None] // 2 == np.arange(8)[None, :] // 2).astype(np.float32)
    want = jloss.supcon_loss(jnp.asarray(feats), 0.07, mask=jnp.asarray(mask))
    got = ploss.supcon_loss(torch.from_numpy(feats), 0.07, mask=torch.from_numpy(mask))
    _close(got, want)
    with pytest.raises(ValueError, match="both"):
        ploss.supcon_loss(torch.from_numpy(feats), labels=torch.arange(8),
                          mask=torch.from_numpy(mask))


BN_LAYOUTS = [("eachKw", True), ("eachKw", False), ("same", False)]


@pytest.mark.parametrize("layout", BN_LAYOUTS)
@pytest.mark.parametrize("groups", [0, 2])
def test_kw_bn_train_mode_matches_jax(layout, groups):
    """Batch statistics (biased variance) normalize; the running statistics
    move by momentum 0.1 toward the batch mean and the unbiased variance
    (group 0's with replica groups)."""
    bn_type, parallel = layout
    k, d = 4, 24
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((50, d)).astype(np.float32)
    kw = (2.0 * rng.standard_normal((6, k, d)) + 0.5).astype(np.float32)
    jparams, jstate = jkw.kw_bn_init(k, d, bn_type, jnp.mean(emb, 0), jnp.std(emb, 0, ddof=1),
                                     parallel=parallel)
    state = {"mean": 0.3 * rng.standard_normal(jstate["mean"].shape).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, jstate["var"].shape).astype(np.float32)}
    want, want_state = jkw.kw_bn_apply(jparams, jax.tree.map(jnp.asarray, state),
                                       jnp.asarray(kw), batchnorm_type=bn_type,
                                       parallel=parallel, train=True, replica_groups=groups)
    pparams = {n: torch.from_numpy(np.asarray(v)) for n, v in jparams.items()}
    got, got_state = pkw.kw_bn_apply(pparams, {n: torch.from_numpy(v) for n, v in state.items()},
                                     torch.from_numpy(kw), batchnorm_type=bn_type,
                                     parallel=parallel, train=True, replica_groups=groups)
    _close(got, want)
    for name in ("mean", "var"):
        _close(got_state[name], want_state[name])
    # eval mode returns the state it was given
    _, same = pkw.kw_bn_apply(pparams, got_state, torch.from_numpy(kw), batchnorm_type=bn_type,
                              parallel=parallel)
    assert same is got_state


@pytest.mark.parametrize("groups", [0, 2])
def test_bn_row_weights_match_jax(groups):
    """0/1 row weights: statistics over the weighted rows only (a fully
    padded group normalizes to zeros, not NaN)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((8, 12)).astype(np.float32)
    w = np.array([1, 1, 0, 1, 0, 0, 0, 0], np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, 12).astype(np.float32),
              "bias": rng.standard_normal(12).astype(np.float32)}
    state = {"mean": np.zeros(12, np.float32), "var": np.ones(12, np.float32)}
    want, want_state = jkw._bn(jnp.asarray(x), jax.tree.map(jnp.asarray, params),
                               jax.tree.map(jnp.asarray, state), True, weights=jnp.asarray(w),
                               groups=groups)
    t = lambda tree: {n: torch.from_numpy(v) for n, v in tree.items()}
    got, got_state = pkw._bn(torch.from_numpy(x), t(params), t(state), True,
                             weights=torch.from_numpy(w), groups=groups)
    assert torch.isfinite(got).all()
    _close(got, want)
    for name in ("mean", "var"):
        _close(got_state[name], want_state[name])


def test_kw_bn_rejects_a_batch_the_groups_do_not_divide():
    params, state = pkw.kw_bn_init(2, 4, "same", torch.zeros(4), torch.ones(4))
    with pytest.raises(ValueError, match="replica_groups"):
        pkw.kw_bn_apply(params, state, torch.zeros(3, 2, 4), batchnorm_type="same",
                        train=True, replica_groups=2)


def _scores(seed=5):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (3, 4, 64)).astype(np.float32)
    x[0, 1, 2] = 5.0  # a special token's score is masked out
    return x


@pytest.mark.parametrize("temp", ["fixed=0.1", "learnable=0.5", "(2.0, 0.5, 0.99)"])
@pytest.mark.parametrize("hard", [True, False])
def test_vq_train_forms_match_jax(temp, hard):
    """Straight-through (hard): the forward is the one-hot of the argmax
    and the gradient the tempered softmax's; soft: the softmax itself. The
    learnable temperature gets its gradient; the scheduled one reads
    num_updates."""
    x = _scores()
    cot = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)
    num_updates = 40

    def jfn(p, s):
        out = jvq.vq_apply(p, s, temp_spec=temp, hard=hard, train=True,
                           num_updates=jnp.asarray(num_updates))
        return jnp.sum(out["subword_prob"] * cot), out

    (_, want), (want_gp, want_gx) = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        jvq.vq_init(temp), jnp.asarray(x))
    pparams = {k: torch.from_numpy(np.asarray(v)).requires_grad_(True)
               for k, v in jvq.vq_init(temp).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    got = pvq.vq_apply(pparams, tx, temp_spec=temp, hard=hard, train=True,
                       num_updates=torch.tensor(num_updates))
    _close(got["subword_prob"].detach(), want["subword_prob"])
    np.testing.assert_array_equal(got["targets"].numpy(), np.asarray(want["targets"]))
    _close(got["temp"].detach(), want["temp"])
    if hard:
        one_hot = torch.nn.functional.one_hot(got["targets"][..., 0], 64).float()
        torch.testing.assert_close(got["subword_prob"].detach(), one_hot, atol=1e-6, rtol=0)
        assert int(got["targets"][0, 1, 0]) != 2
    loss = (got["subword_prob"] * torch.from_numpy(cot)).sum()
    grads = torch.autograd.grad(loss, [tx] + list(pparams.values()))
    _close(grads[0], want_gx)
    if pparams:
        _close(grads[1], want_gp["curr_temp"])


def test_scheduled_temperature_decays_to_its_floor():
    temp = "(2.0, 0.5, 0.9)"
    for n in (0, 1, 5, 13, 14, 100):
        want = float(jvq.current_temperature({}, temp, jnp.asarray(n)))
        got = float(pvq.current_temperature({}, temp, torch.tensor(n)))
        assert got == pytest.approx(want, rel=1e-6)
        assert got == pytest.approx(max(2.0 * 0.9**n, 0.5), rel=1e-5)


def test_gumbel_noise_distribution_and_seed():
    """-log(-log(u)): mean Euler's gamma, variance pi^2 / 6; one seed, one
    draw."""
    g = lambda seed: pvq.gumbel_noise((N_DRAWS,), torch.Generator().manual_seed(seed))
    a = g(0).double()
    sigma = math.sqrt(math.pi**2 / 6 / N_DRAWS)
    assert abs(float(a.mean()) - EULER_GAMMA) <= 3 * sigma
    assert float(a.var()) == pytest.approx(math.pi**2 / 6, rel=0.01)
    assert torch.equal(g(0), g(0)) and not torch.equal(g(0), g(1))


def test_gumbel_vq_is_straight_through_and_seeded():
    x = torch.from_numpy(_scores()).requires_grad_(True)

    def run(seed):
        return pvq.vq_apply({}, x, temp_spec="fixed=0.5", use_gumbel=True, train=True,
                            generator=torch.Generator().manual_seed(seed))

    out = run(7)
    prob = out["subword_prob"]
    one_hot = torch.nn.functional.one_hot(out["targets"][..., 0], 64).float()
    torch.testing.assert_close(prob.detach(), one_hot, atol=1e-6, rtol=0)
    assert torch.equal(prob, run(7)["subword_prob"])
    (gx,) = torch.autograd.grad((prob * torch.arange(64.0)).sum(), [x])
    assert torch.isfinite(gx).all() and gx.abs().sum() > 0
    assert int(out["targets"][0, 1, 0]) != 2  # masked specials never win
    with pytest.raises(ValueError, match="generator"):
        pvq.vq_apply({}, x, temp_spec="fixed=0.5", use_gumbel=True, train=True)


@pytest.mark.parametrize("name, kwargs", [
    ("linear_warmup_decay", dict(warmup=5000, max_step=50000, final_lr=1e-8)),
    ("linear_warmup_decay", dict(warmup=2, max_step=100, final_lr=1e-8)),
    ("noam", dict(warmup=4000)),
])
def test_schedules_match_jax(name, kwargs):
    base = 1e-4
    want_fn = jsched.get_schedule(name, base, **kwargs)
    got_fn = psched.get_schedule(name, base, **kwargs)
    w = kwargs["warmup"]
    for step in (0, w - 1, w, w + 1, kwargs.get("max_step", 50000), 60000):
        assert got_fn(step) == float(want_fn(step)), step
    assert got_fn(w - 1) == pytest.approx(base, rel=1e-6)


def test_unknown_schedule_raises():
    with pytest.raises(NotImplementedError):
        psched.get_schedule("cosine", 1e-4)


def test_dropout_keep_rate_scale_identity_and_seed():
    p = 0.1
    x = torch.ones(N_DRAWS)
    gen = lambda seed: torch.Generator().manual_seed(seed)
    y = pbasic.dropout(x, p, True, gen(0))
    kept = float((y != 0).float().mean())
    assert abs(kept - (1 - p)) <= 3 * math.sqrt(p * (1 - p) / N_DRAWS)
    assert torch.all((y == 0) | (y == torch.tensor(1 / (1 - p))))
    assert torch.equal(y, pbasic.dropout(x, p, True, gen(0)))
    assert not torch.equal(y, pbasic.dropout(x, p, True, gen(1)))
    assert pbasic.dropout(x, p, False, None) is x
    assert pbasic.dropout(x, 0.0, True, None) is x
    with pytest.raises(ValueError, match="generator"):
        pbasic.dropout(x, p, True, None)
    xb = torch.ones(8, dtype=torch.bfloat16)
    assert pbasic.dropout(xb, p, True, gen(0)).dtype == torch.bfloat16
