"""The port's training step against the JAX package's, at tiny dims with both
branches live (``flagship_tiny_config()``), from ONE JAX
``create_train_state`` carried over by convert.from_jax (params and the
kw-BN state): precision 32, dropout 0 (JAX's and torch's random streams
differ, so dropout cannot match draw for draw), Adam at lr 1e-3 with
warmup 2 so the first updates are not vanishing.

Tolerances: the loss and its parts 1e-5 abs + 1e-4 relative; each
trainable leaf's gradient 1e-5 abs + 1e-4 of the leaf's largest JAX
gradient (the cascaded branch's gradients pass the VQ's 1 / 0.1 and the
loss's 1 / 0.07: f32 rounding reaches ~1e-5 of a leaf's scale there, while
the parallel branch's agree to ~1e-6), but a leaf whose gradient cancels
to rounding (the biases kw-BN cancels: under 1e-4 of the largest gradient)
is held to that level on both sides; ``grad_norm`` 1e-4 relative; the
params after 1 step, and after 4 steps with ``accumulate_grad_batches =
2``, 1e-5 abs, except the elements whose JAX gradient is under 1e-7 in
magnitude or on which the two packages' f32 gradients (under accumulation:
the pair means Adam takes) differ by more than 0.1 % (Adam's first step is
``lr * g / (|g| + eps)``, nearly ``lr * sign(g)``, so a gradient of pure
rounding moves an element by up to 2 lr: the biases kw-BN cancels have
such gradients, ~1e-6 before the clip, and a pair of micro-batch gradients
that cancel to ~1e-7 leaves its mean to rounding); those are counted and
must stay under 2 % of the trainable elements. The kw-BN running statistics 1e-6 abs while the
forwards run on the initial params (after 4 accumulated steps, the
variance 1e-4 relative: the mean also follows the keyword projection's
bias, whose gradient is rounding); frozen leaves
bitwise unchanged. bf16: per-row cosine
>= 0.999 on the features of the rows whose keyword ids agree with JAX's.
With the flagship's dropout 0.1 the loss falls over 20 steps on a fixed
batch, and one generator seed gives the same losses twice.
"""


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speechclip_tpu.config import flagship_tiny_config
from speechclip_tpu.models.speechclip import SpeechCLIPModel as JaxModel
from speechclip_tpu.training import build_optimizer as jax_build_optimizer
from speechclip_tpu.training import create_train_state as jax_create_train_state
from speechclip_tpu.training import make_eval_step as jax_make_eval_step
from speechclip_tpu.training import make_train_step as jax_make_train_step
from speechclip_tpu_torch.convert.from_jax import (
    speechclip_params_from_jax,
    speechclip_state_from_jax,
)
from speechclip_tpu_torch.models.speechclip import SpeechCLIPModel
from speechclip_tpu_torch.training.optim import build_optimizer, trainable_leaves
from speechclip_tpu_torch.training.train_step import (
    create_train_state,
    make_eval_step,
    make_train_step,
)
from tests.test_torch_config import port_config_from_jax

torch.set_num_threads(2)

B = 8
WAV_LEN = 2000
ATOL, RTOL = 1e-5, 1e-4
TINY_GRAD = 1e-7
CANCELLED = 1e-4  # of the largest gradient: a leaf's gradient that is rounding
UNRESOLVED = 1e-3  # gradients the packages differ on by more than this share
MAX_UNRESOLVED_SHARE = 0.02  # of all trainable elements (1.2-1.3 % here)


def jax_config(precision=32, accum=1, dropout=0.0):
    cfg = flagship_tiny_config()
    cfg.trainer.precision = precision
    cfg.trainer.accumulate_grad_batches = accum
    for branch in ("parallel_branch", "cascaded_branch"):
        cfg.model_settings[branch].transformer_args.dropout = dropout
    cfg.audio_encoder.optim = {"name": "Adam", "args": {"lr": 1e-3, "weight_decay": 1e-6}}
    cfg.audio_encoder.scheduler = {"name": "linear_warmup_decay", "warmup": 2,
                                   "max_step": 100, "final_lr": 1e-8}
    return cfg


def make_batch(seed=0):
    rng = np.random.default_rng(seed)
    wav_len = rng.integers(1000, WAV_LEN + 1, B)
    wav = rng.standard_normal((B, WAV_LEN)).astype(np.float32)
    wav *= np.arange(WAV_LEN)[None, :] < wav_len[:, None]
    return {"wav": wav, "wav_len": wav_len.astype(np.int32),
            "image": rng.standard_normal((B, 32, 32, 3)).astype(np.float32),
            "id": (np.arange(B) // 2).astype(np.int32)}


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def flat(tree) -> dict:
    """{path: numpy array} over the leaves of a params-shaped tree (JAX
    arrays, numpy arrays or torch tensors)."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    out = {}
    for path, leaf in leaves:
        if torch.is_tensor(leaf):
            leaf = leaf.detach().float().numpy()
        out[jax.tree_util.keystr(path)] = np.asarray(leaf, np.float32)
    return out


def port_tree(params):
    """The port's layout for a JAX params-shaped tree (conv layouts moved)."""
    return speechclip_params_from_jax(_np(params))


@pytest.fixture(scope="module")
def setup():
    cfg = jax_config()
    jm = JaxModel(cfg)
    tx, _ = jax_build_optimizer(cfg, jm.trainable_mask(jax.eval_shape(jm.init,
                                                                        jax.random.key(0))[0]))
    jstate = jax.jit(lambda key: jax_create_train_state(jm, tx, key))(jax.random.key(0))
    return dict(cfg=cfg, jm=jm, jstate=jstate, batch=make_batch(),
                pparams=speechclip_params_from_jax(_np(jstate.params)),
                pstate=speechclip_state_from_jax(_np(jstate.model_state)))


def port_setup(setup, cfg=None, seed=0):
    cfg = cfg or setup["cfg"]
    pm = SpeechCLIPModel(port_config_from_jax(cfg), device="cpu")
    state = create_train_state(pm, params=setup["pparams"], model_state=setup["pstate"],
                               rng_seed=seed)
    optimizer, scheduler = build_optimizer(pm.config, state.params,
                                           pm.trainable_mask(state.params))
    return pm, state, optimizer, scheduler


def jax_loss_and_grads(jm, jstate, batch):
    """The JAX train step's loss_fn (frozen leaves stop-gradded) and its
    gradients, at step 0."""
    return _jax_grad_fn(jm)(jstate.params, jstate.model_state, batch)


_GRAD_FNS = {}


def _jax_grad_fn(jm):
    if id(jm) not in _GRAD_FNS:
        def loss_fn(params, model_state, batch):
            trainable = jm.trainable_mask(params)
            params = jax.tree.map(lambda p, t: p if t else jax.lax.stop_gradient(p), params,
                                  trainable)
            feats, _, _, _ = jm.forward(params, model_state, batch, train=True,
                                        num_updates=jnp.zeros((), jnp.int32))
            losses = jm.compute_loss(params, feats)
            return losses["loss"], losses

        _GRAD_FNS[id(jm)] = (jm, jax.jit(jax.value_and_grad(loss_fn, has_aux=True)))
    return _GRAD_FNS[id(jm)][1]


def test_trainable_mask_tree_matches_jax(setup):
    pm, state, _, _ = port_setup(setup)
    want = jax.tree_util.tree_flatten_with_path(setup["jm"].trainable_mask(setup["jstate"].params))[0]
    got = jax.tree_util.tree_flatten_with_path(pm.trainable_mask(state.params))[0]
    assert [(jax.tree_util.keystr(p), v) for p, v in got] == [
        (jax.tree_util.keystr(p), bool(v)) for p, v in want]
    assert {v for _, v in got} == {True, False}
    mask = pm.trainable_mask(state.params)
    for leaf, keep in zip(jax.tree.leaves(state.params), jax.tree.leaves(mask)):
        assert leaf.requires_grad == keep
        assert leaf.dtype == torch.float32


def port_grads(pm, state, batch) -> dict:
    """{path: gradient} of the port's train-mode loss at ``state``, over the
    trainable leaves (zeros where a leaf gets none), and the losses."""
    feats, _, _, _ = pm.forward(state.params, state.model_state, torch_batch(batch),
                                generator=state.generator, train=True,
                                num_updates=torch.tensor(0))
    losses = pm.compute_loss(state.params, feats)
    mask = pm.trainable_mask(state.params)
    leaves = trainable_leaves(state.params, mask)
    grads = torch.autograd.grad(losses["loss"], leaves, allow_unused=True)
    grad_of = {id(p): torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)}
    paths = jax.tree_util.tree_flatten_with_path(state.params)[0]
    flags = jax.tree.leaves(mask)
    return ({jax.tree_util.keystr(path): grad_of[id(leaf)].numpy()
             for (path, leaf), keep in zip(paths, flags) if keep},
            {k: float(v.detach()) for k, v in losses.items()})


def test_loss_and_gradients_match_jax(setup):
    (_, jlosses), jgrads = jax_loss_and_grads(setup["jm"], setup["jstate"],
                                              jax_batch(setup["batch"]))
    pm, state, optimizer, _ = port_setup(setup)
    grads, losses = port_grads(pm, state, setup["batch"])
    assert set(losses) == {"loss", "c_cl_loss", "p_cl_loss"}
    for key, value in losses.items():
        np.testing.assert_allclose(value, float(jlosses[key]), atol=ATOL, rtol=RTOL)
    assert_grads_match(grads, flat(port_tree(jgrads)))
    assert len(grads) == len(optimizer.param_groups[0]["params"]) > 10


def assert_grads_match(grads, want):
    """Each leaf within 1e-5 abs + 1e-4 of its largest JAX gradient; a leaf
    whose gradient cancels to rounding (under CANCELLED of the largest
    gradient of all: the biases kw-BN cancels) is held to that level on
    both sides instead."""
    top = max(np.abs(w).max() for w in want.values())
    for path, g in grads.items():
        scale = np.abs(want[path]).max()
        if scale < CANCELLED * top:
            assert np.abs(g).max() <= CANCELLED * top, path
            continue
        np.testing.assert_allclose(g, want[path], atol=ATOL + RTOL * scale, rtol=0,
                                   err_msg=path)


def unresolved(jgrads, pgrads) -> dict:
    """{path: bool mask} of the elements whose gradient the packages do not
    resolve: under TINY_GRAD in JAX, or apart by more than UNRESOLVED."""
    want = flat(port_tree(jgrads))
    return {path: (np.abs(want[path]) < TINY_GRAD)
            | (np.abs(g - want[path]) > UNRESOLVED * np.abs(want[path]))
            for path, g in pgrads.items()}


def _assert_params_match(pm, state, jparams, skip, before):
    """Trainable leaves within ATOL of JAX's but the ``skip`` elements (whose
    gradient the packages did not resolve; counted); frozen leaves bitwise
    as they were."""
    want = flat(port_tree(jparams))
    got, mask = flat(state.params), flat(pm.trainable_mask(state.params))
    total = 0
    for path, keep in mask.items():
        if not keep:
            np.testing.assert_array_equal(got[path], before[path], err_msg=path)
            continue
        live = ~skip[path]
        total += live.size
        np.testing.assert_allclose(got[path][live], want[path][live], atol=ATOL, rtol=0,
                                   err_msg=path)
    n_skip = sum(int(m.sum()) for m in skip.values())
    assert n_skip <= MAX_UNRESOLVED_SHARE * total, (n_skip, total)


def test_one_step_matches_jax(setup):
    jm, jstate = setup["jm"], setup["jstate"]
    (_, _), jgrads = jax_loss_and_grads(jm, jstate, jax_batch(setup["batch"]))
    tx, _ = jax_build_optimizer(setup["cfg"], jm.trainable_mask(jstate.params))
    jnew, jmetrics = jax.jit(jax_make_train_step(jm, tx))(jstate, jax_batch(setup["batch"]))
    pm, state, optimizer, scheduler = port_setup(setup)
    before = flat(state.params)
    pgrads, _ = port_grads(pm, state, setup["batch"])
    step = make_train_step(pm, optimizer, scheduler)
    state, metrics = step(state, torch_batch(setup["batch"]))
    assert state.step == 1
    assert set(metrics) == set(jmetrics)
    for key in ("train_loss", "train_p_cl_loss", "train_c_cl_loss", "train_softmax_temp",
                "train_cl_temp"):
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), atol=ATOL,
                                   rtol=RTOL, err_msg=key)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jmetrics["grad_norm"]),
                               rtol=RTOL)
    _assert_params_match(pm, state, jnew.params, unresolved(jgrads, pgrads), before)
    for path, want in flat(_np(jnew.model_state)).items():
        np.testing.assert_allclose(flat(state.model_state)[path], want, atol=1e-6, err_msg=path)
    assert scheduler.get_last_lr()[0] == pytest.approx(1e-3)  # warmup 2: update 1 at base lr


def test_four_accumulated_steps_match_jax(setup):
    """accumulate_grad_batches = 2 over two batches, twice: params still
    after micro-steps 1 and 3, the mean of each pair's gradients applied
    after 2 and 4, as optax MultiSteps."""
    cfg = jax_config(accum=2)
    jm = JaxModel(cfg)
    tx, _ = jax_build_optimizer(cfg, jm.trainable_mask(setup["jstate"].params))
    jstate = setup["jstate"].__class__(params=setup["jstate"].params,
                                       model_state=setup["jstate"].model_state,
                                       opt_state=tx.init(setup["jstate"].params),
                                       step=setup["jstate"].step, rng=setup["jstate"].rng)
    jstep = jax.jit(jax_make_train_step(jm, tx, accumulate_grad_batches=2))
    pm, state, optimizer, scheduler = port_setup(setup, cfg)
    before = flat(state.params)
    step = make_train_step(pm, optimizer, scheduler, pm.config.accumulate_grad_batches)
    skip, pair = None, []
    for i, batch in enumerate(make_batch(s) for s in (0, 1, 0, 1)):
        # the elements whose pair-mean gradient (what Adam takes) the
        # packages leave unresolved at either update
        (_, _), jgrads = jax_loss_and_grads(jm, jstate, jax_batch(batch))
        pair.append((jgrads, port_grads(pm, state, batch)[0]))
        if i % 2:
            (j0, p0), (j1, p1) = pair
            now = unresolved(jax.tree.map(lambda a, b: (a + b) / 2, j0, j1),
                             {k: (p0[k] + p1[k]) / 2 for k in p0})
            skip = now if skip is None else {k: skip[k] | now[k] for k in skip}
            pair = []
        jstate, jmetrics = jstep(jstate, jax_batch(batch))
        state, metrics = step(state, torch_batch(batch))
        np.testing.assert_allclose(float(metrics["train_loss"]), float(jmetrics["train_loss"]),
                                   atol=ATOL, rtol=RTOL)
        if i == 0:  # the first micro-batch moves nothing
            assert all(np.array_equal(a, before[k]) for k, a in flat(state.params).items())
        if i == 1:  # two kw-BN updates, both forwards on the initial params
            for path, want in flat(_np(jstate.model_state)).items():
                np.testing.assert_allclose(flat(state.model_state)[path], want, atol=1e-6,
                                           err_msg=path)
    assert state.step == 4
    _assert_params_match(pm, state, jstate.params, skip, before)
    # after the updates the running mean also follows the keyword projection's
    # bias, whose gradient is rounding (kw-BN cancels it in the output) and
    # which Adam moves by up to 2 lr either way; the variance does not see it
    bn = "['cascaded_branch']['bn']['var']"
    np.testing.assert_allclose(flat(state.model_state)[bn], flat(_np(jstate.model_state))[bn],
                               rtol=1e-4)


def test_image_feature_cache_equals_the_tower_path(setup):
    pm, state, _, _ = port_setup(setup)
    batch = torch_batch(setup["batch"])
    cached = dict(batch, image_feat_frozen=pm.encode_image_tower(state.params, batch.pop("image")))
    batch = torch_batch(setup["batch"])
    want, _, _, _ = pm.forward(state.params, state.model_state, batch, train=True)
    got, _, _, _ = pm.forward(state.params, state.model_state, cached, train=True)
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)


def test_eval_step_matches_jax(setup):
    jm, jstate = setup["jm"], setup["jstate"]
    want = jax.jit(jax_make_eval_step(jm))(jstate, jax_batch(setup["batch"]))
    pm, state, _, _ = port_setup(setup)
    got = make_eval_step(pm)(state, torch_batch(setup["batch"]))
    assert set(got) == set(want) and set(got["metrics"]) == set(want["metrics"])
    for key in ("audio_feat", "image_feat", "keywords"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-4, err_msg=key)
    for key, value in want["metrics"].items():
        np.testing.assert_allclose(float(got["metrics"][key]), float(value), atol=ATOL,
                                   rtol=RTOL, err_msg=key)
    np.testing.assert_array_equal(got["id"].numpy(), np.asarray(want["id"]))


def test_bf16_step_features_match_jax(setup):
    """Precision 16: the train-mode features agree with JAX's per row where
    the keyword ids agree; one step's loss and params stay finite."""
    cfg = jax_config(precision=16)
    jm = JaxModel(cfg)
    jstate = setup["jstate"]
    want_feats, _, want_others, _ = jax.jit(
        lambda p, s, b: jm.forward(p, s, b, train=True, num_updates=jnp.zeros((), jnp.int32))
    )(jstate.params, jstate.model_state, jax_batch(setup["batch"]))
    pm, state, optimizer, scheduler = port_setup(setup, cfg)
    feats, _, others, _ = pm.forward(state.params, state.model_state,
                                     torch_batch(setup["batch"]), train=True,
                                     num_updates=torch.tensor(0))
    ids = others["vq_results"]["targets"][..., 0].numpy()
    same = ids == np.asarray(want_others["vq_results"]["targets"])[..., 0]
    # the VQ argmax is discontinuous and tiny random weights make near-ties:
    # ~2 in 3 keyword ids agree here, every id at precision 32
    assert same.mean() >= 0.5
    agree = same.all(axis=1)
    assert agree.any()
    for key in ("parallel_audio_feat", "cascaded_audio_feat", "image_feat"):
        rows = agree if key == "cascaded_audio_feat" else slice(None)
        g, w = feats[key].detach().numpy()[rows], np.asarray(want_feats[key])[rows]
        cos = (g * w).sum(-1) / np.linalg.norm(g, axis=-1) / np.linalg.norm(w, axis=-1)
        assert cos.min() >= 0.999, key
    state, metrics = make_train_step(pm, optimizer, scheduler)(state, torch_batch(setup["batch"]))
    assert np.isfinite(float(metrics["train_loss"]))
    assert all(torch.isfinite(p).all() for p in trainable_leaves(state.params,
                                                                 pm.trainable_mask(state.params)))


def test_a_state_the_optimizer_does_not_hold_raises(setup):
    pm, _, optimizer, scheduler = port_setup(setup)
    _, other, _, _ = port_setup(setup)
    with pytest.raises(ValueError, match="does not hold this state's trainable leaves"):
        make_train_step(pm, optimizer, scheduler)(other, torch_batch(setup["batch"]))


def _learning_run(setup, seed, steps):
    pm, state, optimizer, scheduler = port_setup(setup, jax_config(dropout=0.1), seed=seed)
    assert pm.config.parallel_branch.dropout == pm.config.cascaded_branch.dropout == 0.1
    step = make_train_step(pm, optimizer, scheduler)
    batch = torch_batch(setup["batch"])
    losses = []
    for _ in range(steps):
        state, metrics = step(state, batch)
        losses.append(float(metrics["train_loss"]))
    return losses


def test_train_step_learns_with_dropout(setup):
    losses = _learning_run(setup, seed=3, steps=20)
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_one_generator_seed_gives_the_same_losses(setup):
    a, b = _learning_run(setup, seed=5, steps=3), _learning_run(setup, seed=5, steps=3)
    assert a == b
    assert _learning_run(setup, seed=6, steps=3) != a  # the dropout masks did draw
