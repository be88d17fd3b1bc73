"""The trainable encoder (``audio_encoder.trainable``, ``reinit_layers`` /
``unfreeze_layers``, HuBERT's train mode) against the JAX package at tiny
dims (``flagship_tiny_config()``), from ONE JAX ``create_train_state``
carried over by convert.from_jax (tests/test_torch_train_step.py's
helpers and limits).

- The full fine-tune at dropout 0, precision 32: the loss and every
  trainable leaf's gradient (the encoder's included) within the train-step
  tests' limits (1e-5 abs + 1e-4 of the leaf's largest JAX gradient), one
  step's ``grad_norm`` 1e-4 relative (frozen leaves carry none, as JAX's
  ``stop_gradient`` leaves do).
- Both layers trained at bf16 on the fused layers (T >= 128 frames,
  parallel branch): JAX's Pallas kernels in interpret mode with their
  custom VJPs, the port's kernels' autograd.Functions (plain recompute);
  each leaf's gradient within cosine 0.999 of JAX's f32 gradient (0.998 of
  JAX's bf16 one), each layer recomputed once.
- ``unfreeze_layers`` / ``reinit_layers``: the masks leaf by leaf against
  JAX's ``trainable_mask`` (post- and pre-norm), the partial fine-tune's
  gradients against JAX's, the reinit's fresh layers.
- ``remat`` on equal to off bitwise at dropout 0.1 with an explicit
  ``torch.Generator``: each layer draws from a generator seeded inside the
  checkpointed call, so the recompute redraws the forward's masks (drawing
  from the shared generator instead gives other gradients).
- ``layerdrop``: value and gradient against JAX's ``jnp.where(keep, y, x)``.
- Dropout statistics of the encoder input (hidden state 0): the kept
  values scaled by 1 / 0.9 exactly, the dropped share 0.1 within 3 sigma.
- ``wsum_remat`` with a trainable encoder does not engage and warns with
  JAX's blocker.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speechclip_tpu.models.speechclip import SpeechCLIPModel as JaxModel
from speechclip_tpu.ops import attention as jattn
from speechclip_tpu.training import build_optimizer as jax_build_optimizer
from speechclip_tpu.training import create_train_state as jax_create_train_state
from speechclip_tpu.training import make_train_step as jax_make_train_step
from speechclip_tpu_torch.convert.from_jax import (
    speechclip_params_from_jax,
    speechclip_state_from_jax,
)
from speechclip_tpu_torch.kernels.ffn_block import ffn_block
from speechclip_tpu_torch.kernels.mha_block import mha_layer_block
from speechclip_tpu_torch.models import hubert as ph
from speechclip_tpu_torch.models.speechclip import SpeechCLIPModel, cast_params
from speechclip_tpu_torch.training.optim import build_optimizer
from speechclip_tpu_torch.training.train_step import create_train_state, make_train_step
from tests.test_torch_config import parallel_only, port_config_from_jax
from tests.test_torch_train_step import (
    ATOL,
    RTOL,
    _np,
    assert_grads_match,
    flat,
    jax_batch,
    jax_config,
    jax_loss_and_grads,
    make_batch,
    port_grads,
    port_tree,
    torch_batch,
)

torch.set_num_threads(2)

MIN_COSINE = 0.999
MIN_COSINE_TWO_ROUNDINGS = 0.998  # two bf16 gradients, each within 0.999 of f32's
LIVE_GRAD = 1e-3  # of the largest leaf's norm: smaller gradients are rounding


def trainable_config(precision=32, dropout=0.0, **audio_encoder):
    """``flagship_tiny_config()`` at the train-step tests' settings with the
    encoder trainable, its dropout and attention dropout at ``dropout``."""
    cfg = jax_config(precision)
    cfg.audio_encoder.trainable = True
    cfg.audio_encoder.custom.dropout = dropout
    cfg.audio_encoder.custom.attention_dropout = dropout
    for key, value in audio_encoder.items():
        cfg.audio_encoder[key] = value
    return cfg


def init_both(cfg, seed=0):
    """(JAX model, JAX train state, port model, port train state) from one
    JAX ``create_train_state``."""
    jm = JaxModel(cfg)
    shapes = jax.eval_shape(jm.init, jax.random.key(0))[0]
    tx, _ = jax_build_optimizer(cfg, jm.trainable_mask(shapes))
    jstate = jax.jit(lambda key: jax_create_train_state(jm, tx, key))(jax.random.key(seed))
    pm = SpeechCLIPModel(port_config_from_jax(cfg), device="cpu")
    state = create_train_state(pm, params=speechclip_params_from_jax(_np(jstate.params)),
                               model_state=speechclip_state_from_jax(_np(jstate.model_state)))
    return jm, jstate, tx, pm, state


@pytest.fixture(scope="module")
def full():
    return init_both(trainable_config())


def test_full_fine_tune_loss_and_gradients_match_jax(full):
    jm, jstate, _, pm, state = full
    batch = make_batch()
    (_, jlosses), jgrads = jax_loss_and_grads(jm, jstate, jax_batch(batch))
    grads, losses = port_grads(pm, state, batch)
    for key, value in losses.items():
        np.testing.assert_allclose(value, float(jlosses[key]), atol=ATOL, rtol=RTOL)
    encoder = [k for k in grads if k.startswith("['audio_encoder']")]
    assert len(encoder) == len([k for k in flat(state.params) if k.startswith("['audio_encoder']")])
    assert any("['layers'][1]" in k for k in encoder) and any("pos_conv" in k for k in encoder)
    assert_grads_match(grads, flat(port_tree(jgrads)))


def test_full_fine_tune_step_grad_norm_matches_jax(full):
    """The optimizer holds the encoder's leaves (f32 masters): one step's
    loss and ``grad_norm`` (over the trainable leaves only) equal JAX's."""
    jm, jstate, tx, pm, state = full
    batch = make_batch(1)
    _, jmetrics = jax.jit(jax_make_train_step(jm, tx))(jstate, jax_batch(batch))
    state = create_train_state(pm, params=speechclip_params_from_jax(_np(jstate.params)),
                               model_state=speechclip_state_from_jax(_np(jstate.model_state)))
    optimizer, scheduler = build_optimizer(pm.config, state.params, pm.trainable_mask(state.params))
    n_encoder = sum(1 for k, keep in flat(pm.trainable_mask(state.params)).items()
                    if keep and k.startswith("['audio_encoder']"))
    held = {id(p) for p in optimizer.param_groups[0]["params"]}
    assert n_encoder > 20 and all(
        id(p) in held for p in jax.tree.leaves(state.params["audio_encoder"]))
    before = [p.detach().clone() for p in jax.tree.leaves(state.params["audio_encoder"])]
    state, metrics = make_train_step(pm, optimizer, scheduler)(state, torch_batch(batch))
    for key in ("train_loss", "grad_norm"):
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=RTOL,
                                   atol=ATOL, err_msg=key)
    after = jax.tree.leaves(state.params["audio_encoder"])
    assert sum(not torch.equal(a, b) for a, b in zip(before, after)) > len(after) // 2


@pytest.fixture
def jax_kernels(monkeypatch):
    """JAX dispatches its Pallas kernels (interpret mode) as on one TPU."""
    monkeypatch.setattr(jattn, "_on_tpu", lambda: True)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("data",))
    with jattn.kernel_mesh(mesh):
        yield


def _cosine(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _fused_batch():
    """Two waveforms of 134 frames (T * T >= 128^2)."""
    rng = np.random.default_rng(3)
    n = 2700
    wav = (0.1 * rng.standard_normal((2, n))).astype(np.float32)
    wav[1, 2600:] = 0.0
    return {"wav": wav, "wav_len": np.array([n, 2600], np.int32),
            "image": rng.standard_normal((2, 32, 32, 3)).astype(np.float32),
            "id": np.array([0, 1], np.int32)}


@pytest.mark.parametrize("pre_norm", [False, True], ids=["post", "pre"])
def test_bf16_fine_tune_on_the_fused_layers_matches_jax(jax_kernels, pre_norm):
    """Every HuBERT layer ("post" as HuBERT-base, "pre" as HuBERT-large) and
    the branch layer take the fused kernels in both packages, with a
    gradient. Both layers train (``unfreeze_layers``),
    the front end does not: JAX cannot take the gradient of its bf16
    convolutions' weights (the transpose of ``conv_general_dilated`` with
    ``preferred_element_type=f32`` meets an f32 cotangent and a bf16 operand
    and raises a TypeError). Each live leaf's bf16 gradient holds the
    direction of JAX's f32 gradient (same params, precision 32) to cosine
    0.999; against JAX's bf16 gradient, two independent bf16 roundings,
    to 0.998."""
    batch = _fused_batch()
    grads, want = {}, {}
    for precision in (16, 32):
        cfg = parallel_only(trainable_config(precision=precision, unfreeze_layers=[0, 1]))
        cfg.audio_encoder.custom.layer_norm_first = pre_norm
        jm, jstate, _, pm, state = init_both(cfg)
        (_, jlosses), jgrads = jax_loss_and_grads(jm, jstate, jax_batch(batch))
        want[precision] = flat(port_tree(jgrads))
        if precision == 16:
            mha_layer_block.recomputes = ffn_block.recomputes = 0
            grads, losses = port_grads(pm, state, batch)
            layers = pm.audio_cfg.encoder_layers + pm.config.parallel_branch.n_layers
            assert mha_layer_block.recomputes == ffn_block.recomputes == layers
            np.testing.assert_allclose(losses["loss"], float(jlosses["loss"]), rtol=1e-2)
    top = max(np.linalg.norm(w) for w in want[32].values())
    live = [k for k in grads if np.linalg.norm(want[32][k]) > LIVE_GRAD * top]
    assert sum(k.startswith("['audio_encoder']") for k in live) > 16
    worst = min((_cosine(grads[k], want[32][k]), k) for k in live)
    assert worst[0] >= MIN_COSINE, worst
    worst = min((_cosine(grads[k], want[16][k]), k) for k in live)
    assert worst[0] >= MIN_COSINE_TWO_ROUNDINGS, worst


def _mask_paths(tree):
    return [(jax.tree_util.keystr(k), bool(v))
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("pre_norm", [False, True], ids=["post-norm", "pre-norm"])
@pytest.mark.parametrize("which", ["unfreeze_layers", "reinit_layers", "none"])
def test_selected_layer_masks_equal_jax(which, pre_norm):
    """Leaf by leaf against JAX's ``trainable_mask``: only the selected
    layer trains, with the top LayerNorm of a post-norm model under
    reinit; the whole encoder without a selection."""
    cfg = trainable_config(**({} if which == "none" else {which: [1]}))
    cfg.audio_encoder.custom.layer_norm_first = pre_norm
    jm = JaxModel(cfg)
    shapes = jax.eval_shape(jm.init, jax.random.key(0))[0]
    zeros = speechclip_params_from_jax(jax.tree.map(lambda a: np.zeros(a.shape, np.float32),
                                                    shapes))
    pm = SpeechCLIPModel(port_config_from_jax(cfg), device="cpu")
    got = _mask_paths(pm.trainable_mask(zeros))
    assert got == _mask_paths(jm.trainable_mask(shapes))
    encoder = {k: v for k, v in got if k.startswith("['audio_encoder']")}
    trains = {k for k, v in encoder.items() if v}
    if which == "none":
        assert trains == set(encoder)
    else:
        top_ln = which == "reinit_layers" and not pre_norm
        assert trains == {k for k in encoder if "['layers'][1]" in k
                          or (top_ln and "['encoder']['layer_norm']" in k)}


def test_selected_layers_raise_as_jax():
    cfg = port_config_from_jax(trainable_config(unfreeze_layers=[1]))
    with pytest.raises(ValueError, match="exclusive"):
        model = SpeechCLIPModel(dataclasses.replace(cfg, reinit_layers=(0,)), device="cpu")
        model.trainable_mask(model.init(0)[0])
    with pytest.raises(ValueError, match="audio_trainable"):
        SpeechCLIPModel(dataclasses.replace(cfg, audio_trainable=False), device="cpu")


def test_unfreeze_gradients_match_jax():
    """A partial fine-tune: layer 1 alone of the encoder takes a gradient,
    equal to JAX's."""
    jm, jstate, _, pm, state = init_both(trainable_config(unfreeze_layers=[1]))
    batch = make_batch()
    (_, jlosses), jgrads = jax_loss_and_grads(jm, jstate, jax_batch(batch))
    grads, losses = port_grads(pm, state, batch)
    np.testing.assert_allclose(losses["loss"], float(jlosses["loss"]), atol=ATOL, rtol=RTOL)
    encoder = [k for k in grads if k.startswith("['audio_encoder']")]
    assert encoder and all("['layers'][1]" in k for k in encoder)
    assert_grads_match(grads, flat(port_tree(jgrads)))


def test_reinit_replaces_the_selected_layers_in_place():
    """``load_pretrained`` re-initializes layer 1 from the port's seed-0
    HuBERT init (JAX's distributions; JAX takes its own seed-0 init) into
    the train state's f32 masters, in place (the optimizer keeps them);
    layer 0 and the top LayerNorm keep their values. One step then moves
    layer 1 and the top LayerNorm alone of the encoder."""
    cfg = port_config_from_jax(trainable_config(reinit_layers=[1]))
    model = SpeechCLIPModel(cfg, device="cpu")
    state = create_train_state(model, seed=3)
    optimizer, scheduler = build_optimizer(cfg, state.params, model.trainable_mask(state.params))
    ae = state.params["audio_encoder"]
    before = {k: v.copy() for k, v in flat(ae).items()}
    leaves = jax.tree.leaves(ae["encoder"]["layers"][1])
    params = model.load_pretrained(state.params)
    state = dataclasses.replace(state, params=params)
    assert all(a is b for a, b in zip(jax.tree.leaves(params["audio_encoder"]["encoder"]
                                                      ["layers"][1]), leaves))
    fresh = ph.hubert_init(torch.Generator().manual_seed(0), model.audio_cfg)
    for k, v in flat(fresh["encoder"]["layers"][1]).items():
        np.testing.assert_array_equal(flat(params["audio_encoder"]["encoder"]["layers"][1])[k], v)
    after = {k: v.copy() for k, v in flat(params["audio_encoder"]).items()}
    changed = {k for k in after if not np.array_equal(after[k], before[k])}
    assert changed and all(k.startswith("['encoder']['layers'][1]") for k in changed)
    state, _ = make_train_step(model, optimizer, scheduler)(state, torch_batch(make_batch()))
    moved = {k for k, v in flat(state.params["audio_encoder"]).items()
             if not np.array_equal(v, after[k])}
    assert {k.split("]")[0] + "]" for k in moved} == {"['encoder']"}
    assert {k for k in moved if "['layers'][1]" not in k} == {
        "['encoder']['layer_norm']['bias']", "['encoder']['layer_norm']['scale']"}


def _hubert(cfg_kwargs, dtype=torch.float32):
    """A tiny port HuBERT (2 layers, 32 wide) from its own seeded init, and
    a batch of 3 ragged waveforms."""
    cfg = dataclasses.replace(port_config_from_jax(trainable_config()).audio, **cfg_kwargs)
    params = ph.hubert_init(torch.Generator().manual_seed(1), cfg)
    rng = np.random.default_rng(2)
    wav = torch.from_numpy((0.1 * rng.standard_normal((3, 1600))).astype(np.float32))
    lens = torch.tensor([1600, 1200, 900])
    wav = wav * (torch.arange(1600)[None] < lens[:, None])
    return cfg, cast_params(params, dtype, device="cpu"), wav.to(dtype), lens


def _leaves_requiring_grad(params):
    leaves = [p for p in jax.tree.leaves(params) if p is not None]
    for p in leaves:
        p.requires_grad_(True)
    return leaves


def _train_loss_and_grads(cfg, params, wav, lens, seed):
    leaves = _leaves_requiring_grad(params)
    states, _ = ph.hubert_apply(params, cfg, wav, lens, train=True,
                                generator=torch.Generator().manual_seed(seed))
    weights = torch.Generator().manual_seed(99)
    loss = sum((h * torch.randn(h.shape, generator=weights)).sum() for h in states)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def test_remat_equals_no_remat_bitwise_under_dropout():
    cfg, params, wav, lens = _hubert(dict(dropout=0.1, attention_dropout=0.1,
                                          activation_dropout=0.1))
    loss, grads = _train_loss_and_grads(cfg, params, wav, lens, seed=4)
    r_loss, r_grads = _train_loss_and_grads(dataclasses.replace(cfg, remat=True), params, wav,
                                            lens, seed=4)
    assert torch.equal(loss, r_loss)
    assert all(torch.equal(a, b) for a, b in zip(grads, r_grads))
    o_loss, _ = _train_loss_and_grads(cfg, params, wav, lens, seed=5)
    assert not torch.equal(loss, o_loss)  # the masks did draw


def test_the_recompute_redraws_the_forward_masks(monkeypatch):
    """Under ``remat`` each layer's dropout runs twice (the forward, then
    the recompute in the backward) and draws the same masks both times; a
    layer drawing from the shared generator instead (what
    ``torch.utils.checkpoint`` cannot restore) gets other masks in the
    recompute and other gradients."""
    cfg, params, wav, lens = _hubert(dict(dropout=0.1, attention_dropout=0.1,
                                          activation_dropout=0.1, remat=True))
    masks = []
    real = ph.dropout

    def spy(x, rate, train, generator):
        out = real(x, rate, train, generator)
        if train and rate > 0:
            masks.append((out == 0).detach().clone())
        return out

    monkeypatch.setattr(ph, "dropout", spy)
    loss, grads = _train_loss_and_grads(cfg, params, wav, lens, seed=4)
    per_forward = 1 + 3 * cfg.encoder_layers  # the input, then 3 a layer
    assert len(masks) == per_forward + 3 * cfg.encoder_layers
    first, again = masks[1:per_forward], masks[per_forward:]
    # the backward recomputes the last layer first
    recomputed = again[3:] + again[:3]
    assert all(torch.equal(a, b) for a, b in zip(first, recomputed))

    shared = torch.Generator().manual_seed(7)
    monkeypatch.setattr(ph, "seeded_generator", lambda seed, device, like=None: shared)
    _, wrong = _train_loss_and_grads(cfg, params, wav, lens, seed=4)
    shared.manual_seed(7)
    _, right = _train_loss_and_grads(dataclasses.replace(cfg, remat=False), params, wav, lens,
                                     seed=4)
    assert not all(torch.equal(a, b) for a, b in zip(wrong, right))


@pytest.mark.parametrize("keep", [True, False])
def test_layerdrop_select_matches_jax_where(keep):
    rng = np.random.default_rng(int(keep))
    y, x, g = (rng.standard_normal((2, 5, 4)).astype(np.float32) for _ in range(3))
    want, vjp = jax.vjp(lambda a, b: jnp.where(jnp.asarray(keep), a, b), jnp.asarray(y),
                        jnp.asarray(x))
    jy, jx = vjp(jnp.asarray(g))
    ty, tx = (torch.from_numpy(a).requires_grad_(True) for a in (y, x))
    got = ph.layerdrop_select(torch.tensor(keep), ty, tx)
    gy, gx = torch.autograd.grad(got, (ty, tx), torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(gy.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(gx.numpy(), np.asarray(jx))


@pytest.mark.parametrize("layerdrop", [1.0, 0.5])
def test_layerdrop_keeps_the_input_or_the_output(layerdrop):
    """Rate 1 drops every layer (each hidden state is the input); at 0.5
    each layer's state is its input or its output as computed alone."""
    cfg, params, wav, lens = _hubert(dict(dropout=0.0, attention_dropout=0.0,
                                          layerdrop=layerdrop))
    states, _ = ph.hubert_apply(params, cfg, wav, lens, train=True,
                                generator=torch.Generator().manual_seed(0))
    layers = params["encoder"]["layers"]
    frame_lens = ph.conv_frame_valid_lengths(lens, wav.shape[1], states[0].shape[1])
    kept = []
    for i, layer in enumerate(layers):
        out = ph.encoder_layer_apply(layer, cfg, states[i], frame_lens)
        kept.append(torch.equal(states[i + 1], out))
        assert kept[-1] or torch.equal(states[i + 1], states[i])
    if layerdrop == 1.0:
        assert not any(kept)


@pytest.mark.parametrize("changes", [dict(dropout=0.1), dict(dropout=0.0, attention_dropout=0.0,
                                                              layerdrop=0.5)],
                         ids=["dropout", "layerdrop alone"])
def test_train_mode_that_draws_needs_a_generator(changes):
    """A train-mode call that draws (dropout or layerdrop > 0) without a
    generator raises; at dropout and layerdrop 0 it needs none and equals
    the eval call."""
    cfg, params, wav, lens = _hubert(changes)
    with pytest.raises(ValueError, match="generator"):
        ph.hubert_apply(params, cfg, wav, lens, train=True)
    cfg, params, wav, lens = _hubert(dict(dropout=0.0, attention_dropout=0.0))
    with torch.no_grad():
        train, _ = ph.hubert_apply(params, cfg, wav, lens, train=True)
        evals, _ = ph.hubert_apply(params, cfg, wav, lens)
    assert all(torch.equal(a, b) for a, b in zip(train, evals))


def test_encoder_input_dropout_statistics():
    """Hidden state 0 in train mode is the eval-mode input with dropout
    0.1: each element 0 or scaled by 1 / 0.9; the dropped share 0.1 within
    3 sigma, the mean of train / eval over the kept ones 1 / 0.9."""
    cfg, params, wav, lens = _hubert(dict(dropout=0.1, attention_dropout=0.0))
    wav = wav.repeat(8, 1)
    lens = lens.repeat(8)
    with torch.no_grad():
        train, _ = ph.hubert_apply(params, cfg, wav, lens, train=True,
                                   generator=torch.Generator().manual_seed(0))
        evals, _ = ph.hubert_apply(params, cfg, wav, lens)
    x, x_eval = train[0], evals[0]
    live = x_eval != 0
    dropped = (x == 0) & live
    n = int(live.sum())
    share = float(dropped.sum()) / n
    assert abs(share - 0.1) <= 3 * (0.1 * 0.9 / n) ** 0.5, (share, n)
    torch.testing.assert_close(x[live & ~dropped], x_eval[live & ~dropped] / 0.9,
                               rtol=1e-6, atol=0)


def test_wsum_remat_with_a_trainable_encoder_warns_and_stays_off(caplog):
    cfg = trainable_config()
    cfg.audio_encoder.wsum_remat = True
    with caplog.at_level(logging.WARNING):
        JaxModel(cfg)
        pm = SpeechCLIPModel(port_config_from_jax(cfg), device="cpu")
    assert not pm.wsum_remat_engaged
    lines = {r.name: r.getMessage() for r in caplog.records
             if "wsum_remat is set" in r.getMessage()}
    assert set(lines) == {"speechclip_tpu.models.speechclip",
                          "speechclip_tpu_torch.models.speechclip"}
    assert all("audio_encoder.trainable=true (the backward recompute assumes a frozen, "
               "deterministic encoder)" in line for line in lines.values())
