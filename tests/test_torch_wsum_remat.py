"""The frozen weighted sum with a backward recompute (``wsum_remat``:
``models/hubert.py`` ``hubert_frozen_weighted_sum``, a
``torch.autograd.Function``) against the JAX package's custom VJP and
against the port's own plain pipeline (``hubert_apply`` under no_grad, the
normalization, ``weighted_sum_apply``), for every hidden-state
normalization; what it saves for backward; the routing and the warning of
``SpeechCLIPModel``; and the train step with the switch on against off and
against JAX's.

Tolerances: against JAX, the feature and the logits' gradient 1e-5
(``tests/test_wsum_remat.py``'s limit between its two paths) in units of
max(1, the largest JAX magnitude): the gradients here reach ~20, where f32
summation in another order differs by ~1e-5 alone; against the port's
plain pipeline, the feature bitwise except in s3prl mode (the stacked form
multiplies by the weights cast to the state dtype, the recompute by f32
weights) and there 1e-5, the gradient 1e-5 in the same units. The train
step, on against off: loss 1e-6 relative, ``grad_norm`` 1e-4 relative (as
``tests/test_wsum_remat.py``), the weighted-sum logits after the step 1e-6;
against JAX's step: ``tests/test_torch_train_step.py``'s limits.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speechclip_tpu.models import hubert as jh
from speechclip_tpu.models.speechclip import SpeechCLIPModel as JaxModel
from speechclip_tpu.training import build_optimizer as jax_build_optimizer
from speechclip_tpu.training import create_train_state as jax_create_train_state
from speechclip_tpu.training import make_train_step as jax_make_train_step
from speechclip_tpu_torch import tiny_config
from speechclip_tpu_torch.convert.from_jax import (
    speechclip_params_from_jax,
    speechclip_state_from_jax,
)
from speechclip_tpu_torch.models import hubert as ph
from speechclip_tpu_torch.models.speechclip import SpeechCLIPModel
from speechclip_tpu_torch.ops.weighted_sum import weighted_sum_apply
from speechclip_tpu_torch.training.optim import build_optimizer
from speechclip_tpu_torch.training.train_step import create_train_state, make_train_step
from tests.test_torch_config import port_config_from_jax
from tests.test_torch_hubert_large import port_hubert_config, randomize
from tests.test_torch_train_step import (
    ATOL,
    RTOL,
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

NORM_TYPES = [None, "method1", "method2", "s3prl"]
TOL = 1e-5
# tests/test_wsum_remat.py's encoder, with HuBERT-large's switches
TINY = jh.HubertConfig(
    conv_layers=((8, 10, 5), (8, 3, 2)), encoder_embed_dim=16, encoder_layers=3,
    encoder_ffn_dim=32, encoder_heads=2, downsample_rate=10,
)
TINY_LARGE = dataclasses.replace(TINY, conv_bias=True, extractor_mode="layer_norm",
                                 layer_norm_first=True, normalize_waveform=True)
LENS = np.array([400, 300, 170], np.int32)


def setup_encoder(cfg, seed=0):
    """(JAX params, the port's f32 params, logits, wav, the cotangent target)."""
    jae = jax.jit(lambda k: jh.hubert_init(k, cfg))(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    jae = randomize(jax.tree.map(np.asarray, jae), rng)
    pae = speechclip_params_from_jax({"audio_encoder": jae})["audio_encoder"]
    logits = rng.standard_normal(cfg.num_hidden_states).astype(np.float32)
    wav = (0.3 * rng.standard_normal((len(LENS), 400))).astype(np.float32)
    wav *= np.arange(400)[None, :] < LENS[:, None]
    tgt = rng.standard_normal((len(LENS), jh.conv_output_length(cfg, 400),
                               cfg.encoder_embed_dim)).astype(np.float32)
    return jae, pae, logits, wav, tgt


def assert_close(got, want):
    """Within TOL of ``want`` in units of max(1, max |want|)."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, atol=TOL * max(1.0, float(np.abs(want).max())), rtol=0)


def port_remat(pae, cfg, logits, wav, tgt, norm_type, plain=False):
    """(feature, feature lengths, the logits' gradient) of sum(feat * tgt)."""
    w = torch.from_numpy(logits).requires_grad_(True)
    feat, lens = ph.hubert_frozen_weighted_sum({"weights": w}, pae, port_hubert_config(cfg),
                                               torch.from_numpy(wav), torch.from_numpy(LENS),
                                               norm_type, plain=plain)
    (g,) = torch.autograd.grad((feat * torch.from_numpy(tgt).to(feat.dtype)).sum(), w)
    return feat.detach(), lens, g


@pytest.mark.parametrize("cfg", [TINY, TINY_LARGE], ids=["base switches", "large switches"])
@pytest.mark.parametrize("norm_type", NORM_TYPES)
def test_frozen_weighted_sum_matches_jax(norm_type, cfg):
    jae, pae, logits, wav, tgt = setup_encoder(cfg)

    def loss(ws):
        feat, lens = jh.hubert_frozen_weighted_sum(
            ws, jax.tree.map(jnp.asarray, jae), cfg, jnp.asarray(wav), jnp.asarray(LENS),
            norm_type=norm_type)
        return jnp.sum(feat * jnp.asarray(tgt).astype(feat.dtype)), (feat, lens)

    (_, (jfeat, jlens)), jg = jax.value_and_grad(loss, has_aux=True)(
        {"weights": jnp.asarray(logits)})
    feat, lens, g = port_remat(pae, cfg, logits, wav, tgt, norm_type)
    assert feat.dtype == torch.float32 and str(jfeat.dtype) == "float32"
    assert_close(feat.numpy(), jfeat)
    assert_close(g.numpy(), jg["weights"])
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))


@pytest.mark.parametrize("norm_type", NORM_TYPES)
def test_frozen_weighted_sum_matches_the_plain_pipeline(norm_type):
    """Against ``hubert_apply`` under no_grad -> the normalization ->
    ``weighted_sum_apply``, the path ``forward_audio`` takes without the
    switch; the kernel route (``plain=False``) and the plain one agree
    bitwise on the CPU."""
    _, pae, logits, wav, tgt = setup_encoder(TINY_LARGE, seed=1)
    cfg = port_hubert_config(TINY_LARGE)
    w = torch.from_numpy(logits).requires_grad_(True)
    with torch.no_grad():
        states, want_lens = ph.hubert_apply(pae, cfg, torch.from_numpy(wav),
                                            torch.from_numpy(LENS))
    if norm_type in ("method1", "method2"):
        states = ph.normalize_hidden_states(states, norm_type)
    want = weighted_sum_apply({"weights": w}, states, normalize_features=norm_type == "s3prl")
    (want_g,) = torch.autograd.grad((want * torch.from_numpy(tgt)).sum(), w)
    feat, lens, g = port_remat(pae, TINY_LARGE, logits, wav, tgt, norm_type)
    assert feat.dtype == want.dtype
    if norm_type == "s3prl":
        assert_close(feat.numpy(), want.detach().numpy())
    else:
        assert torch.equal(feat, want.detach())
    assert_close(g.numpy(), want_g.numpy())
    assert torch.equal(lens, want_lens)
    p_feat, _, p_g = port_remat(pae, TINY_LARGE, logits, wav, tgt, norm_type, plain=True)
    assert torch.equal(p_feat, feat) and torch.equal(p_g, g)


def test_encoder_and_wav_get_no_gradient():
    """The encoder is frozen: even with its leaves and the wave requiring
    grad, only the logits get one (JAX returns zeros for them)."""
    _, pae, logits, wav, tgt = setup_encoder(TINY_LARGE, seed=2)
    leaves = [t for t in jax.tree.leaves(pae) if torch.is_tensor(t)]
    for t in leaves:
        t.requires_grad_(True)
    w = torch.from_numpy(logits).requires_grad_(True)
    x = torch.from_numpy(wav).requires_grad_(True)
    feat, _ = ph.hubert_frozen_weighted_sum({"weights": w}, pae, port_hubert_config(TINY_LARGE),
                                            x, torch.from_numpy(LENS), "s3prl")
    (feat * torch.from_numpy(tgt)).sum().backward()
    assert w.grad is not None and bool(w.grad.abs().sum() > 0)
    assert x.grad is None
    assert all(t.grad is None for t in leaves)


def _saved_bytes(fn):
    """Bytes of every tensor autograd saves for backward while ``fn`` runs."""
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return sum(saved)


def test_recompute_saves_no_hidden_state():
    """What the recompute saves for backward (the logits, the wave, the
    lengths) stays under two hidden states' bytes; the plain s3prl pipeline
    saves the f32 stack of all N."""
    _, pae, logits, wav, _ = setup_encoder(TINY_LARGE, seed=3)
    cfg = port_hubert_config(TINY_LARGE)
    w = torch.from_numpy(logits).requires_grad_(True)
    x, n = torch.from_numpy(wav), torch.from_numpy(LENS)
    state_bytes = len(LENS) * ph.conv_output_length(cfg, 400) * cfg.encoder_embed_dim * 4

    def plain():
        with torch.no_grad():
            states, _ = ph.hubert_apply(pae, cfg, x, n)
        weighted_sum_apply({"weights": w}, states, normalize_features=True)

    remat = _saved_bytes(
        lambda: ph.hubert_frozen_weighted_sum({"weights": w}, pae, cfg, x, n, "s3prl"))
    assert 0 < remat < 2 * state_bytes
    assert _saved_bytes(plain) >= cfg.num_hidden_states * state_bytes


def _tiny_model(**changes):
    return SpeechCLIPModel(dataclasses.replace(tiny_config(), **changes), device="cpu")


def test_forward_audio_routes_to_the_recompute_under_jax_conditions(monkeypatch):
    """``wsum_remat`` with the weighted sum of a frozen encoder takes
    ``hubert_frozen_weighted_sum``; asked for the hidden states, or another
    selection, it does not. At eval the features equal the plain path's
    bitwise (no normalization)."""
    calls = []
    inner = ph.hubert_frozen_weighted_sum
    monkeypatch.setattr(ph, "hubert_frozen_weighted_sum",
                        lambda *a, **k: calls.append(1) or inner(*a, **k))
    off, on = _tiny_model(), _tiny_model(wsum_remat=True)
    params, _ = off.init(0)
    rng = np.random.default_rng(4)
    wav = torch.from_numpy(rng.standard_normal((2, 2000)).astype(np.float32))
    lens = torch.tensor([2000, 1500])
    want, want_len = off.forward_audio(params, wav, lens)
    assert not calls
    got, got_len = on.forward_audio(params, wav, lens)
    assert calls == [1]
    assert torch.equal(got, want) and torch.equal(got_len, want_len)
    *_, states = on.forward_audio(params, wav, lens, return_hidden_states=True)
    assert calls == [1] and len(states) == on.audio_cfg.num_hidden_states
    last = _tiny_model(wsum_remat=True, feat_select_idx="last_hidden_state")
    last.forward_audio(params, wav, lens)
    assert calls == [1]


def test_blockers_warn_once_at_construction(caplog):
    """JAX's warning: ``wsum_remat`` set where the config rules it out; a
    config where it engages stays silent."""
    with caplog.at_level(logging.WARNING, logger="speechclip_tpu_torch"):
        _tiny_model(wsum_remat=True, feat_select_idx="last_hidden_state")
    msgs = [r.getMessage() for r in caplog.records if "wsum_remat" in r.getMessage()]
    assert len(msgs) == 1 and "NOT engage" in msgs[0] and "feat_select_idx" in msgs[0]
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="speechclip_tpu_torch"):
        _tiny_model(wsum_remat=True)
    assert not [r for r in caplog.records if "wsum_remat" in r.getMessage()]


def large_switches_config(wsum_remat):
    """``tests/test_torch_train_step.py``'s tiny flagship (both branches,
    precision 32, dropout 0) with the large configs' model switches: the
    s3prl normalization, a trainable loss temperature; ``wsum_remat``."""
    cfg = jax_config()
    cfg.audio_encoder.normalize_hiddenstates = True
    cfg.audio_encoder.wsum_remat = wsum_remat
    cfg.cl_loss.args.temperature_trainable = True
    return cfg


@pytest.fixture(scope="module")
def jax_setups():
    out = {}
    batch = make_batch()
    for flag in (False, True):
        cfg = large_switches_config(flag)
        jm = JaxModel(cfg)
        tx, _ = jax_build_optimizer(cfg, jm.trainable_mask(
            jax.eval_shape(jm.init, jax.random.key(0))[0]))
        jstate = jax.jit(lambda key: jax_create_train_state(jm, tx, key))(jax.random.key(0))
        out[flag] = dict(cfg=cfg, jm=jm, tx=tx, jstate=jstate)
    out["batch"] = batch
    return out


def port_setup(setups, flag):
    s = setups[flag]
    pm = SpeechCLIPModel(port_config_from_jax(s["cfg"]), device="cpu")
    assert pm.config.wsum_remat == flag and pm.hidden_norm_type == "s3prl"
    state = create_train_state(
        pm, params=speechclip_params_from_jax(jax.tree.map(np.asarray, s["jstate"].params)),
        model_state=speechclip_state_from_jax(jax.tree.map(np.asarray, s["jstate"].model_state)),
        rng_seed=0)
    optimizer, scheduler = build_optimizer(pm.config, state.params,
                                           pm.trainable_mask(state.params))
    return pm, state, optimizer, scheduler


def test_train_step_wsum_remat_on_matches_off(jax_setups):
    out = {}
    for flag in (False, True):
        pm, state, optimizer, scheduler = port_setup(jax_setups, flag)
        step = make_train_step(pm, optimizer, scheduler)
        state, metrics = step(state, torch_batch(jax_setups["batch"]))
        out[flag] = (state, metrics)
    (s0, m0), (s1, m1) = out[False], out[True]
    np.testing.assert_allclose(float(m1["train_loss"]), float(m0["train_loss"]), rtol=1e-6)
    np.testing.assert_allclose(float(m1["grad_norm"]), float(m0["grad_norm"]), rtol=1e-4)
    np.testing.assert_allclose(s1.params["weighted_sum"]["weights"].detach().numpy(),
                               s0.params["weighted_sum"]["weights"].detach().numpy(), atol=1e-6)


def test_train_step_gradients_with_wsum_remat_match_jax(jax_setups):
    """The loss and every trainable leaf's gradient (the weighted-sum logits
    through the recompute) against JAX's with the switch on."""
    s = jax_setups[True]
    (_, jlosses), jgrads = jax_loss_and_grads(s["jm"], s["jstate"],
                                              jax_batch(jax_setups["batch"]))
    pm, state, optimizer, _ = port_setup(jax_setups, True)
    grads, losses = port_grads(pm, state, jax_setups["batch"])
    for key, value in losses.items():
        np.testing.assert_allclose(value, float(jlosses[key]), atol=ATOL, rtol=RTOL)
    want = flat(port_tree(jgrads))
    assert_grads_match(grads, want)
    ws = "['weighted_sum']['weights']"
    assert np.abs(want[ws]).max() > 0
    assert_close(grads[ws], want[ws])
    jnew, jmetrics = jax.jit(jax_make_train_step(s["jm"], s["tx"]))(
        s["jstate"], jax_batch(jax_setups["batch"]))
    _, metrics = make_train_step(pm, optimizer, port_setup(jax_setups, True)[3])(
        state, torch_batch(jax_setups["batch"]))
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jmetrics["grad_norm"]),
                               rtol=RTOL)
