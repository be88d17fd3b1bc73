"""The port's checkpoints (``speechclip_tpu_torch.training.checkpoint``):
the monitor policy keeps the same directories and writes the same
``ckpt_index.json`` as the JAX package's ``CheckpointManager`` on one metric
sequence; a save and restore of a train state (params, kw-BN statistics,
Adam's moments, the scheduler, the step, the generator, an accumulation in
progress) is bitwise; a slim checkpoint holds no frozen leaf, and under a
partial fine-tune (``unfreeze_layers``) holds the unfrozen encoder layers
and restores them bitwise; a save cut short before its rename leaves the
previous ``last`` whole."""

import dataclasses
import os

import jax.numpy as jnp
import pytest
import torch

from speechclip_tpu.config import ConfigNode
from speechclip_tpu.training.checkpoint import CheckpointManager as JaxManager
from speechclip_tpu_torch import tiny_flagship_config
from speechclip_tpu_torch.config import ConfigTree
from speechclip_tpu_torch.models.speechclip import SpeechCLIPModel
from speechclip_tpu_torch.training import checkpoint as ckpt_mod
from speechclip_tpu_torch.training.checkpoint import (
    STATE_FILE,
    CheckpointManager,
    load_any_checkpoint,
    load_config_from_checkpoint,
    restore_inference_state,
)
from speechclip_tpu_torch.training.optim import build_optimizer, tree_leaves
from speechclip_tpu_torch.training.train_step import create_train_state, make_train_step

torch.set_num_threads(2)

HISTORY = [
    (10, {"val_loss": 5.0, "val_recall_mean_10": 10.0}),
    (20, {"val_loss": 3.0, "val_recall_mean_10": 30.0}),
    (30, {"val_loss": 4.0, "val_recall_mean_10": 20.0}),
    (40, {"val_loss": 6.0, "val_recall_mean_10": 40.0}),
    (50, {"val_loss": 2.0, "val_recall_mean_10": 5.0}),
    (60, {"val_loss": 2.0, "val_recall_mean_10": 40.0}),
    (70, {"val_recall_mean_10": 45.12345}),
]


def _tiny_state(seed=0, accum=1, **switches):
    cfg = dataclasses.replace(tiny_flagship_config(), precision=32, accumulate_grad_batches=accum,
                              **switches)
    model = SpeechCLIPModel(cfg, device="cpu")
    state = create_train_state(model, seed=seed)
    mask = model.trainable_mask(state.params)
    optimizer, scheduler = build_optimizer(cfg, state.params, mask)
    return model, state, optimizer, scheduler, make_train_step(model, optimizer, scheduler, accum)


def _batch(seed):
    gen = torch.Generator().manual_seed(seed)
    return {"wav": torch.randn(4, 2000, generator=gen),
            "wav_len": torch.tensor([2000, 1500, 1200, 2000]),
            "image": torch.randn(4, 32, 32, 3, generator=gen), "id": torch.tensor([0, 0, 1, 2])}


def _tree(root):
    """Every directory and file under ``root`` but the checkpoints' own
    contents, relative."""
    out = set()
    for dirpath, dirnames, filenames in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        if os.path.exists(os.path.join(dirpath, "meta.json")):
            dirnames[:] = []
            out.add(rel)
            continue
        out.update(os.path.join(rel, f) for f in filenames)
    return out


def test_monitor_policy_keeps_the_same_files_as_jax(tmp_path):
    _, state, optimizer, scheduler, _ = _tiny_state()
    jax_mgr = JaxManager(str(tmp_path / "jax"), save_at_steps=[20, 70])
    port_mgr = CheckpointManager(str(tmp_path / "port"), save_at_steps=[20, 70])
    for i, (step, metrics) in enumerate(HISTORY):
        if i == 4:  # a restarted run reads the index back
            jax_mgr.wait()
            jax_mgr = JaxManager(str(tmp_path / "jax"), save_at_steps=[20, 70])
            port_mgr = CheckpointManager(str(tmp_path / "port"), save_at_steps=[20, 70])
        jax_mgr.save({"w": jnp.full((2,), float(step))}, step, metrics, ConfigNode({"a": 1}))
        port_mgr.save(dataclasses.replace(state, step=step), step, metrics, ConfigTree({"a": 1}),
                      optimizer, scheduler)
    jax_mgr.wait()
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    for name in ("ckpt_index.json", "config.yaml"):
        with open(tmp_path / "port" / name) as a, open(tmp_path / "jax" / name) as b:
            assert a.read() == b.read(), name
    for monitor in ("val_loss", "val_recall_mean_10"):
        assert os.path.relpath(port_mgr.best_path(monitor), tmp_path / "port") == os.path.relpath(
            jax_mgr.best_path(monitor), tmp_path / "jax")
    assert not any(p.endswith((".tmp", ".old")) for p in _tree(tmp_path / "port"))


def _assert_same(a, b):
    la, lb = list(tree_leaves(a)), list(tree_leaves(b))
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _assert_same_optimizer(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys() and sa["state"]
    for k in sa["state"]:
        for name, v in sa["state"][k].items():
            assert torch.equal(v, sb["state"][k][name]), (k, name)


@pytest.mark.parametrize("accum", [1, 2])
def test_save_restore_round_trip_is_bitwise(tmp_path, accum):
    """After 3 steps (with accumulation 2: mid-accumulation), save; restore
    into a fresh state of another seed: every piece equals what was saved,
    and the next step equals the uninterrupted run's."""
    model, state, optimizer, scheduler, step = _tiny_state(accum=accum)
    for i in range(3):
        state, _ = step(state, _batch(i))
    mgr = CheckpointManager(str(tmp_path), save_at_steps=[3])
    mgr.save(state, 3, {"val_loss": 1.0}, ConfigTree({"a": 1}), optimizer, scheduler)
    _, fresh, f_opt, f_sched, f_step = _tiny_state(seed=9, accum=accum)
    restored = CheckpointManager(str(tmp_path)).restore(str(tmp_path / "step_3"), fresh, f_opt,
                                                        f_sched)
    _assert_same(restored.params, state.params)
    _assert_same(restored.model_state, state.model_state)
    _assert_same_optimizer(f_opt, optimizer)
    assert f_sched.state_dict() == scheduler.state_dict()
    assert restored.step == state.step == 3
    assert torch.equal(restored.generator.get_state(), state.generator.get_state())
    if accum == 2:
        _assert_same(restored.acc_grads, state.acc_grads)
    else:
        assert restored.acc_grads is None
    state, m = step(state, _batch(3))
    restored, rm = f_step(restored, _batch(3))
    assert float(m["train_loss"]) == float(rm["train_loss"])
    _assert_same(restored.params, state.params)


def test_restore_last_is_the_restore_of_last(tmp_path):
    """``restore_last`` (the JAX manager's) restores ``<root>/last``: after
    steps 1 and 2 saved, the state of step 2, optimizer and scheduler with
    it, as ``restore`` of that directory gives it."""
    model, state, optimizer, scheduler, step = _tiny_state()
    mgr = CheckpointManager(str(tmp_path), save_at_steps=[1])
    for i in (1, 2):
        state, _ = step(state, _batch(i))
        mgr.save(state, i, {"val_loss": float(i)}, ConfigTree({"a": 1}), optimizer, scheduler)
    _, fresh, f_opt, f_sched, _ = _tiny_state(seed=9)
    restored = CheckpointManager(str(tmp_path)).restore_last(fresh, f_opt, f_sched)
    assert restored.step == 2
    _assert_same(restored.params, state.params)
    _assert_same_optimizer(f_opt, optimizer)
    assert f_sched.state_dict() == scheduler.state_dict()
    _, other, _, _, _ = _tiny_state(seed=9)
    _assert_same(CheckpointManager(str(tmp_path)).restore(str(tmp_path / "last"), other).params,
                 restored.params)


def _mask_pairs(mask, saved):
    """(trainable flag, saved leaf) for every leaf of the mask."""
    if isinstance(mask, dict):
        for k in mask:
            yield from _mask_pairs(mask[k], saved[k])
    elif isinstance(mask, (list, tuple)):
        for m, v in zip(mask, saved):
            yield from _mask_pairs(m, v)
    elif mask is not None:
        yield mask, saved


def test_slim_checkpoint_holds_no_frozen_leaf(tmp_path):
    model, state, optimizer, scheduler, step = _tiny_state()
    state, _ = step(state, _batch(0))
    mask = model.trainable_mask(state.params)
    CheckpointManager(str(tmp_path / "full")).save(state, 1, {}, None, optimizer, scheduler)
    CheckpointManager(str(tmp_path / "slim"), slim_mask=mask).save(state, 1, {}, None, optimizer,
                                                                   scheduler)
    payload = torch.load(tmp_path / "slim" / "last" / STATE_FILE, weights_only=True)
    pairs = list(_mask_pairs(mask, payload["params"]))
    assert len(pairs) == len(list(tree_leaves(mask)))
    assert all((leaf is not None) == keep for keep, leaf in pairs)
    assert any(keep for keep, _ in pairs) and not all(keep for keep, _ in pairs)
    assert CheckpointManager.is_slim(str(tmp_path / "slim" / "last"))
    size = lambda d: os.path.getsize(tmp_path / d / "last" / STATE_FILE)
    assert size("slim") < size("full") / 2
    with pytest.raises(ValueError, match="slim"):
        CheckpointManager(str(tmp_path / "slim")).restore(str(tmp_path / "slim" / "last"), state)
    # the frozen towers come from load_pretrained (no files: the seeded init)
    _, fresh, f_opt, f_sched, _ = _tiny_state()
    fresh = dataclasses.replace(fresh, params=model.load_pretrained(fresh.params))
    restored = CheckpointManager(str(tmp_path / "slim"), slim_mask=mask).restore(
        str(tmp_path / "slim" / "last"), fresh, f_opt, f_sched)
    _assert_same(restored.params, state.params)


def test_slim_checkpoint_of_a_partial_fine_tune_restores_bitwise(tmp_path):
    """``unfreeze_layers: [1]``: the slim checkpoint holds encoder layer 1
    (its f32 masters, moved by two steps) and no other encoder leaf;
    restored into a fresh state whose frozen leaves come from
    ``load_pretrained``, every leaf, Adam's moments and the next step equal
    the uninterrupted run's."""
    switches = dict(audio_trainable=True, unfreeze_layers=(1,))
    model, state, optimizer, scheduler, step = _tiny_state(**switches)
    for i in range(2):
        state, _ = step(state, _batch(i))
    mask = model.trainable_mask(state.params)
    mgr = CheckpointManager(str(tmp_path), slim_mask=mask)
    mgr.save(state, 2, {}, None, optimizer, scheduler)
    saved = torch.load(tmp_path / "last" / STATE_FILE, weights_only=True)["params"]
    layers = saved["audio_encoder"]["encoder"]["layers"]
    assert all(leaf is not None and leaf.dtype == torch.float32 for leaf in tree_leaves(layers[1]))
    assert list(tree_leaves(layers[0])) == []
    assert list(tree_leaves({k: v for k, v in saved["audio_encoder"].items()
                             if k != "encoder"})) == []
    # the frozen leaves come from load_pretrained (no files: the seeded init)
    _, fresh, f_opt, f_sched, f_step = _tiny_state(**switches)
    fresh = dataclasses.replace(fresh, params=model.load_pretrained(fresh.params))
    restored = CheckpointManager(str(tmp_path), slim_mask=mask).restore(
        str(tmp_path / "last"), fresh, f_opt, f_sched)
    _assert_same(restored.params, state.params)
    _assert_same_optimizer(f_opt, optimizer)
    state, m = step(state, _batch(2))
    restored, rm = f_step(restored, _batch(2))
    assert float(m["train_loss"]) == float(rm["train_loss"])
    _assert_same(restored.params, state.params)


@pytest.mark.parametrize("where", ["torch.save", "rename"])
def test_an_interrupted_save_leaves_the_previous_last_whole(tmp_path, monkeypatch, where):
    model, state, optimizer, scheduler, step = _tiny_state()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(state, 0, {}, None, optimizer, scheduler)
    saved = [p.detach().clone() for p in tree_leaves(state.params)]
    state, _ = step(state, _batch(0))

    def cut(*args, **kwargs):
        raise KeyboardInterrupt("cut")

    if where == "torch.save":
        monkeypatch.setattr(ckpt_mod.torch, "save", cut)
    else:
        monkeypatch.setattr(ckpt_mod.os, "rename", cut)
    with pytest.raises(KeyboardInterrupt):
        mgr.save(state, 1, {}, None, optimizer, scheduler)
    monkeypatch.undo()
    _, fresh, f_opt, f_sched, _ = _tiny_state(seed=5)
    restored = mgr.restore(str(tmp_path / "last"), fresh, f_opt, f_sched)
    assert restored.step == 0
    for a, b in zip(tree_leaves(restored.params), saved):
        assert torch.equal(a, b)
    mgr.save(state, 1, {}, None, optimizer, scheduler)  # the next save cleans up
    assert sorted(os.listdir(tmp_path)) == ["ckpt_index.json", "last"]
    assert mgr.restore(str(tmp_path / "last"), fresh, f_opt, f_sched).step == 1


def test_config_and_inference_state_come_back_from_the_run_dir(tmp_path):
    from tests.test_models import tiny_speechclip_config

    node = tiny_speechclip_config(tmp_path)
    node.merge_({"audio_encoder": {"optim": {"name": "Adam", "args": {"lr": 1e-3}},
                                   "scheduler": {"name": "noam", "warmup": 2}}})
    tree = ConfigTree(node.to_dict())
    from speechclip_tpu_torch.config import model_config_from_tree

    model = SpeechCLIPModel(model_config_from_tree(tree), device="cpu")
    state = create_train_state(model, seed=0)
    optimizer, scheduler = build_optimizer(model.config, state.params,
                                           model.trainable_mask(state.params))
    CheckpointManager(str(tmp_path / "ckpts")).save(state, 2, {"val_loss": 1.5}, tree, optimizer,
                                                    scheduler)
    path = tmp_path / "ckpts" / "val_loss" / "val_loss_step2_1.5000"
    assert load_config_from_checkpoint(str(path)) == tree
    assert load_config_from_checkpoint(str(tmp_path / "ckpts" / "last")) == tree
    _, params, model_state = restore_inference_state(tree, str(path), device="cpu")
    _assert_same(params, state.params)
    # load_any_checkpoint takes a run checkpoint with the config.yaml near it
    any_model, any_params, any_state = load_any_checkpoint(str(path), device="cpu")
    assert any_model.config == model.config
    _assert_same(any_params, params)
    _assert_same(any_state, model_state)
    with pytest.raises(FileNotFoundError, match="config.yaml"):
        load_config_from_checkpoint(str(tmp_path / "nowhere" / "a" / "b"))
