"""A whole run of each tiny cell on the CPU, the card's look skipped: sound,
it is correct; with the timed path broken underneath in each way the cell
can break, ``correct`` comes out false."""

import pytest
import torch

from portbench import harness
from portbench.tests import tiny


def run(root, cache_dir, name, fault=None, seed=11):
    return harness.run_cell(name, seed, 1.0, False, device="cpu", cache_dir=cache_dir,
                            root=root, fault=fault)


class StateUnchanged:
    """The train step runs, but the trainable leaves keep their values."""

    def step(self, step_fn, state, batch, trainer):
        leaves = trainer.optimizer.param_groups[0]["params"]
        saved = [p.detach().clone() for p in leaves]
        state, metrics = step_fn(state, batch)
        with torch.no_grad():
            for p, s in zip(leaves, saved):
                p.copy_(s)
        return state, metrics


class HalfBatch:
    """The step takes the first half of the rows; the loss is their mean."""

    def step(self, step_fn, state, batch, trainer):
        n = len(batch["id"]) // 2
        return step_fn(state, {k: v[:n] for k, v in batch.items()}, )


class InWindow:
    """``fault`` planted only in the window's steps: the first steps, which
    set-up runs, stay sound."""

    def __init__(self, fault):
        self.fault = fault

    def step(self, step_fn, state, batch, trainer):
        if trainer.window.t0 is None:
            return step_fn(state, batch)
        return self.fault.step(step_fn, state, batch, trainer)


class HalfRows:
    """Half of each batch's rows come out unencoded (zero features)."""

    def encode(self, feats, idx):
        feats = feats.clone()
        feats[feats.shape[0] // 2:] = 0.0
        return feats, idx


class AnswerAltered:
    """One row's best answer is replaced by another gallery item."""

    def encode(self, feats, idx):
        idx = idx.clone()
        idx[0, 0] = (idx[0, 0] + 17) % 50
        return feats, idx


def test_train_sound(tiny_root, cache_dir):
    out = run(tiny_root, cache_dir, tiny.TRAIN)
    assert out["line"]["correct"], out["checks"]
    assert out["line"]["attempted"] > 0


@pytest.mark.parametrize("fault,number", [(StateUnchanged(), "change_gap"),
                                          (HalfBatch(), "loss_gap"),
                                          (InWindow(StateUnchanged()), "window_change_gap"),
                                          (InWindow(HalfBatch()), "window_loss_gap")],
                         ids=["state_unchanged", "half_batch", "window_state_unchanged",
                              "window_half_batch"])
def test_train_faults(tiny_root, cache_dir, fault, number):
    out = run(tiny_root, cache_dir, tiny.TRAIN, fault)
    assert not out["line"]["correct"]
    assert not out["checks"][number]["ok"]


def test_train_row_altered_where_made(tiny_root, cache_dir, monkeypatch):
    """A sample altered in the loader's batch is caught by the rows check."""
    from speechclip_tpu_torch.data.loader import BucketedLoader

    real = BucketedLoader._assemble

    def altered(self, plan, rng):
        batch = real(self, plan, rng)
        batch["wav"][0, 0] += 1.0 / 32768
        return batch

    monkeypatch.setattr(BucketedLoader, "_assemble", altered)
    out = run(tiny_root, cache_dir, tiny.TRAIN)
    assert not out["line"]["correct"]
    assert out["checks"]["rows_mismatch"]["value"] >= 1


def test_encode_sound(tiny_root, cache_dir):
    out = run(tiny_root, cache_dir, tiny.ENCODE)
    assert out["line"]["correct"], out["checks"]


@pytest.mark.parametrize("fault,number", [(HalfRows(), "feature_gap"),
                                          (AnswerAltered(), "topk_gap")],
                         ids=["half_rows", "answer_altered"])
def test_encode_faults(tiny_root, cache_dir, fault, number):
    out = run(tiny_root, cache_dir, tiny.ENCODE, fault)
    assert not out["line"]["correct"]
    assert not out["checks"][number]["ok"]
