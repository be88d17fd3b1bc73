"""The port's ``Trainer.fit`` against the JAX package's on
``tests/test_trainer.py``'s tiny corpus (limits in
tests/torch_trainer_common.py): 3 steps (3 one-batch epochs, a validation
and checkpoints after each) with an all-ragged dev split (its 4 pairs in
one padded batch of 8: the loss metrics come from the padded batch on both
sides), then each resumed from its own ``ckpts/last`` to step 4. The image
feature cache is tests/test_torch_trainer_cache.py."""

import os

import pytest
import torch

from tests.test_trainer import corpus, trainer_config  # noqa: F401 (fixtures)
from tests.torch_trainer_common import (
    assert_metrics_match,
    assert_trainable_leaves_match,
        fit_both,
    port_trainer,
    unresolved_elements,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def fitted(trainer_config, tmp_path_factory):  # noqa: F811
    tmp_path = tmp_path_factory.mktemp("fit")
    out = fit_both(trainer_config, tmp_path, dev_batch_size=8, cache=False)
    cfg, jt, initial, jstate, pt, pstate = out
    return tmp_path, out, unresolved_elements(jt, initial, pt)


def test_fit_matches_jax_with_an_all_ragged_dev_split(fitted):
    tmp_path, (cfg, jt, initial, jstate, pt, pstate), skip = fitted
    assert pstate.step == int(jstate.step) == 3
    assert_metrics_match(tmp_path / "port", tmp_path / "jax", steps=[1, 2, 3], validations=3)
    assert_trainable_leaves_match(pt, pstate, jstate, initial, skip, steps=3)
    ckpts = tmp_path / "port" / "ckpts"
    assert sorted(os.listdir(ckpts)) == sorted(os.listdir(tmp_path / "jax" / "ckpts"))
    for name in ("val_loss", "val_recall_mean_10"):
        assert sorted(os.listdir(ckpts / name)) == sorted(
            os.listdir(tmp_path / "jax" / "ckpts" / name))
    assert pt.loop_stats["train_wall_s"] > 0 and len(pt.loop_stats["saves"]) == 3


def test_resume_to_step_4_matches_jax(fitted):
    """JAX continues on its own trainer (its compiled steps kept); the port
    in a fresh ``Trainer``, as a restarted process would, and restores the
    optimizer, the step and the generator from ``last``."""
    tmp_path, (cfg, jt, initial, jstate, pt, pstate), skip = fitted
    jt.config.trainer.max_steps = 4
    jresumed = jt.fit(resume=os.path.join(jt.workdir, "ckpts", "last"))
    cfg.trainer.max_steps = 4
    pt2 = port_trainer(cfg, tmp_path, tmp_path / "port")
    presumed = pt2.fit(resume="auto")
    assert presumed.step == int(jresumed.step) == 4
    assert_metrics_match(tmp_path / "port", tmp_path / "jax", steps=[1, 2, 3, 4], validations=4)
    assert_trainable_leaves_match(pt2, presumed, jresumed, initial, skip, steps=4)
