"""The port's ``Trainer.fit`` with the large configs' switches against the JAX
package's (limits in tests/torch_trainer_common.py), on
``tests/test_trainer.py``'s tiny corpus: HuBERT-large's layer kinds at tiny
widths (the ``layer_norm`` extractor with conv biases, pre-norm layers, per-
utterance waveform normalization), the s3prl hidden-state normalization, a
trainable loss temperature, the image-feature cache and
``audio_encoder.wsum_remat``, as ``configs/large_*`` set them, on the
parallel branch alone as ``spchclp_p.yaml`` runs it: 3 steps with a
validation and checkpoints after each (the all-ragged dev split); its
``ckpts/last`` restored bitwise into a fresh ``Trainer``, and both packages
resumed from their own to step 4, where the trainable leaves are held as at
step 3. (At step 4 the logged ``grad_norm`` drifts to 1.4e-5 relative of
JAX's, past the per-step 1e-5: Adam's +-lr steps on the rounding-level
gradients of the first three steps, tests/torch_trainer_common.py's
unresolved elements, reach the parallel branch's gradient by then; so step
4's metrics are not held here. Both packages' resumed fits replay the loader
from its first epoch: resume restores the optimizer, the step and the
generator, not the data position.) (With the cascaded branch too, the two
packages' rounding-level gradients of the biases kw-BN cancels, which Adam
turns into steps of +-lr, flip one of the VQ's near-tie keyword ids by step
3 here: the parallel loss still agrees to 1e-6 there, the cascaded one by
1.4 %; tests/test_torch_wsum_remat.py holds that branch's step against
JAX's.)"""

import copy
import os

import torch

from tests.test_trainer import corpus, trainer_config  # noqa: F401 (fixtures)
from speechclip_tpu_torch.training.optim import tree_leaves
from tests.torch_trainer_common import (
    assert_metrics_match,
    assert_trainable_leaves_match,
    fit_both,
    port_trainer,
    read_metrics,
    unresolved_elements,
)

torch.set_num_threads(2)


def large_switches(trainer_config):  # noqa: F811
    cfg = copy.deepcopy(trainer_config)
    cfg.audio_encoder.custom.merge_({"conv_bias": True, "extractor_mode": "layer_norm",
                                     "layer_norm_first": True, "normalize_waveform": True})
    cfg.audio_encoder.normalize_hiddenstates = True
    cfg.audio_encoder.wsum_remat = True
    cfg.cl_loss.args.temperature_trainable = True
    cfg.model_settings.cascaded_objective_weight = 0.0
    return cfg


def test_fit_and_resume_with_the_large_switches_match_jax(trainer_config, tmp_path):  # noqa: F811
    cfg, jt, initial, jstate, pt, pstate = fit_both(large_switches(trainer_config), tmp_path,
                                                    dev_batch_size=8, cache=True)
    model = pt.model
    assert model.config.wsum_remat and model.hidden_norm_type == "s3prl"
    assert model.audio_cfg.extractor_mode == "layer_norm" and model.audio_cfg.layer_norm_first
    assert "criterion" in pstate.params  # the trainable temperature
    assert pstate.step == int(jstate.step) == 3
    assert_metrics_match(tmp_path / "port", tmp_path / "jax", steps=[1, 2, 3], validations=3)
    skip = unresolved_elements(jt, initial, pt)
    assert_trainable_leaves_match(pt, pstate, jstate, initial, skip, steps=3)

    # ckpts/last restores bitwise into a fresh Trainer, as a restarted
    # process would; the resumed fit's step-4 leaves against JAX's resumed fit
    last = os.path.join(tmp_path / "port", "ckpts", "last")
    fresh = port_trainer(cfg, tmp_path, tmp_path / "port")
    restored = fresh.restore(last, fresh.create_state())
    assert restored.step == 3
    for a, b in zip(tree_leaves(restored.params), tree_leaves(pstate.params)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(tree_leaves(restored.model_state), tree_leaves(pstate.model_state)):
        assert torch.equal(a, b)
    assert torch.equal(restored.generator.get_state(), pstate.generator.get_state())
    opt, want_opt = fresh.optimizer.state_dict()["state"], pt.optimizer.state_dict()["state"]
    assert opt.keys() == want_opt.keys() and all(
        torch.equal(opt[k][n], v) for k in opt for n, v in want_opt[k].items())
    jt.config.trainer.max_steps = 4
    jresumed = jt.fit(resume=os.path.join(jt.workdir, "ckpts", "last"))
    cfg.trainer.max_steps = 4
    presumed = port_trainer(cfg, tmp_path, tmp_path / "port").fit(resume="auto")
    assert presumed.step == int(jresumed.step) == 4
    got, want = read_metrics(tmp_path / "port"), read_metrics(tmp_path / "jax")
    assert [r["step"] for r in got["train"]] == [r["step"] for r in want["train"]] == [1, 2, 3, 4]
    assert_trainable_leaves_match(pt, presumed, jresumed, initial, skip, steps=4)
