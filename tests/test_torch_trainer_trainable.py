"""``Trainer.fit`` with a trainable encoder (``audio_encoder.trainable``,
HuBERT's dropout at 0) on ``tests/test_trainer.py``'s tiny corpus, at
precision 32 and dropout 0: a fit to step 2, then a fresh ``Trainer``
resumed from its ``ckpts/last`` to step 4, equals the uninterrupted fit to
step 4.

Resuming replays the loader from its first epoch (in both packages), so the
train split is one batch of all 12 pairs: every epoch holds the same pairs,
in an order of its own. The step is invariant to that order but for the
order of its sums: the per-step ``train_loss`` and ``grad_norm`` within
1e-5 relative (the trainer tests' limit), and the final trainable leaves
within 1e-5 of each leaf's largest magnitude, but for the elements whose
gradient is rounding (the attention key biases, which softmax ignores:
Adam scales such a gradient up to a full step of either sign,
tests/torch_trainer_common.py): each of those within ``steps x lr`` of its
initial value on both sides, under 2 % of the elements."""

import numpy as np
import pytest
import torch

from tests.test_trainer import corpus, trainer_config  # noqa: F401 (fixtures)
from tests.test_torch_train_step import MAX_UNRESOLVED_SHARE, flat
from tests.torch_trainer_common import RTOL, comparable_config, port_trainer, read_metrics

torch.set_num_threads(2)

PAIRS = 12  # the corpus's train split: 6 images x 2 captions


@pytest.fixture(scope="module")
def fine_tune_config(trainer_config):  # noqa: F811
    cfg = comparable_config(trainer_config, dev_batch_size=8, cache=False)
    cfg.audio_encoder.trainable = True
    cfg.audio_encoder.custom.dropout = 0.0
    cfg.audio_encoder.custom.attention_dropout = 0.0
    cfg.data.batch_size = PAIRS
    cfg.trainer.max_steps = 4
    return cfg


def test_resumed_fine_tune_equals_the_uninterrupted_one(fine_tune_config, tmp_path):
    cfg = fine_tune_config
    whole = port_trainer(cfg, tmp_path, tmp_path / "whole")
    assert whole.model.config.audio_trainable and whole.model.audio_cfg.dropout == 0.0
    full = whole.fit()
    cfg.trainer.max_steps = 2
    first = port_trainer(cfg, tmp_path, tmp_path / "resumed")
    assert first.fit().step == 2
    cfg.trainer.max_steps = 4
    resumed = port_trainer(cfg, tmp_path, tmp_path / "resumed").fit(resume="auto")
    assert resumed.step == full.step == 4
    got = read_metrics(tmp_path / "resumed")["train"]
    want = read_metrics(tmp_path / "whole")["train"]
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3, 4]
    for g, w in zip(got, want):
        for key in ("train_loss", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=RTOL, err_msg=(g["step"], key))
    mask = flat(whole.model.trainable_mask(full.params))
    encoder = [k for k, keep in mask.items() if keep and k.startswith("['audio_encoder']")]
    assert len(encoder) > 20
    a, b = flat(resumed.params), flat(full.params)
    start = flat(whole.create_state().params)
    bound = 4 * float(whole.model.config.optim.lr) * (1 + 1e-3)
    total = unresolved = 0
    for path, keep in mask.items():
        if not keep:
            continue
        apart = np.abs(a[path] - b[path]) > RTOL * np.abs(b[path]).max()
        for side in (a[path], b[path]):
            assert np.abs(side - start[path])[apart].max(initial=0) <= bound, path
        total += apart.size
        unresolved += int(apart.sum())
    assert unresolved <= MAX_UNRESOLVED_SHARE * total, (unresolved, total)
