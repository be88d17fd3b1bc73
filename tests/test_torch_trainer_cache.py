"""The port's ``Trainer.fit`` with ``trainer.cache_image_features`` against
the JAX package's (limits in tests/torch_trainer_common.py): the train
loader ships no image, the frozen image tower's features of the unique
images are computed once and gathered by pair id, and validation uses its
own cache; a dev batch size of 2 gives full batches only."""

import numpy as np
import pytest
import torch

from tests.test_trainer import corpus, trainer_config  # noqa: F401 (fixtures)
from tests.torch_trainer_common import (
    assert_metrics_match,
    assert_trainable_leaves_match,
        fit_both,
    unresolved_elements,
)

torch.set_num_threads(2)


def test_fit_with_the_image_feature_cache_matches_jax(trainer_config, tmp_path):  # noqa: F811
    cfg, jt, initial, jstate, pt, pstate = fit_both(trainer_config, tmp_path, dev_batch_size=2,
                                                    cache=True)
    assert pstate.step == int(jstate.step) == 3
    assert_metrics_match(tmp_path / "port", tmp_path / "jax", steps=[1, 2, 3], validations=3)
    assert_trainable_leaves_match(pt, pstate, jstate, initial, unresolved_elements(jt, initial, pt),
                                  steps=3)
    assert pt.loop_stats["image_cache_s"] > 0
    # one eval cache for the three validations (the tower is frozen)
    assert len(pt._eval_img_caches) == 1
    (_, feats, id2row), = pt._eval_img_caches.values()
    loader = pt.build_eval_loader("dev")
    want_feats, want_rows = jt.build_image_feature_cache(loader.dataset, jstate.params)
    assert id2row == want_rows
    np.testing.assert_allclose(feats, want_feats, atol=1e-5)


def test_pad_batch_and_cache_injection_equal_jax():
    from speechclip_tpu.training import trainer as jax_trainer
    from speechclip_tpu_torch.training import trainer as port_trainer

    rng = np.random.default_rng(0)
    cache = rng.standard_normal((5, 4)).astype(np.float32)
    id2row = {10 + i: i for i in range(5)}
    batch = {"wav": rng.standard_normal((3, 8)).astype(np.float32),
             "wav_len": np.array([8, 5, 6], np.int32), "id": np.array([12, 10, 14], np.int64),
             "image": np.zeros((3, 2, 2, 3), np.float32)}
    for module in (jax_trainer, port_trainer):
        assert "image" not in module._inject_cached_image_feats(batch, cache, id2row)
    got = port_trainer._pad_batch(port_trainer._inject_cached_image_feats(batch, cache, id2row), 5)
    want = jax_trainer._pad_batch(jax_trainer._inject_cached_image_feats(batch, cache, id2row), 5)
    assert got[1] == want[1] == 3
    for k in want[0]:
        np.testing.assert_array_equal(got[0][k], want[0][k])
    assert list(got[0]["id"][3:]) == [-1, -2]
    with pytest.raises(KeyError):
        port_trainer._inject_cached_image_feats(dict(batch, id=np.array([99])), cache, id2row)
