"""Shared by tests/test_torch_trainer*.py: the JAX package's ``Trainer.fit``
and the port's on ``tests/test_trainer.py``'s tiny corpus and config (at
precision 32, dropout 0, no tokenizer on either side), the port started
from the initial params JAX's fit builds (``create_train_state`` from the
same seed, carried across with ``convert/from_jax.py``).

Limits: per-step ``train_loss``, ``grad_norm`` and ``val_loss`` 1e-5
relative; the logged lr and the recalls equal; the final trainable leaves
within 1e-5 + 1e-4 of each leaf's largest magnitude (the train-step tests'
limit), but for the elements whose first gradient the packages do not
resolve (tests/test_torch_train_step.py's ``unresolved``: the attention key
biases, which softmax ignores, and the biases kw-BN's batch mean cancels
have a gradient of pure rounding, which Adam scales up to full steps of
either sign): each of those is held to the bound of its updates, ``steps x
lr`` from its initial value, on both sides, and they stay under
``MAX_UNRESOLVED_SHARE`` of the elements."""

import copy
import json

import jax
import numpy as np

from speechclip_tpu.training.train_step import create_train_state as jax_create_train_state
from speechclip_tpu.training.trainer import Trainer as JaxTrainer
from speechclip_tpu_torch.config import load_config
from speechclip_tpu_torch.convert.from_jax import (
    speechclip_params_from_jax,
    speechclip_state_from_jax,
)
from speechclip_tpu_torch.training.trainer import Trainer
from speechclip_tpu_torch.training.train_step import create_train_state
from tests.test_torch_train_step import (
    MAX_UNRESOLVED_SHARE,
    flat,
    jax_loss_and_grads,
    port_grads,
    port_tree,
    unresolved,
)

RTOL = 1e-5
ATOL, LEAF_RTOL = 1e-5, 1e-4


def comparable_config(trainer_config, dev_batch_size, cache):
    """``trainer_config`` (tests/test_trainer.py) at dropout 0, the tiny
    tower's 32-pixel images, no keyword diagnostics."""
    cfg = copy.deepcopy(trainer_config)
    for branch in ("parallel_branch", "cascaded_branch"):
        cfg.model_settings[branch].transformer_args.dropout = 0.0
    cfg.data.dataset.image_size = 32
    cfg.data.dev_batch_size = dev_batch_size
    cfg.trainer.cache_image_features = cache
    cfg.log_setting.log_detokenize_results = False
    return cfg


def run_jax(cfg, workdir):
    """(trainer, the initial state its fit builds, the final state)."""
    trainer = JaxTrainer(cfg, workdir=str(workdir), tokenizer=None,
                         devices=[jax.devices()[0]])
    initial = jax_create_train_state(trainer.model, trainer.tx, jax.random.key(trainer.seed))
    return trainer, initial, trainer.fit()


def port_trainer(cfg, tmp_path, workdir):
    """The port's trainer over the config as JAX writes it and the port
    reads it back."""
    path = tmp_path / f"{workdir.name}.yaml"
    path.write_text(cfg.to_yaml())
    return Trainer(load_config(str(path)), workdir=str(workdir), device="cpu")


def carried(jax_state):
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    return (speechclip_params_from_jax(np_tree(jax_state.params)),
            speechclip_state_from_jax(np_tree(jax_state.model_state)))


def read_metrics(workdir):
    """{"train": [per-step records], "val": [per-validation records]}."""
    out = {"train": [], "val": []}
    with open(workdir / "metrics.jsonl") as f:
        for line in f:
            rec = json.loads(line)
            out["train" if "train_loss" in rec else "val"].append(rec)
    return out


def assert_metrics_match(port_dir, jax_dir, steps, validations):
    got, want = read_metrics(port_dir), read_metrics(jax_dir)
    assert [r["step"] for r in got["train"]] == [r["step"] for r in want["train"]] == steps
    for g, w in zip(got["train"], want["train"]):
        for key in ("train_loss", "train_p_cl_loss", "train_c_cl_loss", "grad_norm"):
            np.testing.assert_allclose(g[key], w[key], rtol=RTOL, err_msg=(g["step"], key))
        assert g["lr"] == w["lr"], g["step"]
        assert g["steps_per_sec"] > 0
    assert len(got["val"]) == len(want["val"]) == validations
    for g, w in zip(got["val"], want["val"]):
        assert g["step"] == w["step"]
        np.testing.assert_allclose(g["val_loss"], w["val_loss"], rtol=RTOL)
        recalls = {k: v for k, v in w.items() if "recall" in k}
        assert len(recalls) == 11 and {k: g[k] for k in recalls} == recalls


def unresolved_elements(jax_trainer, initial, port_trainer):
    """{path: bool mask} of the trainable elements whose gradient on the
    first train batch, at the initial params, the packages do not resolve
    (tests/test_torch_train_step.py's ``unresolved``)."""
    cache = jax_trainer.config.trainer.cache_image_features
    jax_trainer.config.trainer.cache_image_features = False  # the batch with its images
    try:
        batch = next(iter(jax_trainer.build_loaders()[0]))
    finally:
        jax_trainer.config.trainer.cache_image_features = cache
    (_, _), jgrads = jax_loss_and_grads(jax_trainer.model, initial,
                                        {k: jax.numpy.asarray(v) for k, v in batch.items()})
    params, model_state = carried(initial)
    state = create_train_state(port_trainer.model, params=params, model_state=model_state)
    pgrads, _ = port_grads(port_trainer.model, state, batch)
    return unresolved(jgrads, pgrads)


def assert_trainable_leaves_match(trainer, port_state, jax_state, jax_initial, skip, steps):
    """Each trainable leaf within ATOL + LEAF_RTOL of its largest JAX
    magnitude, but the ``skip`` elements: within ``steps x lr`` of their
    initial value on both sides, and under MAX_UNRESOLVED_SHARE of all."""
    want, start = flat(port_tree(jax_state.params)), flat(port_tree(jax_initial.params))
    got = flat(port_state.params)
    mask = flat(trainer.model.trainable_mask(port_state.params))
    live = [path for path, keep in mask.items() if keep]
    assert len(live) > 10 and set(live) == set(skip)
    bound = steps * float(trainer.model.config.optim.lr) * (1 + 1e-3)
    total = n_skip = 0
    for path in live:
        w, g, s = want[path], got[path], skip[path]
        total += w.size
        n_skip += int(s.sum())
        for side in (g, w):
            assert np.abs(side - start[path])[s].max(initial=0) <= bound, path
        np.testing.assert_allclose(g[~s], w[~s], atol=ATOL + LEAF_RTOL * np.abs(w).max(), rtol=0,
                                   err_msg=path)
    assert n_skip <= MAX_UNRESOLVED_SHARE * total, (n_skip, total)


def fit_both(trainer_config, tmp_path, dev_batch_size, cache):
    """Both fits to ``trainer.max_steps`` (3) -> (cfg, JAX trainer, JAX
    initial and final state, port trainer, port final state)."""
    cfg = comparable_config(trainer_config, dev_batch_size, cache)
    jt, initial, jstate = run_jax(cfg, tmp_path / "jax")
    pt = port_trainer(cfg, tmp_path, tmp_path / "port")
    params, model_state = carried(initial)
    pstate = pt.fit(initial_params=params, initial_model_state=model_state)
    return cfg, jt, initial, jstate, pt, pstate
