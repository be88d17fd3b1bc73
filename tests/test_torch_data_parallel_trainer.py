"""The port's ``Trainer.fit`` at world 2 (two gloo ranks on the CPU, from
tests/test_torch_dp_worker.py) against the JAX package's ``Trainer`` on two
virtual CPU devices, on ``tests/test_trainer.py``'s tiny corpus and config
(tests/torch_trainer_common.py's comparable form and limits): 3 steps with
the all-ragged dev split (its 4 pairs padded to one batch of 8, 4 rows a
rank), each package resumed from its own ``ckpts/last`` to step 4. The
port starts from JAX's initial params. Only rank 0 writes the run
directory. JAX's divisibility errors, word for word. A fit at
``trainer.model_parallel: 2`` (two gloo ranks, data 1, model 2) against
JAX's at the same setting, and its checkpoint restored at world 1."""

import concurrent.futures
import os
import types

import jax
import numpy as np
import pytest
import torch

from speechclip_tpu.ops.kw_bn import kw_bn_apply as jax_kw_bn_apply
from speechclip_tpu.training.train_step import create_train_state as jax_create_train_state
from speechclip_tpu.training.trainer import Trainer as JaxTrainer
from speechclip_tpu_torch.config import load_config
from speechclip_tpu_torch.ops.kw_bn import kw_bn_apply
from speechclip_tpu_torch.parallel.mesh import DataMesh
from speechclip_tpu_torch.training.trainer import Trainer
from tests.test_torch_dp_worker import flat as flat_params
from tests.test_torch_dp_worker import run_ranks, run_trainer
from tests.test_trainer import corpus, trainer_config  # noqa: F401 (fixtures)
from tests.torch_trainer_common import (
    assert_metrics_match,
    assert_trainable_leaves_match,
    carried,
    comparable_config,
    unresolved_elements,
)

torch.set_num_threads(2)


def _tree(flat_params, like):
    """A rank's flat {path: array} params back in ``like``'s tree."""
    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}['{k}']") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, f"{prefix}[{i}]") for i, v in enumerate(node)]
        return None if node is None else flat_params[prefix]
    return walk(like, "")


@pytest.fixture(scope="module")
def fitted(trainer_config, tmp_path_factory):  # noqa: F811
    tmp = tmp_path_factory.mktemp("dp_fit")
    cfg = comparable_config(trainer_config, dev_batch_size=8, cache=False)
    paths = {}
    for steps in (3, 4):
        cfg.trainer.max_steps = steps
        paths[steps] = tmp / f"config_{steps}.yaml"
        paths[steps].write_text(cfg.to_yaml())
    cfg.trainer.max_steps = 3
    jt = JaxTrainer(cfg, workdir=str(tmp / "jax"), tokenizer=None, devices=jax.devices()[:2])
    assert jt.n_data == 2
    initial = jax_create_train_state(jt.model, jt.tx, jax.random.key(jt.seed))
    params, model_state = carried(initial)
    spec = {"world": 2, "config": str(paths[3]), "resume_config": str(paths[4]),
            "workdir": str(tmp / "port"), "params": params, "state": model_state}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, spec, tmp_path_factory.mktemp("ranks"), run_trainer,
                            "trainer")
        jstate = jt.fit()
        jt.config.trainer.max_steps = 4
        jresumed = jt.fit(resume=os.path.join(jt.workdir, "ckpts", "last"))
        ranks = ranks.result()
    # a world-1 trainer over the same config: the model, its masks and the lr
    pt = Trainer(load_config(str(paths[3])), workdir=str(tmp / "masks"), device="cpu")
    like = pt.create_state(params, model_state).params
    return {"tmp": tmp, "jt": jt, "initial": initial, "jstate": jstate, "jresumed": jresumed,
            "ranks": ranks, "pt": pt, "like": like, "skip": unresolved_elements(jt, initial, pt)}


def _state(fitted, rank, key):
    got = fitted["ranks"][rank][key]
    return types.SimpleNamespace(step=got["step"], params=_tree(got["params"], fitted["like"]))


def test_fit_at_world_2_matches_jax_on_two_devices(fitted):
    """3 steps and 3 validations, then the resumed fit's fourth: every
    logged train and val metric, the checkpoints, the trainable leaves; the
    two ranks end with the same params bit for bit."""
    tmp, pt = fitted["tmp"], fitted["pt"]
    assert_metrics_match(tmp / "port", tmp / "jax", steps=[1, 2, 3, 4], validations=4)
    fit, resumed = _state(fitted, 0, "fit"), _state(fitted, 0, "resume")
    assert fit.step == int(fitted["jstate"].step) == 3
    assert resumed.step == int(fitted["jresumed"].step) == 4
    assert_trainable_leaves_match(pt, fit, fitted["jstate"], fitted["initial"], fitted["skip"],
                                  steps=3)
    assert_trainable_leaves_match(pt, resumed, fitted["jresumed"], fitted["initial"],
                                  fitted["skip"], steps=4)
    for key in ("fit", "resume"):
        a, b = (fitted["ranks"][r][key]["params"] for r in (0, 1))
        assert a.keys() == b.keys()
        for path in a:
            np.testing.assert_array_equal(a[path], b[path], err_msg=(key, path))
    ckpts = tmp / "port" / "ckpts"
    assert sorted(os.listdir(ckpts)) == sorted(os.listdir(tmp / "jax" / "ckpts"))
    for name in ("val_loss", "val_recall_mean_10"):
        assert sorted(os.listdir(ckpts / name)) == sorted(
            os.listdir(tmp / "jax" / "ckpts" / name))


def test_only_rank_0_writes_the_run_directory(fitted):
    """One metrics line a step and a validation (none from rank 1), and the
    run directory holds what JAX's does."""
    tmp = fitted["tmp"]
    with open(tmp / "port" / "metrics.jsonl") as f:
        lines = f.read().splitlines()
    assert len(lines) == 4 + 4
    assert sorted(os.listdir(tmp / "port")) == sorted(os.listdir(tmp / "jax"))


def _port_trainer(cfg, tmp_path, world):
    path = tmp_path / f"world{world}.yaml"
    path.write_text(cfg.to_yaml())
    mesh = DataMesh(rank=0, world_size=world, device=torch.device("cpu"))
    return Trainer(load_config(str(path)), workdir=str(tmp_path / f"port{world}"), mesh=mesh)


def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_the_divisibility_errors_are_jax_s_word_for_word(trainer_config, tmp_path):  # noqa: F811
    """``data.batch_size`` and the eval batch size over 3 ranks (8 rows),
    and kw-BN's ``replica_groups`` 3 over a global batch of 8 on 2 ranks.
    The port's checks run before any collective, so a world without a
    process group stands in for the ranks."""
    cfg = comparable_config(trainer_config, dev_batch_size=8, cache=False)
    jt = JaxTrainer(cfg, workdir=str(tmp_path / "jax"), tokenizer=None,
                    devices=jax.devices()[:3])
    pt = _port_trainer(cfg, tmp_path, 3)
    want = _error(jt.fit)
    assert "data.batch_size=8 must be divisible by the data-mesh size 3" in want
    assert _error(pt.fit) == want
    want = _error(lambda: jt.validate(None))
    assert "eval batch size 8 must be divisible by the data-mesh size 3" in want
    assert _error(lambda: pt.validate(None)) == want
    x = np.random.default_rng(0).standard_normal((8, 4, 6)).astype(np.float32)
    params = {"scale": np.ones(24, np.float32), "bias": np.zeros(24, np.float32)}
    state = {"mean": np.zeros(24, np.float32), "var": np.ones(24, np.float32)}
    want = _error(lambda: jax_kw_bn_apply(params, state, x, batchnorm_type="eachKw",
                                          parallel=True, train=True, replica_groups=3))
    mesh = DataMesh(rank=0, world_size=2, device=torch.device("cpu"))
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    ts = {k: torch.from_numpy(v) for k, v in state.items()}
    got = _error(lambda: kw_bn_apply(tp, ts, torch.from_numpy(x[:4]), batchnorm_type="eachKw",
                                     parallel=True, train=True, replica_groups=3, mesh=mesh))
    assert got == want == "batch 8 not divisible by replica_groups 3"


def test_a_trainer_at_model_parallel_2_steps_as_jax_s(trainer_config, tmp_path):  # noqa: F811
    """``trainer.model_parallel: 2`` on two gloo ranks (data 1, model 2;
    tests/test_torch_tp_worker.py's ranks) against JAX's ``Trainer`` on
    two virtual devices at the same setting: 3 steps and 3 validations,
    then a resume to step 4, every logged metric and the trainable leaves
    within tests/torch_trainer_common.py's limits but ``grad_norm``, held
    to 3e-5 relative: JAX's own model-2 fit moves it 1.45e-5 from the
    port's world-1 fit by step 3 (XLA's partitioned sums; the port's
    model-2 fit stays within 4e-6 of world 1). The ranks' gathered params
    are bitwise equal; the model-2 run's ``ckpts/last`` restores at world
    1 into those params bit for bit."""
    from tests.test_torch_tp_worker import run_ranks as run_tp_ranks
    from tests.test_torch_tp_worker import run_trainer as run_tp_trainer

    cfg = comparable_config(trainer_config, dev_batch_size=8, cache=False)
    paths = {}
    for steps in (3, 4):
        cfg.trainer.max_steps = steps
        cfg.trainer.model_parallel = 2
        paths[steps] = tmp_path / f"config_{steps}.yaml"
        paths[steps].write_text(cfg.to_yaml())
    cfg.trainer.model_parallel = 1
    (tmp_path / "world1.yaml").write_text(cfg.to_yaml())
    cfg.trainer.max_steps = 3
    cfg.trainer.model_parallel = 2
    jt = JaxTrainer(cfg, workdir=str(tmp_path / "jax"), tokenizer=None, devices=jax.devices()[:2])
    assert (jt.n_data, jt.mesh.shape["model"]) == (1, 2)
    initial = jax_create_train_state(jt.model, jt.tx, jax.random.key(jt.seed))
    params, model_state = carried(initial)
    spec = {"world": 2, "model": 2, "config": str(paths[3]), "resume_config": str(paths[4]),
            "workdir": str(tmp_path / "port"), "params": params, "state": model_state}
    (tmp_path / "ranks").mkdir()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_tp_ranks, spec, tmp_path / "ranks", run_tp_trainer, "trainer")
        jstate = jt.fit()
        jt.config.trainer.max_steps = 4
        jresumed = jt.fit(resume=os.path.join(jt.workdir, "ckpts", "last"))
        ranks = ranks.result()
    assert_metrics_match(tmp_path / "port", tmp_path / "jax", steps=[1, 2, 3, 4], validations=4,
                         norm_rtol=3e-5)
    pt = Trainer(load_config(str(tmp_path / "world1.yaml")), workdir=str(tmp_path / "world1"),
                 device="cpu")
    like = pt.create_state(params, model_state).params
    skip = unresolved_elements(jt, initial, pt)
    for key, jax_state, steps in (("fit", jstate, 3), ("resume", jresumed, 4)):
        got = [types.SimpleNamespace(step=r[key]["step"], params=_tree(r[key]["params"], like))
               for r in ranks]
        assert got[0].step == int(jax_state.step) == steps
        assert_trainable_leaves_match(pt, got[0], jax_state, initial, skip, steps=steps)
        a, b = (r[key]["params"] for r in ranks)
        for path in a:
            np.testing.assert_array_equal(a[path], b[path], err_msg=(key, path))
    restored = pt.restore(str(tmp_path / "port" / "ckpts" / "last"), pt.create_state())
    assert restored.step == 4
    want = ranks[0]["resume"]["params"]
    for path, leaf in flat_params(restored.params).items():
        np.testing.assert_array_equal(leaf, want[path], err_msg=path)
