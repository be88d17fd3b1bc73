"""The port's CLI, ``python -m speechclip_tpu_torch.run_task``, end to end
on ``tests/test_cli.py``'s synthetic corpus and config, in subprocesses that
never import jax: ``--train --platform cpu``, then ``--test --ckpt`` on the
test split and ``--eval --resume`` on the dev split; the task-first usage
error; a reference Lightning ``.ckpt`` evaluated and warm-started from, against
the JAX package's CLI in this process."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from speechclip_tpu_torch import run_task
from tests.test_cli import cli_setup  # noqa: F401 (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASK = "TrainKWClip_GeneralTransformer"

# runs the module as `python -m` does, then reports whether jax was imported
DRIVER = textwrap.dedent("""
    import runpy, sys
    sys.argv = ["speechclip_tpu_torch.run_task", *sys.argv[1:]]
    runpy.run_module("speechclip_tpu_torch.run_task", run_name="__main__", alter_sys=True)
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "yaml", "speechclip_tpu"))
    print("FORBIDDEN", bad)
""")


def run_port_cli(*args):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-c", DRIVER, *args], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=600)


def test_train_then_test_then_eval(cli_setup):  # noqa: F811
    cfg_path, exp = cli_setup
    save = exp / "port_run"
    result = run_port_cli(TASK, "--config", str(cfg_path), "--train", "--platform", "cpu",
                          "--save_path", str(save), "--override", "data.dataset.image_size=32",
                          "trainer.max_steps=2")
    assert result.returncode == 0, result.stderr[-3000:]
    assert "FORBIDDEN []" in result.stdout
    last = save / "ckpts" / "last"
    assert (last / "state.pt").exists() and (save / "ckpts" / "config.yaml").exists()
    with open(save / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records if "train_loss" in r] == [1, 2]
    assert sum("val_loss" in r for r in records) == 2

    result = run_port_cli(TASK, "--config", str(cfg_path), "--test", "--ckpt", str(last),
                          "--platform", "cpu", "--save_path", str(exp / "port_test"),
                          "--override", "data.dataset.image_size=32")
    assert result.returncode == 0, result.stderr[-3000:]
    assert "FORBIDDEN []" in result.stdout
    assert "validation metrics (test)" in result.stderr, result.stderr[-3000:]
    assert "Flickr8k (test): 3 samples" in result.stderr

    # --resume takes the config beside the checkpoint
    result = run_port_cli(TASK, "--eval", "--resume", str(last), "--platform", "cpu")
    assert result.returncode == 0, result.stderr[-3000:]
    assert "validation metrics (dev)" in result.stderr
    assert "Flickr8k (dev): 2 samples" in result.stderr


def test_flags_before_the_task_is_a_usage_error():
    result = subprocess.run(
        [sys.executable, "-m", "speechclip_tpu_torch.run_task", "--config", "x.yaml", TASK,
         "--train"], capture_output=True, text=True, cwd=REPO, timeout=120)
    assert result.returncode == 2, (result.returncode, result.stderr)
    assert "task name must come first" in result.stderr and TASK in result.stderr
    assert "AttributeError" not in result.stderr


# dropout 0 on both sides, so the two fits draw no masks (the limits of
# tests/torch_trainer_common.py)
COMPARABLE = ["data.dataset.image_size=32",
              "model_settings.parallel_branch.transformer_args.dropout=0.0",
              "model_settings.cascaded_branch.transformer_args.dropout=0.0"]


@pytest.fixture(scope="module")
def reference_ckpt(cli_setup):  # noqa: F811
    """A synthetic reference Lightning ``.ckpt`` (tests/test_reference_ckpt.py's
    state-dict names) whose pickled config is the CLI corpus's config."""
    import torch
    import yaml

    from speechclip_tpu.config import ConfigNode
    from tests.test_reference_ckpt import build_reference_ckpt

    cfg_path, exp = cli_setup
    ckpt, _ = build_reference_ckpt(ConfigNode(yaml.safe_load(cfg_path.read_text())))
    path = exp / "epoch=3-step=120.ckpt"
    torch.save(ckpt, str(path))
    return str(path)


def run_jax_cli(*args):
    """The JAX package's task in this process (its CLI's runner): returns
    what ``run`` returns."""
    import argparse

    from speechclip_tpu.tasks.train_kwclip import TrainKWClip_GeneralTransformer as JaxTask

    runner = JaxTask()
    parser = argparse.ArgumentParser()
    parser.add_argument("task")
    runner.add_args(parser)
    runner.args = parser.parse_args([TASK, *args])
    return runner.run()


def test_test_split_of_a_reference_checkpoint_matches_jax(cli_setup, reference_ckpt):  # noqa: F811
    """``--test --ckpt <file>.ckpt``: the pickled config builds the run and
    the converted weights are validated on the test split; val_loss within
    1e-5 relative of JAX's CLI, the recalls equal."""
    import numpy as np

    _, exp = cli_setup
    got = run_task.main([TASK, "--test", "--ckpt", reference_ckpt, "--platform", "cpu",
                         "--save_path", str(exp / "port_ref_test"), "--devices", "1",
                         "--override", *COMPARABLE]).result
    want = run_jax_cli("--test", "--ckpt", reference_ckpt, "--devices", "1",
                       "--save_path", str(exp / "jax_ref_test"), "--override", *COMPARABLE)
    recalls = {k: v for k, v in want.items() if "recall" in k}
    assert len(recalls) == 11 and {k: got[k] for k in recalls} == recalls
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-5)


def test_train_warm_starts_from_a_reference_checkpoint_as_jax(cli_setup, reference_ckpt):  # noqa: F811
    """``--train --ckpt <file>.ckpt --config <yaml>``: the YAML merged over
    the pickled config, two steps from the converted weights with a fresh
    optimizer; each step's losses and both validations' val_loss within
    1e-5 relative of JAX's CLI, the lr and recalls equal, ``grad_norm``
    within 1e-4 relative (the synthetic checkpoint's weights are unit
    normals, not an init's scale, so the gradients' rounding is larger than
    in tests/torch_trainer_common.py's fits: 1.0e-5 here)."""
    import numpy as np

    from tests.torch_trainer_common import read_metrics

    cfg_path, exp = cli_setup
    common = ["--train", "--ckpt", reference_ckpt, "--config", str(cfg_path), "--devices", "1",
              "--override", "trainer.max_steps=2", *COMPARABLE]
    state = run_task.main([TASK, *common, "--platform", "cpu",
                           "--save_path", str(exp / "port_ref_train")]).result
    run_jax_cli(*common, "--save_path", str(exp / "jax_ref_train"))
    assert state.step == 2
    got, want = read_metrics(exp / "port_ref_train"), read_metrics(exp / "jax_ref_train")
    assert [r["step"] for r in got["train"]] == [r["step"] for r in want["train"]] == [1, 2]
    for g, w in zip(got["train"], want["train"]):
        for key in ("train_loss", "train_p_cl_loss", "train_c_cl_loss"):
            np.testing.assert_allclose(g[key], w[key], rtol=1e-5, err_msg=(g["step"], key))
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=1e-4)
        assert g["lr"] == w["lr"]
    assert len(got["val"]) == len(want["val"]) == 2
    for g, w in zip(got["val"], want["val"]):
        np.testing.assert_allclose(g["val_loss"], w["val_loss"], rtol=1e-5)
        recalls = {k: v for k, v in w.items() if "recall" in k}
        assert len(recalls) == 11 and {k: g[k] for k in recalls} == recalls


def test_more_than_one_card_raises():
    """``--devices 4`` on the card (the default platform) where fewer cards
    are found raises, naming the count found, before any work."""
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match=f"--devices 4: {found} CUDA device"):
        run_task.main([TASK, "--train", "--devices", "4", "--config", "unused.yaml"])


def test_the_trainable_switches_come_in_as_overrides(cli_setup):  # noqa: F811
    """``audio_encoder.trainable`` with ``unfreeze_layers`` and slim
    checkpoints, all from the command line: the run trains layer 1 of the
    encoder, its checkpoint holds that layer, and ``config.yaml`` keeps the
    switches."""
    import torch

    from speechclip_tpu_torch.config import load_config

    cfg_path, exp = cli_setup
    save = exp / "port_unfreeze"
    result = run_port_cli(TASK, "--config", str(cfg_path), "--train", "--platform", "cpu",
                          "--save_path", str(save), "--override", "data.dataset.image_size=32",
                          "trainer.max_steps=1", "audio_encoder.trainable=true",
                          "audio_encoder.unfreeze_layers=[1]", "trainer.checkpoint_frozen=false")
    assert result.returncode == 0, result.stderr[-3000:]
    assert "FORBIDDEN []" in result.stdout
    tree = load_config(str(save / "ckpts" / "config.yaml"))
    assert tree.audio_encoder.trainable and tree.audio_encoder.unfreeze_layers == [1]
    saved = torch.load(save / "ckpts" / "last" / "state.pt", weights_only=True)["params"]
    layers = saved["audio_encoder"]["encoder"]["layers"]
    assert layers[1]["fc1"]["w"] is not None and layers[0]["fc1"]["w"] is None
