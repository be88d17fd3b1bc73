"""The port's CLI, ``python -m speechclip_tpu_torch.run_task``, end to end
on ``tests/test_cli.py``'s synthetic corpus and config, in subprocesses that
never import jax: ``--train --platform cpu``, then ``--test --ckpt`` on the
test split and ``--eval --resume`` on the dev split; the task-first usage
error; a reference ``.ckpt`` raises naming its converter."""

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


@pytest.mark.parametrize("flag", ["--ckpt", "--resume"])
def test_a_reference_lightning_checkpoint_raises(flag, tmp_path):
    with pytest.raises(NotImplementedError, match="convert/reference_ckpt.py"):
        run_task.main([TASK, "--test", flag, str(tmp_path / "model.ckpt"), "--platform", "cpu"])


def test_more_than_one_card_raises():
    with pytest.raises(NotImplementedError, match="DDP"):
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
