"""``python -m speechclip_tpu_torch.run_task ... --devices 2 --platform cpu``:
two gloo ranks spawned on the CPU, in a subprocess that never imports jax,
warm-started from a synthetic reference Lightning ``.ckpt`` on
``tests/test_cli.py``'s corpus, against the JAX package's CLI with
``--devices 2`` (two virtual CPU devices) in this process, with
tests/test_torch_cli.py's limits for that route."""

import numpy as np
import pytest
import torch

from speechclip_tpu_torch import run_task
from tests.test_cli import cli_setup  # noqa: F401 (fixture)
from tests.test_torch_cli import COMPARABLE, TASK, reference_ckpt, run_jax_cli, run_port_cli  # noqa: F401
from tests.torch_trainer_common import read_metrics


def test_devices_2_on_the_cpu_matches_jax_on_two_devices(cli_setup, reference_ckpt):  # noqa: F811
    cfg_path, exp = cli_setup
    common = ["--train", "--ckpt", reference_ckpt, "--config", str(cfg_path), "--devices", "2",
              "--override", "trainer.max_steps=2", *COMPARABLE]
    result = run_port_cli(TASK, *common, "--platform", "cpu",
                          "--save_path", str(exp / "port_dp_train"))
    assert result.returncode == 0, result.stderr[-3000:]
    assert "FORBIDDEN []" in result.stdout
    run_jax_cli(*common, "--save_path", str(exp / "jax_dp_train"))
    got, want = read_metrics(exp / "port_dp_train"), read_metrics(exp / "jax_dp_train")
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
    assert (exp / "port_dp_train" / "ckpts" / "last" / "state.pt").exists()


def test_more_devices_than_cards_raises():
    """``--devices N`` on the card (the default platform) with fewer than N
    cards found (here: 2 where there is none) raises before any work,
    naming the count found."""
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = max(2, found + 1)
    with pytest.raises(RuntimeError, match=f"--devices {n}: {found} CUDA device"):
        run_task.main([TASK, "--train", "--devices", str(n), "--config", "unused.yaml"])
