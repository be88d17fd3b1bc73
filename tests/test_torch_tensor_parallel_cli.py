"""``python -m speechclip_tpu_torch.run_task ... --devices 4 --platform cpu``
with ``trainer.model_parallel=2``: four gloo ranks spawned on the CPU as
``(data 2, model 2)``, in a subprocess that never imports jax,
warm-started from a synthetic reference Lightning ``.ckpt`` on
``tests/test_cli.py``'s corpus, against the JAX package's CLI with
``--devices 4`` at the same setting (``make_mesh(data=2, model=2)`` on
four virtual CPU devices), with tests/test_torch_data_parallel_cli.py's
limits; a device count the model axis does not divide raises before any
rank starts."""

import numpy as np
import pytest

from speechclip_tpu_torch import run_task
from tests.test_cli import cli_setup  # noqa: F401 (fixture)
from tests.test_torch_cli import (  # noqa: F401 (reference_ckpt: a fixture)
    COMPARABLE,
    TASK,
    reference_ckpt,
    run_jax_cli,
    run_port_cli,
)
from tests.torch_trainer_common import read_metrics

TP = "trainer.model_parallel=2"


def test_devices_4_at_model_parallel_2_matches_jax(cli_setup, reference_ckpt):  # noqa: F811
    cfg_path, exp = cli_setup
    common = ["--train", "--ckpt", reference_ckpt, "--config", str(cfg_path), "--devices", "4",
              "--override", "trainer.max_steps=2", TP, *COMPARABLE]
    result = run_port_cli(TASK, *common, "--platform", "cpu",
                          "--save_path", str(exp / "port_tp_train"))
    assert result.returncode == 0, result.stderr[-3000:]
    assert "FORBIDDEN []" in result.stdout
    run_jax_cli(*common, "--save_path", str(exp / "jax_tp_train"))
    got, want = read_metrics(exp / "port_tp_train"), read_metrics(exp / "jax_tp_train")
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
    assert (exp / "port_tp_train" / "ckpts" / "last" / "state.pt").exists()


def test_a_device_count_the_model_axis_does_not_divide_raises(cli_setup):  # noqa: F811
    cfg_path, _ = cli_setup
    with pytest.raises(ValueError, match="--devices 3 does not split into model groups of "
                                         "trainer.model_parallel=2"):
        run_task.main([TASK, "--train", "--devices", "3", "--platform", "cpu", "--config",
                       str(cfg_path), "--override", TP])
