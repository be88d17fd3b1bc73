"""The control (the reference on float8 operands in the program's place)
and the planted faults read far above a sound run at a size a test run can
hold: the tiny cells, float32 program, CPU."""

import pytest

from portbench import control, harness
from portbench.tests import tiny


@pytest.mark.parametrize("seed", [3, 4])
def test_train_control_and_half_batch(tiny_root, cache_dir, seed):
    spec = harness.cell_spec(tiny.TRAIN, tiny_root)
    got = control.train_readings(spec, seed, "cpu", cache_dir, seconds=1.0)
    limits = spec["limits"]
    assert all(got["program"][k] <= lim["limit"] for k, lim in limits.items()), got["program"]
    for name in ("control_fp8", "half_batch"):
        assert any(got[name][k] > limits[k]["limit"] for k in ("loss_gap", "grad1_gap")), got
        assert got[name]["window_loss_gap"] > limits["window_loss_gap"]["limit"], got
    assert got["control_fp8"]["rows_mismatch"] == 0


@pytest.mark.parametrize("seed", [3, 4])
def test_encode_control_and_answer(tiny_root, seed):
    spec = harness.cell_spec(tiny.ENCODE, tiny_root)
    got = control.encode_readings(spec, seed, "cpu")
    assert got["control_fp8"]["feature_gap"] > spec["limits"]["feature_gap"]["limit"]
    assert got["answer_altered"]["topk_gap"] > spec["limits"]["topk_gap"]["limit"]


@pytest.mark.gpu
def test_encode_cell_on_the_card():
    """One short run of the encode cell on the card: correct, and its
    result line has the contract's keys (skipped without a card)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = harness.run_cell("encode.base_par.6s_b256", 2**31 + 3, 2.0, False)
    assert out["line"]["correct"], out["checks"]
    assert set(out["line"]) >= {"correct", "attempted", "failed", "metrics", "device"}
