"""A traced run of each tiny cell on the CPU: the per-layer metrics that read
the program's spans and counters (``portbench/spans.py``) find them. The
host-read ones read a positive number; the device shares read None, since
the CPU has no CUDA events, never 0."""

import pytest

from portbench import harness
from portbench.tests import tiny

HOST = {tiny.TRAIN: ["step_host_ms.train", "h2d_gbps.train"], tiny.ENCODE: []}
DEVICE = {tiny.TRAIN: ["frontend_device_pct.train", "pos_conv_device_pct.train",
                       "layers_device_pct.train", "wsum_device_pct.train",
                       "backward_device_pct.train"],
          tiny.ENCODE: ["frontend_device_pct.encode", "pos_conv_device_pct.encode",
                        "layers_device_pct.encode"]}


@pytest.fixture(scope="module")
def traced(tiny_root, cache_dir):
    """cell -> (its traced run's result line, the context its readers see);
    each cell's metrics are read right after its own run, as the harness
    reads them."""
    out = {}
    for name in (tiny.TRAIN, tiny.ENCODE):
        res = harness.run_cell(name, 2147483659, 3.0, True, device="cpu", cache_dir=cache_dir,
                               root=tiny_root)
        ctx = dict(res["notes"]["ctx"], trace={"window_s": 1.0})
        out[name] = (res["line"], {m: harness.metric_reader(m, tiny_root)(ctx)
                                   for m in HOST[name] + DEVICE[name]})
    return out


@pytest.mark.parametrize("cell,metric", [(c, m) for c in HOST for m in HOST[c]])
def test_host_read_metrics_read_a_positive_number(traced, cell, metric):
    line, read = traced[cell]
    assert read[metric] is not None and read[metric] > 0
    assert line["metrics"][metric]["value"] == pytest.approx(read[metric])


@pytest.mark.parametrize("cell,metric", [(c, m) for c in DEVICE for m in DEVICE[c]])
def test_device_shares_read_none_on_the_cpu(traced, cell, metric):
    line, read = traced[cell]
    assert read[metric] is None
    assert metric not in line["metrics"]
