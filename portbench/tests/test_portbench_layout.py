"""The harness finds every configuration, traffic, limits and metric file
by the names in BENCHMARK.json, and the files say what the program runs."""

import json
import os
import re

import pytest

from portbench import harness
from portbench.tests import tiny
from portbench.weights import make_params

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("work", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(work):
    spec = harness.cell_spec(work["name"])
    assert spec["config"]["tree"] and spec["config"]["sizes"]
    assert spec["traffic"]["driver"] in ("trainer_fit", "encode_retrieve")
    assert spec["limits"]
    assert {"setup_s"} < {m["name"] for m in spec["end_to_end"]}
    assert spec["per_layer"]
    for m in spec["per_layer"]:
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}
        assert harness.metric_reader(m["name"])({"kind": None}) is None


def test_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [x["name"] for g in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[g]]
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in BENCH[group]}) == len(BENCH[group])
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
        assert c["file"].startswith("portbench/") and len(c["why"]) <= 200
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) < 64 * 1024


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_sizes_are_the_programs(name):
    """The yardstick's and the reference's sizes are what the program
    resolves from the configuration's tree, which is the shipped YAML."""
    from speechclip_tpu_torch.config import load_config

    cfg = harness.load_json(os.path.join(harness.ROOT, f"portbench/configs/{name}.json"))
    assert tiny.sizes_of(cfg["tree"]) == cfg["sizes"]
    shipped = load_config(os.path.join(harness.ROOT, cfg["program_config"])).to_dict()
    assert json.loads(json.dumps(shipped)) == cfg["tree"]


def test_weights_have_the_programs_layout():
    """``make_params`` gives the program's parameter tree (the text tower,
    which the parallel model does not read, aside): same paths, shapes and
    the dtype the train state keeps."""
    import torch

    from speechclip_tpu_torch.config import ConfigTree, model_config_from_tree
    from speechclip_tpu_torch.models.speechclip import SpeechCLIPModel

    tree = tiny.tiny_tree()
    model = SpeechCLIPModel(model_config_from_tree(ConfigTree(tree)), device="cpu")
    want, _ = model.init(0)
    want["clip"].pop("text")
    got = make_params(tiny.sizes_of(tree), 0, "cpu")

    def shapes(t, p=()):
        if isinstance(t, dict):
            return {k: v for key in t for k, v in shapes(t[key], p + (key,)).items()}
        if isinstance(t, list):
            return {k: v for i, x in enumerate(t) for k, v in shapes(x, p + (i,)).items()}
        return {p: None if t is None else tuple(t.shape)}

    assert shapes(got) == shapes(want)
    mask = model.trainable_mask(got)
    for (path, t), (_p, m) in zip(_leaves(got), _leaves(mask)):
        frozen_matrix = not m and t.dim() >= 2
        assert t.dtype == (torch.bfloat16 if frozen_matrix else torch.float32), path


def _leaves(t, p=()):
    if isinstance(t, dict):
        for k, v in t.items():
            yield from _leaves(v, p + (k,))
    elif isinstance(t, list):
        for i, v in enumerate(t):
            yield from _leaves(v, p + (i,))
    elif t is not None:
        yield p, t


def test_weights_repeat_from_the_seed():
    sizes = tiny.sizes_of(tiny.tiny_tree())
    a, b, c = (make_params(sizes, s, "cpu") for s in (5, 5, 6))
    wa, wb, wc = (x["parallel_branch"]["proj"]["w"] for x in (a, b, c))
    assert (wa == wb).all() and not (wa == wc).all()
