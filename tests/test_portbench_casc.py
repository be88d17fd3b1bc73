"""The benchmark's cascaded train cell (``portbench/drivers/trainer_fit_casc.py``)
at a tiny size on the CPU: the program's ``Trainer.fit`` of a tiny
cascaded model (precision 32) held to the plain reference
(``portbench/reference/train_ref_casc.py``), sound and with faults planted
under the timed path; the keyword-choice numbers on cases made by hand;
the float8 control; the seeded weights against the program's tree; the
model FLOPs against a count by hand."""

import copy
import dataclasses
import json
import math
import os
import shutil

import pytest
import torch

from portbench import flops, flops_casc, harness
from portbench.compare_casc import bn_state_gap, casc_numbers, keyword_numbers
from portbench.harness import ROOT, load_json
from portbench.reference import train_ref_casc
from portbench.reference.speechclip_par import Precision
from portbench.weights_casc import make_params, model_state

torch.set_num_threads(2)

CELL = "train.tiny_casc.flickr"
LIMITS = {"rows_mismatch": {"limit": 0}, "loss_gap": {"limit": 1e-4},
          "grad1_gap": {"limit": 1e-3}, "change_gap": {"limit": 1e-2},
          "window_loss_gap": {"limit": 1e-4}, "window_change_gap": {"limit": 1e-2},
          "kw_score_gap": {"limit": 1e-4}, "kw_id_mismatch": {"limit": 0.0},
          "kw_tie_margin": {"limit": 1e-3}, "bn_state_gap": {"limit": 1e-3}}


def tiny_tree(reduced: bool = False) -> dict:
    """The shipped large cascaded tree at tiny widths (precision 32, the
    large model's HuBERT switches); ``reduced``: CLIP's full vocabulary
    and the shipped reduced table, at a tiny width."""
    tree = copy.deepcopy(load_json(os.path.join(
        ROOT, "portbench", "configs", "speechclip_large_casc.json"))["tree"])
    tree["data"]["batch_size"] = 8
    for branch in ("parallel_branch", "cascaded_branch"):
        tree["model_settings"][branch]["transformer_args"].update(d_model=32, dim_feedforward=64)
    tree["model_settings"]["parallel_branch"]["transformer_args"]["nhead"] = 4
    if not reduced:
        tree["clip"].pop("reduce_subword_embbedding")
    tree["clip"]["custom"] = {
        "vision": {"image_size": 32, "patch_size": 8, "width": 32, "layers": 2, "heads": 4,
                   "output_dim": 16},
        "text": {"vocab_size": 49408 if reduced else 64, "width": 24, "layers": 2, "heads": 4,
                 "output_dim": 16}}
    ae = tree["audio_encoder"]
    ae["max_audio_len"] = 2000
    ae["custom"] = {"conv_layers": [[16, 10, 5], [16, 3, 2], [16, 3, 2]],
                    "extractor_mode": "layer_norm", "conv_bias": True, "layer_norm_first": True,
                    "normalize_waveform": True, "encoder_embed_dim": 32, "encoder_layers": 2,
                    "encoder_ffn_dim": 64, "encoder_heads": 4, "downsample_rate": 20}
    ae["scheduler"].update(warmup=2, max_step=10)
    tree["trainer"]["precision"] = 32
    tree["trainer"]["logger"] = "none"
    return tree


def sizes_of(tree: dict) -> dict:
    """The ``sizes`` block of a cascaded configuration file, as the
    program resolves the tree."""
    from speechclip_tpu_torch.config import ConfigTree, model_config_from_tree

    cfg = model_config_from_tree(ConfigTree(tree))
    a = dataclasses.asdict(cfg.audio)
    a["conv_layers"] = [list(x) for x in a["conv_layers"]]
    keep = ("conv_layers", "extractor_mode", "conv_bias", "encoder_embed_dim", "encoder_layers",
            "encoder_ffn_dim", "encoder_heads", "layer_norm_first", "pos_conv_kernel",
            "pos_conv_groups", "normalize_waveform", "downsample_rate")
    c, v = cfg.cascaded_branch, dataclasses.asdict(cfg.clip_vision)
    text = dataclasses.asdict(cfg.clip_text)
    text.update(reduced_vocab=cfg.reduce_subword_embedding,
                reduced_rows=8112 if cfg.reduce_subword_embedding else None)
    return {"audio": {k: a[k] for k in keep},
            "cascaded_branch": {
                "transformer_type": c.transformer_type, "d_model": c.d_model, "nhead": c.nhead,
                "keyword_number": c.keyword_number, "dropout": c.dropout,
                "layer_norm_eps": c.layer_norm_eps, "batchnorm_type": c.batchnorm_type,
                "bn_parallel": c.bn_parallel, "bn_std_scale": c.bn_std_scale,
                "vq_temp": float(c.vq_temp.split("=")[1]), "vq_hard": c.hard,
                "prob_mask": [0, 2, 3]},
            "text": text,
            "vision": {k: v[k] for k in ("image_size", "patch_size", "width", "layers", "heads",
                                         "output_dim")},
            "temperature_trainable": cfg.cl_loss.temperature_trainable}


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A benchmark root with the one tiny cascaded cell."""
    path = str(tmp_path_factory.mktemp("bench"))
    pb = os.path.join(path, "portbench")
    for sub in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(pb, sub))
    shutil.copytree(os.path.join(ROOT, "portbench", "metrics"), os.path.join(pb, "metrics"))
    tree = tiny_tree()
    traffic = load_json(os.path.join(ROOT, "portbench", "traffic", "flickr_casc.json"))
    traffic["corpus"].update(images={"train": 6, "dev": 2}, seconds=[0.05, 0.2], image_side=32)
    traffic["window_check_steps"] = 1  # the window's first step: it always runs
    files = {"configs/tiny_casc.json": {"name": "tiny_casc", "sizes": sizes_of(tree),
                                        "tree": tree},
             "traffic/tiny_flickr_casc.json": traffic, f"limits/{CELL}.json": LIMITS}
    for rel, obj in files.items():
        with open(os.path.join(pb, rel), "w") as f:
            json.dump(obj, f)
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    bench["configs"] = [{"name": "tiny_casc", "source": "tests",
                         "file": "portbench/configs/tiny_casc.json", "reduced": [], "why": "tiny"}]
    bench["workloads"] = [{"name": CELL, "config": "tiny_casc", "traffic": "tiny_flickr_casc",
                           "chips": 1, "why": "tiny"}]
    for group in ("end_to_end", "per_layer"):
        for m in bench[group]:
            if "workloads" in m:
                m["workloads"] = [CELL] if "train.large_casc.flickr" in m["workloads"] else []
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return path


@pytest.fixture(scope="module")
def cache_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("cache"))


def run(root, cache_dir, fault=None, seed=2 ** 31 + 11):
    return harness.run_cell(CELL, seed, 1.0, False, device="cpu", cache_dir=cache_dir,
                            root=root, fault=fault)


@pytest.fixture(scope="module")
def sound(tiny_root, cache_dir):
    return run(tiny_root, cache_dir)


class StateUnchanged:
    """The train step runs, but kw-BN's running statistics keep their
    values."""

    def step(self, step_fn, state, batch, trainer):
        new, metrics = step_fn(state, batch)
        return dataclasses.replace(new, model_state=state.model_state), metrics


def far_id(vq_apply):
    """``vq_apply`` with row (0, 0)'s choice moved to its lowest-scored
    subword: the forward takes that subword, the gradient is the soft
    choice's."""

    def wrong(params, x, **kwargs):
        res = vq_apply(params, x, **kwargs)
        prob = res["subword_prob"]
        hard = (prob.detach() == prob.detach().amax(-1, keepdim=True)).float()
        hard[0, 0] = 0.0
        hard[0, 0, x[0, 0].argmin()] = 1.0
        res["subword_prob"] = prob - prob.detach() + hard
        res["targets"] = hard.argmax(-1)[..., None]
        return res

    return wrong


def test_sound_run_is_correct_with_the_same_ids(sound):
    """The program's steps against the reference: the same ids, and the
    loss, gradients, leaves and kw-BN state within the tiny limits."""
    numbers = sound["notes"]["numbers"]
    assert sound["line"]["correct"], sound["checks"]
    assert numbers["kw_id_mismatch"]["value"] == 0.0
    assert numbers["kw_tie_margin"]["value"] == 0.0
    assert 0.0 < numbers["bn_state_gap"]["value"] < 1e-3
    assert sound["notes"]["ctx"]["checked_step"] is not None
    assert sound["line"]["attempted"] > 0 and sound["notes"]["ctx"]["model_flops"] > 0


def test_far_id_fails_the_tie_margin(tiny_root, cache_dir, monkeypatch):
    from speechclip_tpu_torch.models import branches

    monkeypatch.setattr(branches, "vq_apply", far_id(branches.vq_apply))
    out = run(tiny_root, cache_dir)
    assert not out["line"]["correct"]
    assert not out["checks"]["kw_tie_margin"]["ok"]
    # teacher-forced on the program's ids, the loss and gradients still agree
    for name in ("loss_gap", "grad1_gap", "change_gap", "window_loss_gap"):
        assert out["checks"][name]["ok"], (name, out["checks"][name])


def test_state_unchanged_fails_the_bn_state_gap(tiny_root, cache_dir):
    out = run(tiny_root, cache_dir, StateUnchanged())
    assert not out["line"]["correct"]
    assert out["checks"]["bn_state_gap"]["value"] == pytest.approx(1.0)


def test_keyword_numbers_by_hand():
    """A near-tie flipped reads its margin; a far id its distance; the
    score gap is the relative L2 gap."""
    ref = torch.tensor([[[0.5, 0.5 - 1e-6, -0.9, 0.1]]], dtype=torch.float64)
    near = keyword_numbers([ref], [torch.tensor([[1]])], [ref], [torch.tensor([[0]])])
    assert near["kw_id_mismatch"]["value"] == 1.0
    assert near["kw_tie_margin"]["value"] == pytest.approx(1e-6, rel=1e-3)
    assert near["kw_tie_margin"]["value"] <= LIMITS["kw_tie_margin"]["limit"]
    far = keyword_numbers([ref], [torch.tensor([[2]])], [ref], [torch.tensor([[0]])])
    assert far["kw_tie_margin"]["value"] == pytest.approx(1.4)
    same = keyword_numbers([ref * 1.01], [torch.tensor([[0]])], [ref], [torch.tensor([[0]])])
    assert same["kw_score_gap"]["value"] == pytest.approx(0.01)
    assert same["kw_id_mismatch"]["value"] == same["kw_tie_margin"]["value"] == 0.0
    gap = bn_state_gap({"mean": torch.zeros(3), "var": torch.tensor([1.0, 1.0, 2.0])},
                       {"mean": torch.ones(3), "var": torch.tensor([1.0, 1.0, 1.0])})
    assert gap["bn_state_gap"]["value"] == pytest.approx(1.0)


def test_float8_control_fails(sound, tiny_root, cache_dir):
    """The reference in float8 in the program's place (its own ids) against
    the float32 reference teacher-forced on them: at least one limit fails."""
    from portbench import corpus as corpus_mod

    spec = harness.cell_spec(CELL, tiny_root)
    root = corpus_mod.ensure_corpus(os.path.join(cache_dir, "corpus"), spec["traffic"]["corpus"])
    seed = 2 ** 31 + 11
    config = spec["config"]
    low = train_ref_casc.run_reference(config, root, seed, 3, "cpu", Precision(fp8=True))
    ref = train_ref_casc.run_reference(config, root, seed, 3, "cpu", ids=low["own"])
    prog = {"losses": low["losses"], "first_grads": low["first_grads"],
            "params_after": {k: low["initial"][k] + low["change"][k] for k in low["change"]},
            "batches": low["batches"], "scores": low["scores"], "ids": low["own"],
            "bn_change": low["bn_change"]}
    numbers = casc_numbers(prog, ref)
    failed = [n for n, lim in LIMITS.items() if n in numbers and numbers[n]["value"] > lim["limit"]]
    assert failed, numbers


@pytest.mark.parametrize("reduced", [False, True], ids=["full_vocab", "reduced_vocab"])
def test_weights_are_the_programs_tree(reduced):
    """Leaf paths, shapes and the model state as ``SpeechCLIPModel.init``
    makes them (the table cut to the shipped 8112 rows where reduced)."""
    from speechclip_tpu_torch.config import ConfigTree, model_config_from_tree
    from speechclip_tpu_torch.models.speechclip import SpeechCLIPModel
    from portbench.reference.train_ref import leaves

    tree = tiny_tree(reduced)
    sizes = sizes_of(tree)
    model = SpeechCLIPModel(model_config_from_tree(ConfigTree(tree)), device="cpu")
    want, want_state = model.init(0)
    got = make_params(sizes, 5, "cpu")
    shapes = lambda t: {p: tuple(x.shape) for p, x in leaves(t)}
    assert shapes(got) == shapes(want)
    assert shapes(model_state(sizes, "cpu")) == shapes(want_state)
    table = got["clip"]["text"]["token_embedding"].float()
    assert table.shape[0] == (8112 if reduced else 64)
    k = sizes["cascaded_branch"]["keyword_number"]
    torch.testing.assert_close(got["cascaded_branch"]["bn"]["scale"], table.std(0).repeat(k))
    assert train_ref_casc.special_ids(sizes["text"]) == (model.sot_id, model.eot_id)
    mask = model.trainable_mask(want)
    trains = {p[0] for p, m in leaves(mask) if m}
    assert trains == set(train_ref_casc.TRAINABLE_ROOTS)


def test_shipped_sizes_are_the_programs_reading_of_the_tree():
    config = load_json(os.path.join(ROOT, "portbench", "configs", "speechclip_large_casc.json"))
    assert config["sizes"] == sizes_of(config["tree"])
    assert config["reduced"] == []


def test_flops_by_hand():
    """One step at B = 2, 3200 samples, on the shipped widths: each term
    counted by hand."""
    sizes = load_json(os.path.join(ROOT, "portbench", "configs",
                                   "speechclip_large_casc.json"))["sizes"]
    b, samples = 2, 3200
    t = flops.conv_out_len(samples, sizes["audio"]["conv_layers"])[-1]
    assert t == 9
    d, k, w, v, e = 1024, 8, 768, 8112, 768
    head = 2 * b * (k + t) * 4 * d * d + 4 * b * (k + t) ** 2 * d + 2 * b * k * d * w
    choice = 2 * 2 * b * k * w * v
    text = 12 * (2 * b * (k + 2) * (4 * w * w + 2 * w * 4 * w) + 4 * b * (k + 2) ** 2 * w) \
        + 2 * b * w * e
    want = (flops.hubert_flops(sizes["audio"], b, samples) + 3 * head + 2 * choice + 2 * text
            + 3 * 2 * b * b * e)
    assert flops_casc.train_step_flops(sizes, b, samples) == pytest.approx(want, rel=1e-12)
    assert math.isclose(flops_casc.head_flops(sizes["cascaded_branch"], w, b, t), head)
