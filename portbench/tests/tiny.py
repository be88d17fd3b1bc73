"""A tiny copy of the benchmark for the CPU tests: the same drivers, readers
and reference over a benchmark root of its own (``make_root``) whose cells
run a tiny SpeechCLIP parallel model (precision 32) on a tiny corpus."""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import shutil

from portbench.harness import ROOT, load_json

TRAIN, ENCODE = "train.tiny.flickr", "encode.tiny.b8"


def tiny_tree() -> dict:
    tree = copy.deepcopy(load_json(os.path.join(ROOT, "portbench", "configs",
                                                "speechclip_base_par.json"))["tree"])
    tree["data"]["batch_size"] = 8
    pb = tree["model_settings"]["parallel_branch"]["transformer_args"]
    pb.update(d_model=32, nhead=4, dim_feedforward=64)
    cb = tree["model_settings"]["cascaded_branch"]["transformer_args"]
    cb.update(d_model=32, dim_feedforward=64)
    tree["clip"].pop("reduce_subword_embbedding")
    tree["clip"]["custom"] = {
        "vision": {"image_size": 32, "patch_size": 8, "width": 32, "layers": 2, "heads": 4,
                   "output_dim": 16},
        "text": {"vocab_size": 64, "width": 32, "layers": 2, "heads": 4, "output_dim": 16}}
    ae = tree["audio_encoder"]
    ae["max_audio_len"] = 2000
    ae["custom"] = {"conv_layers": [[16, 10, 5], [16, 3, 2], [16, 3, 2]],
                    "encoder_embed_dim": 32, "encoder_layers": 2, "encoder_ffn_dim": 64,
                    "encoder_heads": 4, "downsample_rate": 20}
    ae["scheduler"].update(warmup=2, max_step=10)
    tree["trainer"]["precision"] = 32
    tree["trainer"]["logger"] = "none"
    return tree


def sizes_of(tree: dict) -> dict:
    """The ``sizes`` block of a configuration file, as the program resolves
    the tree."""
    from speechclip_tpu_torch.config import ConfigTree, model_config_from_tree

    cfg = model_config_from_tree(ConfigTree(tree))
    a = dataclasses.asdict(cfg.audio)
    a["conv_layers"] = [list(x) for x in a["conv_layers"]]
    keep = ("conv_layers", "extractor_mode", "conv_bias", "encoder_embed_dim", "encoder_layers",
            "encoder_ffn_dim", "encoder_heads", "layer_norm_first", "pos_conv_kernel",
            "pos_conv_groups", "normalize_waveform", "downsample_rate")
    b, v = dataclasses.asdict(cfg.parallel_branch), dataclasses.asdict(cfg.clip_vision)
    return {"audio": {k: a[k] for k in keep},
            "parallel_branch": {k: b[k] for k in ("n_layers", "d_model", "nhead",
                                                  "dim_feedforward", "layer_norm_eps")},
            "vision": {k: v[k] for k in ("image_size", "patch_size", "width", "layers", "heads",
                                         "output_dim")},
            "temperature_trainable": cfg.cl_loss.temperature_trainable}


TRAIN_LIMITS = {"rows_mismatch": {"limit": 0}, "loss_gap": {"limit": 1e-4},
                "grad1_gap": {"limit": 1e-3}, "grad1_median_gap": {"limit": 1e-3},
                "change_gap": {"limit": 1e-2}, "change_median_gap": {"limit": 1e-2},
                "window_loss_gap": {"limit": 1e-4}, "window_change_gap": {"limit": 1e-2}}
ENCODE_LIMITS = {"feature_gap": {"limit": 1e-5}, "topk_gap": {"limit": 1e-5}}


def make_root(path: str) -> str:
    """A benchmark root at ``path``: BENCHMARK.json with the two tiny cells,
    their configuration, traffic and limits files, and the real metric
    readers."""
    real = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    pb = os.path.join(path, "portbench")
    for sub in ("configs", "traffic", "limits"):
        os.makedirs(os.path.join(pb, sub), exist_ok=True)
    shutil.copytree(os.path.join(ROOT, "portbench", "metrics"), os.path.join(pb, "metrics"),
                    dirs_exist_ok=True)
    tree = tiny_tree()
    config = {"name": "tiny", "sizes": sizes_of(tree), "tree": tree}
    flickr = load_json(os.path.join(ROOT, "portbench", "traffic", "flickr.json"))
    flickr["corpus"].update(images={"train": 6, "dev": 2}, seconds=[0.05, 0.2], image_side=32)
    flickr["window_check_steps"] = 1  # the window's first step: it always runs
    encode = load_json(os.path.join(ROOT, "portbench", "traffic", "6s_b256.json"))
    encode.update(batch=8, bucket_samples=3200, seconds=[0.05, 0.2], pool_batches=2,
                  gallery=50, top_k=5, reference_rows=4)
    files = {"configs/tiny.json": config, "traffic/tiny_flickr.json": flickr,
             "traffic/tiny_b8.json": encode, f"limits/{TRAIN}.json": TRAIN_LIMITS,
             f"limits/{ENCODE}.json": ENCODE_LIMITS}
    for rel, obj in files.items():
        with open(os.path.join(pb, rel), "w") as f:
            json.dump(obj, f)
    bench = dict(real)
    bench["configs"] = [{"name": "tiny", "source": "tests", "file": "portbench/configs/tiny.json",
                         "reduced": [], "why": "tiny"}]
    bench["workloads"] = [
        {"name": TRAIN, "config": "tiny", "traffic": "tiny_flickr", "chips": 1, "why": "tiny"},
        {"name": ENCODE, "config": "tiny", "traffic": "tiny_b8", "chips": 1, "why": "tiny"}]
    rename = {"train.large_par.flickr": TRAIN, "encode.base_par.6s_b256": ENCODE}
    for group in ("end_to_end", "per_layer"):
        for m in bench[group]:
            if "workloads" in m:
                m["workloads"] = [rename[w] for w in m["workloads"] if rename.get(w)]
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return path
