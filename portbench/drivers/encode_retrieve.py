"""Driver ``encode_retrieve``: offline encode + retrieve, the eval's and an
archive indexer's path. Each call copies one batch of int16 PCM from
pinned host memory to the card, runs the program's
``SpeechCLIPModel.encode_speech`` (bf16, the parallel branch) and
``ops.retrieval.retrieve`` (f32 scores against the gallery, top-k). A fixed
pool of seeded batches is cycled; no loader and no backward run.

Set-up: the weights and inputs from the seed, then ``warmup_calls`` calls
of the one shape. The window runs calls back to back until ``seconds``
have passed at the start of one (that call is not made), then
synchronises; the rate is the utterances of the window's calls over the
time to that synchronise. Afterwards ``checked_calls`` of the window's
calls, drawn from the seed with the last one among them, are held to the
plain reference.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from .. import flops
from ..compare import encode_numbers
from ..reference.speechclip_par import (
    Precision,
    branch,
    f32_math,
    feature_lens,
    hubert_stack,
    l2n,
    weighted_sum,
)
from ..reference.train_ref import to_f32
from ..trace import WindowProfiler, summarize
from ..weights import make_params
from .trainer_fit import valid_keys


def make_pool(tf: Dict, seed: int, device) -> List:
    """``pool_batches`` batches of (int16 PCM (B, L) pinned, lengths (B,)):
    the lengths are one fixed set (``layout_seed``) that ``seed`` deals out
    in another order; the samples are drawn from ``seed`` on the device."""
    b, n, samples = int(tf["batch"]), int(tf["pool_batches"]), int(tf["bucket_samples"])
    lo, hi = tf["seconds"]
    sr = int(tf["sample_rate"])
    fixed = np.random.default_rng(int(tf["layout_seed"])).uniform(lo, hi, n * b)
    lens = np.minimum(np.rint(np.random.default_rng(int(seed)).permutation(fixed) * sr),
                      samples).astype(np.int32).reshape(n, b)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    pool = []
    for k in range(n):
        pcm = torch.randn((b, samples), generator=gen, device=device) * float(tf["pcm_std"])
        valid = torch.arange(samples, device=device)[None, :] < torch.from_numpy(lens[k]).to(device)[:, None]
        pcm = torch.where(valid, pcm.round().clamp(-32768, 32767), 0.0).to(torch.int16)
        host = pcm.cpu()
        lens_t = torch.from_numpy(lens[k])
        if torch.device(device).type == "cuda":
            host, lens_t = host.pin_memory(), lens_t.pin_memory()
        pool.append((host, lens_t))
    return pool


def make_gallery(tf: Dict, seed: int, dim: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(int(seed) + 2)
    g = torch.randn((int(tf["gallery"]), dim), generator=gen, device=device)
    return g / torch.linalg.vector_norm(g, dim=-1, keepdim=True)


def reference_features(config: Dict, seed: int, batches: List, device, rows: int,
                       precision=None) -> List[torch.Tensor]:
    """The plain reference's L2-normalized features of each (int16 PCM,
    lengths) batch, at eval (no dropout)."""
    P = precision or Precision()
    sizes = config["sizes"]
    a, br = sizes["audio"], sizes["parallel_branch"]
    s3prl = bool(config["tree"]["audio_encoder"].get("normalize_hiddenstates", False))
    out = []
    with f32_math(), torch.no_grad():
        params = to_f32(make_params(sizes, seed, device))
        for wav16, lens in batches:
            wav = wav16.to(device).float() / 32768.0
            lens = lens.to(device)
            stack = hubert_stack(P, params["audio_encoder"], a, wav, lens, rows, s3prl)
            feat = weighted_sum(stack, params["weighted_sum"]["weights"])
            frames = stack.shape[2]
            del stack
            out.append(l2n(branch(P, params["parallel_branch"], br, feat,
                                  feature_lens(lens, a["downsample_rate"], frames))))
    return out


def run(cell, seed: int, seconds: float, trace: bool, device, cache_dir: str, t_start: float,
        fault=None) -> Dict:
    from torch.profiler import record_function

    from speechclip_tpu_torch.config import ConfigTree, model_config_from_tree
    from speechclip_tpu_torch.models.speechclip import SpeechCLIPModel, cast_params
    from speechclip_tpu_torch.ops.retrieval import retrieve

    tf, config = cell["traffic"], cell["config"]
    sizes = config["sizes"]
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    model = SpeechCLIPModel(model_config_from_tree(ConfigTree(config["tree"])), device=device)
    params = cast_params(make_params(sizes, seed, device), model.compute_dtype, device)
    pool = make_pool(tf, seed, device)
    gallery = make_gallery(tf, seed, sizes["vision"]["output_dim"], device)
    k = int(tf["top_k"])

    def call(i):
        wav, lens = pool[i % len(pool)]
        with record_function("portbench.encode"):
            out = model.encode_speech(params, {}, wav.to(device, non_blocking=True),
                                      lens.to(device, non_blocking=True))
        with record_function("portbench.retrieve"):
            _scores, idx = retrieve(out["parallel_audio_feat"], gallery, k)
        feats = out["parallel_audio_feat"]
        if fault is not None:
            feats, idx = fault.encode(feats, idx)
        return feats, idx

    for i in range(int(tf["warmup_calls"])):
        call(i)
    if on_card:
        torch.cuda.synchronize()
    profiler = WindowProfiler() if trace else None
    t0 = time.perf_counter()
    if profiler is not None:
        profiler.start()
    outputs = []
    while time.perf_counter() - t0 < seconds:
        outputs.append(call(len(outputs)))
    if on_card:
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    if profiler is not None:
        profiler.stop()
    window_s = t_end - t0
    n_calls, b = len(outputs), int(tf["batch"])
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    lengths = [(int(tf["bucket_samples"]), pool[i % len(pool)][1].numpy()) for i in range(n_calls)]
    trace_summary = None
    if profiler is not None:
        trace_summary = summarize(profiler.events(), profiler.start_ns, profiler.stop_ns,
                                  valid_keys(lengths, sizes["audio"]["conv_layers"]))
    rng = np.random.default_rng(int(seed))
    picks = sorted({n_calls - 1, *rng.choice(n_calls, min(n_calls, int(tf["checked_calls"])) - 1,
                                             replace=False).tolist()})
    checked = [(outputs[i][0].float(), outputs[i][1]) for i in picks]
    del outputs, params, model
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    refs = reference_features(config, seed, [pool[i % len(pool)] for i in picks], device,
                              int(tf["reference_rows"]))
    numbers = {}
    with f32_math():
        for (feats, idx), ref in zip(checked, refs):
            got = encode_numbers(feats, idx, ref, ref @ gallery.T)
            for name, rec in got.items():
                if name not in numbers or rec["value"] > numbers[name]["value"]:
                    numbers[name] = rec
    return {"e2e": {"encode_utt_per_s": n_calls * b / window_s, "setup_s": t0 - t_start},
            "attempted": n_calls * b, "failed": 0, "memory_peak_bytes": int(peak),
            "numbers": numbers,
            "ctx": {"kind": "encode", "window_s": window_s, "steps": n_calls,
                    "model_flops": n_calls * flops.encode_flops(
                        sizes, b, int(tf["bucket_samples"]), int(tf["gallery"])),
                    "trace": trace_summary}}
