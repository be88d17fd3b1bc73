"""Driver ``trainer_fit_casc``: ``trainer_fit``'s run for a cascaded model.
The program's ``Trainer.fit`` runs as a user runs it, on the same seeded
corpus, with the window, set-up and rate of ``trainer_fit`` (its
``Window``, trainer subclass and trace keys); the weights come from
``weights_casc``, with kw-BN's running statistics as the model state.

The first ``record_steps`` steps and one window step are held to the plain
reference (``reference/train_ref_casc.py``) as ``trainer_fit`` holds its
steps, and besides: the keyword choice of each of those steps, captured on
the device as the program makes it (the cosine scores that enter
``vq_apply`` and the ids it picks; references kept, nothing copied or
synchronised in the window, read after it closes), and kw-BN's running
statistics after the first steps. The reference works out its own scores
and argmax, then goes on from the program's ids (teacher forcing), so that
a near-tie the two round differently does not break the loss and gradient
numbers (``compare_casc.py``).
"""

from __future__ import annotations

import gc
import logging
import os
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from .. import corpus as corpus_mod
from .. import flops_casc
from ..compare_casc import casc_numbers
from ..native import ensure_wavio
from ..reference import train_ref_casc
from ..trace import WindowProfiler, summarize
from ..weights_casc import make_params, model_state
from .trainer_fit import (
    Window,
    WindowClosed,
    _DecodeFallbacks,
    _host_batch,
    _quantiles,
    _trainer_class,
    valid_keys,
)


class KeywordCapture:
    """Wraps the program's ``vq_apply`` (as ``models/branches.py`` calls
    it): while ``on``, each call's scores and ids are kept as device
    tensors (references, not copies)."""

    def __init__(self):
        self.on = False
        self.calls: List = []

    def wrap(self, vq_apply):
        def captured(params, x, **kwargs):
            res = vq_apply(params, x, **kwargs)
            if self.on:
                self.calls.append((x.detach(), res["targets"][..., 0].detach()))
            return res

        return captured

    def take(self) -> List:
        calls, self.calls = self.calls, []
        return calls


class CascWindow(Window):
    """``trainer_fit``'s window, keeping besides the keyword choice of the
    steps held to the reference and kw-BN's statistics after the first
    ``record_steps``."""

    def __init__(self, *args, capture: KeywordCapture, **kwargs):
        super().__init__(*args, **kwargs)
        self.capture = capture
        self.keywords: Dict[int, tuple] = {}
        self.bn_after = None

    def wrap(self, step_fn, trainer):
        inner = super().wrap(step_fn, trainer)

        def wrapped(state, batch):
            k = self.calls
            self.capture.on = True
            try:
                state, metrics = inner(state, batch)
            finally:
                self.capture.on = False
            calls = self.capture.take()
            if k < self.record_steps or (self.check is not None and self.check["index"] == k):
                if len(calls) != 1:
                    raise RuntimeError(f"step {k} made {len(calls)} keyword choices, not one")
                self.keywords[k] = calls[0]
            if k == self.record_steps - 1:
                bn = state.model_state["cascaded_branch"]["bn"]
                self.bn_after = {n: t.detach().clone() for n, t in bn.items()}
            return state, metrics

        return wrapped


def run(cell, seed: int, seconds: float, trace: bool, device, cache_dir: str, t_start: float,
        fault=None) -> Dict:
    from speechclip_tpu_torch.config import ConfigTree
    from speechclip_tpu_torch.models import branches

    traffic, config = cell["traffic"], cell["config"]
    sizes = config["sizes"]
    print(f"wav decode: native, {ensure_wavio(cache_dir)}", flush=True)
    root = corpus_mod.ensure_corpus(os.path.join(cache_dir, "corpus"), traffic["corpus"])
    workdir = tempfile.mkdtemp(prefix="portbench-")
    tree = ConfigTree(config["tree"])
    tree.set_path("seed", int(seed))
    tree.set_path("data.dataset.dataset_root", root)
    tree.set_path("trainer.default_root_dir", workdir)
    tree.set_path("trainer.max_steps", 10 ** 12)
    tree.set_path("trainer.check_val_every_n_epoch", 10 ** 12)

    fallbacks = _DecodeFallbacks()
    logging.getLogger("speechclip_tpu_torch.data.loader").addHandler(fallbacks)
    profiler = WindowProfiler() if trace else None
    check_at = int(np.random.default_rng([int(seed), 1]).integers(
        0, int(traffic["window_check_steps"])))
    capture = KeywordCapture()
    window = CascWindow(seconds, int(traffic["record_steps"]), profiler, fault, check_at,
                        capture=capture)
    cls = _trainer_class()
    cls.window = window
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    marks = {"process_to_driver_s": time.perf_counter() - t_start}
    params = make_params(sizes, seed, device)
    state0 = model_state(sizes, device)
    t = time.perf_counter()
    trainer = cls(tree, workdir=workdir, device=device)
    marks["trainer_s"] = time.perf_counter() - t
    program_vq = branches.vq_apply
    branches.vq_apply = capture.wrap(program_vq)
    try:
        trainer.fit(initial_params=params, initial_model_state=state0)
    except WindowClosed:
        pass
    finally:
        branches.vq_apply = program_vq
        shutil.rmtree(workdir, ignore_errors=True)
        logging.getLogger("speechclip_tpu_torch.data.loader").removeHandler(fallbacks)
    if window.t_end is None:
        raise RuntimeError("the fit ended before its window closed")
    if fallbacks.count:
        raise RuntimeError(f"{fallbacks.count} batch(es) fell back to the Python WAV decode")
    window_s = window.t_end - window.t0
    steps = window.calls - window.start_call
    waits = [w for epoch in trainer.loop_stats["data_waits"] for w in epoch]
    in_window = waits[window.start_call + 1:window.calls + 1]
    data_wait_s = float(sum(in_window))
    marks.update(image_cache_s=trainer.loop_stats["image_cache_s"],
                 fit_to_first_step_s=window.first_step_at - t - marks["trainer_s"],
                 warm_steps=window.start_call,
                 warm_steps_s=window.setup_end - window.first_step_at)
    lengths = [(b, lens.cpu().numpy()) for b, lens in window.lengths]
    step_flops = sum(flops_casc.train_step_flops(sizes, len(lens), b) for b, lens in lengths)
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    trace_summary = None
    if profiler is not None:
        trace_summary = summarize(profiler.events(), profiler.start_ns, profiler.stop_ns,
                                  valid_keys(lengths, sizes["audio"]["conv_layers"]))
    record = range(len(window.losses))
    initial_bn = state0["cascaded_branch"]["bn"]
    prog = {"losses": [float(x) for x in window.losses],
            "first_grads": window.first_grads, "params_after": window.params_after,
            "batches": window.recorded, "window": _host_batch(window.check),
            "scores": [window.keywords[k][0].cpu() for k in record],
            "ids": [window.keywords[k][1].cpu() for k in record],
            "bn_change": {n: (window.bn_after[n] - initial_bn[n]).cpu() for n in initial_bn}}
    if prog["window"] is not None:
        scores, ids = window.keywords[prog["window"]["index"]]
        prog["window"].update(scores=scores.cpu(), ids=ids.cpu())
    window.keywords.clear()
    del trainer, params, state0
    cls.window = None
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ref = train_ref_casc.run_reference(config, root, seed, len(prog["losses"]), device,
                                       ids=prog["ids"])
    if prog["window"] is not None:
        ref["window"] = train_ref_casc.window_step(config, root, seed, prog["window"], device,
                                                   ids=prog["window"]["ids"])
    numbers = casc_numbers(prog, ref)
    return {"e2e": {"train_utt_per_s": window.rows / window_s,
                    "setup_s": window.setup_end - t_start},
            "attempted": window.rows, "failed": 0, "memory_peak_bytes": int(peak),
            "numbers": numbers, "prog": prog, "ref": ref,
            "ctx": {"kind": "train", "window_s": window_s, "steps": steps,
                    "data_wait_s": data_wait_s, "model_flops": step_flops,
                    "data_waits_ms": _quantiles(in_window), "setup": marks,
                    "checked_step": None if window.check is None else window.check["index"],
                    "trace": trace_summary}}
