"""Driver ``trainer_fit``: the program's ``Trainer.fit`` as a user runs it,
on a seeded corpus in Flickr8k's layout, with weights made from the seed.

Set-up is everything up to the window: the corpus (written once per
checkout), the weights, the trainer, its loaders on the native WAV decode,
the image-feature cache, and the fit's first steps, at least
``record_steps`` of them and one in every bucket shape. The window starts
at the next step, after a synchronise, and closes at the first step that
would start ``seconds`` later: that step is not run, the device is
synchronised, and the rate is the utterances of the window's steps over
the time from the window's start to that synchronise. The trainer is
stopped from outside, by an exception from the wrapped train step, so
``fit``'s own loop (loader, image-cache injection, ``device_prefetch``,
the step, its logging) is what runs in the window.

The first ``record_steps`` steps are held to the plain reference: their
batches, losses, the first gradient as Adam's first moment holds it after
step 1, and the trainable leaves after the last of them. So is one step
inside the window, drawn from the seed among its first
``window_check_steps``: its batch, its loss and its change of the
trainable leaves, worked out by the reference from the leaves and Adam
moments that the program held just before it (device copies taken in the
window, with no synchronise; read after it closes).
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
from .. import flops
from ..compare import train_numbers
from ..native import ensure_wavio
from ..reference import train_ref
from ..reference.train_ref import leaves
from ..trace import WindowProfiler, summarize
from ..weights import make_params


class WindowClosed(Exception):
    pass


class _DecodeFallbacks(logging.Handler):
    """Counts the loader's per-batch falls back to the Python WAV decode."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.count = 0

    def emit(self, record):
        if "native wav decode failed" in record.getMessage():
            self.count += 1


class Window:
    def __init__(self, seconds: float, record_steps: int, profiler, fault=None, check_at=None):
        self.seconds, self.record_steps = seconds, record_steps
        self.check_at = check_at  # the window step held to the reference
        self.check = None
        self.profiler, self.fault = profiler, fault
        self.t0 = self.t_end = None
        self.calls = self.start_call = 0
        self.buckets, self.seen = set(), set()
        self.rows = 0
        self.lengths: List = []  # (bucket samples, wav_len on the device) of the window's steps
        self.recorded: List[Dict] = []
        self.losses: List[torch.Tensor] = []
        self.first_grads = self.params_after = None
        self.setup_end = self.first_step_at = None

    def _sync(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def wrap(self, step_fn, trainer):
        from torch.profiler import record_function

        def wrapped(state, batch):
            k = self.calls
            if k == 0:
                self.first_step_at = time.perf_counter()
            if self.t0 is not None and time.perf_counter() - self.t0 >= self.seconds:
                self._sync()
                self.t_end = time.perf_counter()
                if self.profiler is not None:
                    self.profiler.stop()
                raise WindowClosed()
            if (self.t0 is None and k >= self.record_steps and self.buckets
                    and self.seen >= self.buckets):
                self._sync()
                self.t0 = self.setup_end = time.perf_counter()
                self.start_call = k
                if self.profiler is not None:
                    self.profiler.start()
            if k < self.record_steps:
                self.recorded.append({"wav": batch["wav"].float().cpu().numpy(),
                                      "wav_len": batch["wav_len"].cpu().numpy(),
                                      "id": batch["id"].cpu().numpy()})
            checked = self.t0 is not None and k - self.start_call == self.check_at
            if checked:
                self.check = self._before(trainer, state, batch, k)
            with record_function("portbench.train_step"):
                if self.fault is None:
                    state, metrics = step_fn(state, batch)
                else:  # a fault planted under the timed path (the CPU tests)
                    state, metrics = self.fault.step(step_fn, state, batch, trainer)
            self.calls += 1
            self.seen.add(int(batch["wav"].shape[1]))
            if checked:
                self.check["loss"] = metrics["train_loss"].detach().clone()
                self.check["after"] = {path: p.detach().clone()
                                       for path, p in self._leaves(trainer, state)}
            if k < self.record_steps:
                self.losses.append(metrics["train_loss"].detach().clone())
                leaves = self._leaves(trainer, state)
                if k == 0:
                    beta1 = trainer.optimizer.param_groups[0]["betas"][0]
                    self.first_grads = {
                        path: (trainer.optimizer.state[p]["exp_avg"] / (1.0 - beta1)).detach().clone()
                        for path, p in leaves}
                if k == self.record_steps - 1:
                    self.params_after = {path: p.detach().clone() for path, p in leaves}
            if self.t0 is not None:
                self.rows += int(batch["wav"].shape[0])
                self.lengths.append((int(batch["wav"].shape[1]), batch["wav_len"]))
            return state, metrics

        return wrapped

    def _before(self, trainer, state, batch, k: int) -> Dict:
        opt = trainer.optimizer
        pairs = self._leaves(trainer, state)
        return {"index": k,
                "params": {path: p.detach().clone() for path, p in pairs},
                "exp_avg": {path: opt.state[p]["exp_avg"].detach().clone() for path, p in pairs},
                "exp_avg_sq": {path: opt.state[p]["exp_avg_sq"].detach().clone()
                               for path, p in pairs},
                "batch": {key: batch[key].detach().clone() for key in ("wav", "wav_len", "id")}}

    def _leaves(self, trainer, state):
        return list(zip(self._paths(trainer, state), trainer.optimizer.param_groups[0]["params"]))

    @staticmethod
    def _paths(trainer, state):
        mask = dict(leaves(trainer.model.trainable_mask(state.params)))
        return [path for path, _t in leaves(state.params) if mask.get(path)]


def _ranged(name, fn):
    from torch.profiler import record_function

    def call(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)

    return call


class _Traced:
    """The train loader with each batch's wait in a ``portbench.loader``
    range (for the trace's idle gaps); everything else is the loader's."""

    def __init__(self, loader):
        self._loader = loader

    def __getattr__(self, name):
        return getattr(self._loader, name)

    def __len__(self):
        return len(self._loader)

    def __iter__(self):
        from torch.profiler import record_function

        it = iter(self._loader)
        try:
            while True:
                with record_function("portbench.loader"):
                    batch = next(it, None)
                if batch is None:
                    return
                yield batch
        finally:
            it.close()


def _trainer_class():
    from speechclip_tpu_torch.training.trainer import Trainer

    class WindowTrainer(Trainer):
        """The program's trainer with its train step wrapped by ``window``
        and its train loader's bucket lengths handed to it."""

        window: Window

        def build_loaders(self):
            train, dev = super().build_loaders()
            self.window.buckets = {int(b) for b in train.buckets}
            return _Traced(train), dev

        def create_state(self, *args, **kwargs):
            state = super().create_state(*args, **kwargs)
            self._train_step = self.window.wrap(self._train_step, self)
            if self.metrics_logger is not None:
                self.metrics_logger.log = _ranged("portbench.log", self.metrics_logger.log)
            return state

    return WindowTrainer


def run(cell, seed: int, seconds: float, trace: bool, device, cache_dir: str, t_start: float,
        fault=None) -> Dict:
    from speechclip_tpu_torch.config import ConfigTree

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
    window = Window(seconds, int(traffic["record_steps"]), profiler, fault, check_at)
    cls = _trainer_class()
    cls.window = window
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    marks = {"process_to_driver_s": time.perf_counter() - t_start}
    params = make_params(sizes, seed, device)
    t = time.perf_counter()
    trainer = cls(tree, workdir=workdir, device=device)
    marks["trainer_s"] = time.perf_counter() - t
    try:
        trainer.fit(initial_params=params)
    except WindowClosed:
        pass
    finally:
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
    step_flops = sum(flops.train_step_flops(sizes, len(lens), b) for b, lens in lengths)
    peak = torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0
    trace_summary = None
    if profiler is not None:
        trace_summary = summarize(profiler.events(), profiler.start_ns, profiler.stop_ns,
                                  valid_keys(lengths, sizes["audio"]["conv_layers"]))
    prog = {"losses": [float(x) for x in window.losses],
            "first_grads": window.first_grads, "params_after": window.params_after,
            "batches": window.recorded, "window": _host_batch(window.check)}
    del trainer, params
    cls.window = None
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ref = train_ref.run_reference(config, root, seed, len(prog["losses"]), device)
    if prog["window"] is not None:
        ref["window"] = train_ref.window_step(config, root, seed, prog["window"], device)
    numbers = train_numbers(prog, ref)
    return {"e2e": {"train_utt_per_s": window.rows / window_s,
                    "setup_s": window.setup_end - t_start},
            "attempted": window.rows, "failed": 0, "memory_peak_bytes": int(peak),
            "numbers": numbers, "prog": prog, "ref": ref,
            "ctx": {"kind": "train", "window_s": window_s, "steps": steps,
                    "data_wait_s": data_wait_s, "model_flops": step_flops,
                    "data_waits_ms": _quantiles(in_window), "setup": marks,
                    "checked_step": None if window.check is None else window.check["index"],
                    "trace": trace_summary}}


def _host_batch(check):
    """The checked step's snapshot with its batch read back as the recorded
    steps' batches are (None where the window closed before that step)."""
    if check is None or "after" not in check:
        return None
    b = check["batch"]
    return dict(check, loss=float(check["loss"]),
                batch={"wav": b["wav"].float().cpu().numpy(), "wav_len": b["wav_len"].cpu().numpy(),
                       "id": b["id"].cpu().numpy()})


def _quantiles(waits: List[float]) -> Dict[str, float]:
    """The window's data waits: count, median, 90th percentile, largest (ms)."""
    if not waits:
        return {}
    ms = np.asarray(waits) * 1e3
    return {"n": len(ms), "p50": float(np.median(ms)), "p90": float(np.quantile(ms, 0.9)),
            "max": float(ms.max())}


def valid_keys(lengths, conv_layers):
    """-> t -> the mean share of valid keys in the window's attention calls
    of length t: HuBERT's layers at T frames (keys within
    ``ceil(len / (L // T))``), the branch at T + 1 (``round(len / 320)``
    frames and the CLS)."""
    shares: Dict[int, List[float]] = {}
    for samples, lens in lengths:
        t = flops.conv_out_len(samples, conv_layers)[-1]
        chunk = max(samples // t, 1)
        frames = np.minimum((np.minimum(lens, chunk * t) + chunk - 1) // chunk, t)
        shares.setdefault(t, []).append(float(frames.mean()) / t)
        feat = np.minimum(np.rint(lens / 320.0), t)
        shares.setdefault(t + 1, []).append(float((feat + 1).mean()) / (t + 1))
    means = {t: float(np.mean(v)) for t, v in shares.items()}
    return lambda t: means.get(t, 1.0)
