"""What the per-layer metric files of ``portbench/metrics/`` read from a
run's context: a cell's driver (``kind``), the window's seconds, the model
FLOPs of its steps and, in a traced run, the trace's reduction
(``trace.summarize``). Each returns None where there is nothing to read."""

from __future__ import annotations

from typing import Dict, Optional

from .flops import PEAK_BF16_FLOPS


def mfu_pct(ctx: Dict, kind: str) -> Optional[float]:
    """Model FLOPs of the window's steps over its seconds and the card's
    bf16 dense peak."""
    if ctx.get("kind") != kind or not ctx.get("model_flops"):
        return None
    return 100.0 * ctx["model_flops"] / (ctx["window_s"] * PEAK_BF16_FLOPS)


def kernels_roofline_pct(ctx: Dict, kind: str) -> Optional[float]:
    """The ``speechclip::*`` ops' bounds, summed, over the device time of
    the kernels launched inside their calls."""
    tr = ctx.get("trace")
    if ctx.get("kind") != kind or not tr or not tr["ops"]:
        return None
    device = sum(o["device_s"] for o in tr["ops"].values())
    if device <= 0.0:
        return None
    return 100.0 * sum(o["bound_s"] for o in tr["ops"].values()) / device


def device_idle_pct(ctx: Dict, kind: str) -> Optional[float]:
    """The traced window less the union of its device operations, as a
    share of the window."""
    tr = ctx.get("trace")
    if ctx.get("kind") != kind or not tr or tr["window_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def data_wait_pct(ctx: Dict, kind: str) -> Optional[float]:
    """The seconds the trainer's loop waited for its next batch in the
    window (the program's ``Trainer.loop_stats["data_waits"]``), as a share
    of the window."""
    if ctx.get("kind") != kind or ctx.get("data_wait_s") is None:
        return None
    return 100.0 * ctx["data_wait_s"] / ctx["window_s"]
