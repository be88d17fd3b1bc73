"""What the per-layer metric files of ``portbench/metrics/`` read from the
program's own spans and counters (``speechclip_tpu_torch.utils.tracing``),
which the program records while a torch profiler session records: in a
``--trace 1`` run, the traced window's. Each returns None where there is
nothing to read: an untraced run, a cell of another kind, a span with no
call or no CUDA-event timing (the CPU), or a program without the tracer."""

from __future__ import annotations

from typing import Dict, Optional


def totals() -> Optional[Dict]:
    """The program's ``tracing.totals()``, or None where the program has
    no tracer."""
    try:
        from speechclip_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.totals()


def _span(ctx: Dict, kind: str, name: str) -> Optional[Dict]:
    if ctx.get("kind") != kind or not ctx.get("trace"):
        return None
    got = totals()
    rec = got["spans"].get(name) if got else None
    return rec if rec and rec["calls"] else None


def device_pct(ctx: Dict, kind: str, name: str) -> Optional[float]:
    """The CUDA-event seconds of the span ``name``'s calls over the traced
    window (``device_idle_pct``'s base)."""
    rec = _span(ctx, kind, name)
    window_s = ctx["trace"]["window_s"] if rec else 0.0
    if not rec or rec["device_s"] is None or window_s <= 0.0:
        return None
    return 100.0 * rec["device_s"] / window_s


def host_ms_per_call(ctx: Dict, kind: str, name: str) -> Optional[float]:
    """The host milliseconds of one call of the span ``name``, the mean
    over the window's calls."""
    rec = _span(ctx, kind, name)
    if not rec:
        return None
    return 1e3 * rec["host_s"] / rec["calls"]


def counter_gbps(ctx: Dict, kind: str, counter: str, name: str) -> Optional[float]:
    """The counter ``counter`` (bytes) over the host seconds of the span
    ``name`` that counts it, in GB/s."""
    rec = _span(ctx, kind, name)
    got = totals() if rec else None
    n = got["counters"].get(counter) if got else None
    if not n or rec["host_s"] <= 0.0:
        return None
    return n / rec["host_s"] / 1e9
