"""The traced run: ``torch.profiler`` over the measured window (CPU and CUDA
activities, shapes recorded, no Python stacks), reduced to

- ``window_s`` and ``busy_s``: the traced window, and the union of the
  intervals in which a device operation (kernel, copy, set) ran in it;
- ``device_ops``: device time by operation name, largest first;
- ``idle_gaps``: the longest stretches with nothing on the device, each
  named by the benchmark's own ``portbench.*`` range and the innermost
  host op open when it began;
- ``ops``: per ``speechclip::*`` custom op, the device time of the kernels
  launched inside its calls and the sum of each call's bound
  (``flops.op_cost`` from the call's shapes).
"""

from __future__ import annotations

import bisect
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from . import flops

OP_PREFIX = "speechclip::"
RANGE_PREFIX = "portbench."


class WindowProfiler:
    def __init__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts, record_shapes=True, with_stack=False)
        self.start_ns = self.stop_ns = None

    def start(self):
        self.prof.start()
        self.start_ns = time.time_ns()

    def stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.stop_ns = time.time_ns()
        self.prof.stop()

    def events(self):
        return self.prof.profiler.kineto_results.events()


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def summarize(events, start_ns: int, stop_ns: int,
              valid_keys: Optional[Callable[[int], float]] = None, top: int = 10) -> Dict:
    """Reduce kineto events (``WindowProfiler.events()``) of the window
    [start_ns, stop_ns] (wall clock, ns)."""
    valid_keys = valid_keys or (lambda t: 1.0)
    device, host, ranges, ops, launches = [], [], [], [], {}
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.is_user_annotation() or e.name().startswith((RANGE_PREFIX, OP_PREFIX)):
                continue  # a host range's projection on the device timeline
            if s + d > start_ns and s < stop_ns:
                device.append((max(s, start_ns), min(s + d, stop_ns), e.name(), e.correlation_id()))
            continue
        name = e.name()
        if name.startswith(RANGE_PREFIX):
            ranges.append((s, s + d, name))
        elif name.startswith(OP_PREFIX):
            ops.append((s, s + d, name[len(OP_PREFIX):].split(".")[0], e.shapes(), e.dtypes()))
        else:
            if name.startswith("cu") and e.correlation_id():
                launches[e.correlation_id()] = s
            host.append((s, s + d, name))
    window_s = (stop_ns - start_ns) / 1e9
    busy = _merge([(s, e) for s, e, _n, _c in device])
    busy_s = sum(e - s for s, e in busy) / 1e9

    by_name: Dict[str, float] = {}
    for s, e, n, _c in device:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e9
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    gaps, prev = [], start_ns
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if stop_ns > prev:
        gaps.append((prev, stop_ns))
    gaps.sort(key=lambda g: g[0] - g[1])

    def innermost(items, t):
        best = None
        for s, e, n in items:
            if s <= t < e and (best is None or s > best[0]):
                best = (s, n)
        return best[1] if best else None

    idle_gaps = []
    for s, e in gaps[:top]:
        label = innermost(ranges, s) or "outside portbench ranges"
        op = innermost(host, s)
        idle_gaps.append((f"{label} / {op}" if op else label, (e - s) / 1e9))

    ops.sort()
    starts = [o[0] for o in ops]
    op_device = [0.0] * len(ops)
    unattributed = 0.0
    for s, e, _n, corr in device:
        t = launches.get(corr)
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        if i >= 0 and t < ops[i][1]:
            op_device[i] += (e - s) / 1e9
        else:
            unattributed += (e - s) / 1e9
    per_op: Dict[str, Dict[str, float]] = {}
    unknown: Dict[str, float] = {}
    for (s, e, name, shapes, dtypes), dev in zip(ops, op_device):
        if dev <= 0.0:
            continue
        t = int(shapes[0][1]) if shapes and len(shapes[0]) == 3 else (
            int(shapes[0][2]) if shapes and len(shapes[0]) == 4 else 0)
        cost = flops.op_cost(name, shapes, dtypes, valid_keys(t))
        if cost is None:
            unknown[name] = unknown.get(name, 0.0) + dev
            continue
        rec = per_op.setdefault(name, {"calls": 0, "device_s": 0.0, "bound_s": 0.0})
        rec["calls"] += 1
        rec["device_s"] += dev
        rec["bound_s"] += flops.bound_seconds(cost, f32=dtypes[0] == "float")
    return {"window_s": window_s, "busy_s": busy_s, "device_ops": device_ops,
            "idle_gaps": idle_gaps, "ops": per_op, "unknown_ops": unknown,
            "unattributed_device_s": unattributed}
