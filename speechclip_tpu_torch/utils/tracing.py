"""Spans and counters inside the program, recorded while a torch profiler
session records and nowhere else.

    from speechclip_tpu_torch.utils import tracing

    with tracing.span("speechclip.hubert.frontend", device=True):
        ...
    tracing.count_bytes("speechclip.h2d.bytes", array)  # += array.nbytes
    tracing.totals()  # {"spans": {name: {calls, host_s, self_s, device_s}},
                      #  "counters": {name: n}, "dropped": n}

On exactly while a ``torch.profiler`` session records (``trainer.profile_steps``,
or an operator's own ``torch.profiler.profile``): PyTorch's process-wide
flag ``torch.autograd.profiler._is_profiler_enabled``. There is no other
switch. Off, ``span`` reads that flag and returns a shared no-op object:
no allocation, no clock read, no ``record_function``, no CUDA event. On, a
span

- opens a ``torch.profiler.record_function`` of its name, so it sits in the
  profiler's trace on the device trace's clock, beside the kernels it
  launched;
- keeps (name, thread, parent span, start, end) in a bounded buffer, with
  ``time.time_ns()`` stamps (the clock kineto's events are matched
  against); what does not fit is counted in ``dropped``;
- with ``device=True``, records two timing CUDA events on the current
  stream, resolved to seconds only by ``totals()`` (nothing in the hot
  path waits on the card). The events time the stream from the span's
  start to its end, idle inside the span included.

A span left by an exception is kept with an error mark and left out of
``totals()``: an interrupted call is not a sample of its layer. A span's
self time is its host time less that of its child spans (the innermost
span open on the same thread when it began). ``totals()`` holds only the
newest profiler session: the first span or count recorded after a span
site was reached, or ``totals()`` read, while no profiler recorded, drops
what the earlier session left (two sessions with neither between them are
one to the buffer). The buffer is shared by every thread (the loader's pool
thread records too) under one lock; a span on a thread other than the one
that started the profiler is in the buffer but, with torch 2.11 and 2.13,
not among the profiler's own events.

``Timed`` is a span whose clock runs whether a profiler records or not,
for a site that times itself anyway (``Trainer.loop_stats``): the same two
clock reads feed both.

The program's spans (d: device-timed), by module:

- ``training/trainer.py`` ``Trainer.fit``: ``speechclip.fit.data_wait``
  (``next()`` on the staged batches; ``loop_stats["data_waits"]`` takes
  the same clock reads), ``speechclip.fit.step`` (the train step's call,
  launches included), ``speechclip.fit.log`` (the log point, from reading
  the metrics back through ``MetricsLogger.log``),
  ``speechclip.fit.image_cache``, ``speechclip.fit.validate`` and
  ``speechclip.fit.save`` (with ``loop_stats``' timings);
  ``_inject_cached_image_feats``: ``speechclip.fit.image_feats`` (the
  cached-feature gather).
- ``training/train_step.py`` ``to_device``: ``speechclip.fit.h2d``
  (``pin_memory`` and the non-blocking copy) and the counter
  ``speechclip.h2d.bytes`` (each array's nbytes); ``make_train_step``:
  ``speechclip.step.forward`` (d, ``model.forward``), ``.loss`` (d,
  ``compute_loss``), ``.backward`` (d, ``torch.autograd.grad`` through the
  gradients' all-reduce), ``.optimizer`` (d, ``grad_norm``, the clip, Adam,
  the schedule).
- ``data/loader.py`` ``BucketedLoader``: ``speechclip.loader.wait`` (the
  wait for the next assembled batch); ``speechclip.loader.assemble`` in the
  pool thread, with children ``speechclip.loader.decode`` (the WAV decode)
  and ``speechclip.loader.mask`` (the crop mask, the int16 cast).
- ``models/hubert.py``: ``speechclip.hubert.frontend`` (d,
  ``_encoder_prelude``: the waveform norm, the conv chain, LayerNorm,
  ``post_extract_proj``, the padding mask), ``speechclip.hubert.pos_conv``
  (d, ``pos_conv`` and its residual add, a sibling of ``frontend``; the
  counters ``speechclip.pos_conv.kernel`` and ``speechclip.pos_conv.plain``
  count its calls by route, ``pos_conv_residual``),
  ``speechclip.hubert.layers`` (d, the layer loop of ``hubert_apply`` and of
  ``_wsum_pass``: one span for the loop, since the custom ops name each
  layer's calls).
- ``models/speechclip.py``: ``speechclip.hubert.wsum`` (d,
  ``forward_audio``: the states' normalization and ``weighted_sum_apply``,
  or ``hubert_frozen_weighted_sum``, which holds ``layers``, under
  ``wsum_remat``); ``speechclip.branch.parallel`` and ``.cascaded`` (d, the
  branch and its projection, in ``forward`` and ``encode_speech``);
  ``speechclip.image.project`` (d, ``forward``: the cached features'
  projection, or the image tower and the projection);
  ``speechclip.encode_speech`` (d).
- ``models/branches.py`` ``cascaded_branch_apply``, children of
  ``speechclip.branch.cascaded``: ``speechclip.cascaded.head`` (d, the K
  CLS rows, the MHA-and-norm, the keyword projection and kw-BN),
  ``speechclip.cascaded.vq`` (d, ``cosine_scores``, ``vq_apply`` and the
  product with the token table), ``speechclip.cascaded.text`` (d,
  ``encode_keywords``). Counters: ``speechclip.vq.rows`` (``ops/vq.py``
  ``vq_apply``: the B * K keyword rows it scores a call) and
  ``speechclip.cascaded.text_rows`` (``models/clip.py``
  ``encode_keywords``: the B * (K + 2) rows the text tower takes a call).
- ``ops/retrieval.py``: ``speechclip.retrieve`` (d, the scores and the
  top-k).

Names start with ``speechclip.``, never ``speechclip::`` (the custom ops'
namespace).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

MAX_RECORDS = 1 << 18


class Record(NamedTuple):
    name: str
    thread: int
    parent: Optional[str]
    start_ns: int
    end_ns: int
    child_ns: int  # host time of the span's child spans
    error: bool
    events: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]]


_lock = threading.Lock()
_local = threading.local()
_records: List[Record] = []
_counters: Dict[str, int] = {}
_dropped = 0
_session = 0
_stale = True  # no profiler recorded since the buffer's session: the next record starts anew


def _on() -> bool:
    """Whether a torch profiler session records. When none does, marks the
    buffer's session as ended; the flag's read and that store have no call
    or backward jump between them, where CPython would switch threads, so
    no thread can mark a session that another has begun since."""
    global _stale
    if _profiler._is_profiler_enabled:
        return True
    _stale = True
    return False


def _current_session() -> int:
    """The buffer's session, a new one when the last has ended (under
    ``_lock``)."""
    global _stale, _session, _dropped
    if _stale:
        _records.clear()
        _counters.clear()
        _dropped = 0
        _session += 1
        _stale = False
    return _session


def _stack() -> List["_Span"]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "device", "session", "parent", "start_ns", "end_ns", "child_ns",
                 "record", "events")

    def __init__(self, name: str, device: bool):
        self.name, self.device = name, device

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.child_ns = 0
        self.record = _profiler.record_function(self.name)
        self.record.__enter__()
        self.events = None
        if (self.device and torch.cuda.is_initialized()
                and not torch.cuda.is_current_stream_capturing()):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self.events = (start, torch.cuda.Event(enable_timing=True))
        with _lock:
            self.session = _current_session()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.end_ns = time.time_ns()
        if self.events is not None:
            self.events[1].record()
        self.record.__exit__(exc_type, exc, tb)
        _stack().pop()
        if self.parent is not None:
            self.parent.child_ns += self.end_ns - self.start_ns
        rec = Record(self.name, threading.get_ident(),
                     None if self.parent is None else self.parent.name, self.start_ns,
                     self.end_ns, self.child_ns, exc_type is not None, self.events)
        global _dropped
        with _lock:
            if self.session == _session:  # else a later session has begun: not its sample
                if len(_records) < MAX_RECORDS:
                    _records.append(rec)
                else:
                    _dropped += 1
        return False


def span(name: str, device: bool = False):
    """A context manager over one call of a layer (see the module
    docstring); the shared no-op while no profiler records."""
    if not _on():
        return _NOOP
    return _Span(name, device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``, while a profiler records."""
    if not _on():
        return
    with _lock:
        _current_session()
        _counters[name] = _counters.get(name, 0) + int(n)


def count_bytes(name: str, array) -> None:
    """Add ``array.nbytes`` to the counter ``name``, while a profiler
    records (read only then)."""
    if not _on():
        return
    count(name, array.nbytes)


class Timed:
    """A span that times itself whether a profiler records or not:
    ``seconds`` holds the last use's length, from the same two
    ``time.time_ns()`` reads the span keeps. One per call site and thread
    (it holds its reads between enter and exit)."""

    __slots__ = ("name", "seconds", "_span", "_start_ns")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0
        self._span = None
        self._start_ns = 0

    def __enter__(self):
        s = span(self.name)
        if s is _NOOP:
            self._span = None
            self._start_ns = time.time_ns()
        else:
            self._span = s.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        s = self._span
        if s is None:
            self.seconds = (time.time_ns() - self._start_ns) / 1e9
            return False
        s.__exit__(exc_type, exc, tb)
        self.seconds = (s.end_ns - s.start_ns) / 1e9
        return False


def records() -> List[Record]:
    """The newest session's spans as recorded, errors included."""
    with _lock:
        return list(_records)


def totals() -> Dict:
    """The newest session, per span name: ``calls``, ``host_s``,
    ``self_s`` and ``device_s`` (None where no call was device-timed);
    the ``counters``; and ``dropped``, the spans the full buffer turned
    away. Spans left by an exception are left out. Reading while no
    profiler records ends the session: the next span starts a new one."""
    _on()
    with _lock:
        recs, counters, dropped = list(_records), dict(_counters), _dropped
    spans: Dict[str, Dict] = {}
    for r in recs:
        if r.error:
            continue
        t = spans.setdefault(r.name, {"calls": 0, "host_s": 0.0, "self_s": 0.0,
                                      "device_s": None})
        t["calls"] += 1
        t["host_s"] += (r.end_ns - r.start_ns) / 1e9
        t["self_s"] += (r.end_ns - r.start_ns - r.child_ns) / 1e9
        if r.events is not None:
            start, end = r.events
            end.synchronize()
            t["device_s"] = (t["device_s"] or 0.0) + start.elapsed_time(end) / 1e3
    return {"spans": spans, "counters": counters, "dropped": dropped}
