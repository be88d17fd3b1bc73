"""The port's spans and counters (speechclip_tpu_torch/utils/tracing.py) on
``tests/test_trainer.py``'s tiny corpus: with no profiler, every span site
returns the shared no-op and the fit reads no clock beyond its own
``loop_stats`` timings; under ``torch.profiler``, the fit records every
span with its parent (the loader's from its pool thread), the staged bytes
and one session at a time; and the buffer's rules (errors, self time,
threads)."""

import sys
import threading

import numpy as np
import pytest
import torch

from speechclip_tpu_torch.ops import retrieval
from speechclip_tpu_torch.training import train_step as train_step_mod
from speechclip_tpu_torch.training import trainer as trainer_mod
from speechclip_tpu_torch.utils import tracing
from tests.test_trainer import corpus, trainer_config  # noqa: F401 (fixtures)
from tests.torch_trainer_common import comparable_config, port_trainer

torch.set_num_threads(2)

MAIN = threading.get_ident()

# (span, parent) pairs the tiny fit records; None: no parent
FIT_SPANS = [
    ("speechclip.fit.image_cache", None),
    ("speechclip.fit.data_wait", None),
    ("speechclip.loader.wait", "speechclip.fit.data_wait"),
    ("speechclip.fit.image_feats", "speechclip.fit.data_wait"),
    ("speechclip.fit.h2d", "speechclip.fit.data_wait"),
    ("speechclip.loader.assemble", None),
    ("speechclip.loader.decode", "speechclip.loader.assemble"),
    ("speechclip.loader.mask", "speechclip.loader.assemble"),
    ("speechclip.fit.step", None),
    ("speechclip.step.forward", "speechclip.fit.step"),
    ("speechclip.step.loss", "speechclip.fit.step"),
    ("speechclip.step.backward", "speechclip.fit.step"),
    ("speechclip.step.optimizer", "speechclip.fit.step"),
    ("speechclip.hubert.frontend", "speechclip.step.forward"),
    ("speechclip.hubert.pos_conv", "speechclip.step.forward"),
    ("speechclip.hubert.layers", "speechclip.step.forward"),
    ("speechclip.hubert.wsum", "speechclip.step.forward"),
    ("speechclip.image.project", "speechclip.step.forward"),
    ("speechclip.branch.parallel", "speechclip.step.forward"),
    ("speechclip.branch.cascaded", "speechclip.step.forward"),
    ("speechclip.cascaded.head", "speechclip.branch.cascaded"),
    ("speechclip.cascaded.vq", "speechclip.branch.cascaded"),
    ("speechclip.cascaded.text", "speechclip.branch.cascaded"),
    ("speechclip.fit.log", None),
    ("speechclip.fit.validate", None),
    ("speechclip.fit.save", None),
]
POOL_SPANS = {"speechclip.loader.assemble", "speechclip.loader.decode", "speechclip.loader.mask"}


def clear():
    """Drop what earlier tests in this process left in the buffer."""
    with tracing._lock:
        tracing._stale = True
        tracing._current_session()


def run_fit(trainer_config, tmp_path, staged_bytes=None):  # noqa: F811
    """The port's tiny fit (3 one-batch epochs, the image-feature cache)
    -> its trainer; ``staged_bytes`` (a list) collects the nbytes of every
    batch ``to_device`` stages."""
    cfg = comparable_config(trainer_config, dev_batch_size=8, cache=True)
    trainer = port_trainer(cfg, tmp_path, tmp_path / "port")
    if staged_bytes is None:
        trainer.fit()
        return trainer
    real = train_step_mod.to_device

    def counted(batch, device):
        staged_bytes.append(sum(np.ascontiguousarray(v).nbytes for v in batch.values()))
        return real(batch, device)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_step_mod, "to_device", counted)
        mp.setattr(trainer_mod, "to_device", counted)
        trainer.fit()
    return trainer


@pytest.fixture(scope="module")
def off_fit(trainer_config, tmp_path_factory):  # noqa: F811
    """The fit with no profiler, every clock read of the tracer's module
    logged with the object that made it, and ``_Span`` and the spans'
    ``record_function`` made to fail."""
    reads = []

    class Clock:
        @staticmethod
        def time_ns():
            reads.append(sys._getframe(1).f_locals.get("self"))
            return real_time.time_ns()

    class NoSpan:
        def __init__(self, *args):
            raise AssertionError("a span object was made with no profiler recording")

    real_time = tracing.time
    real_record = tracing._profiler.record_function
    ours = []

    def record_function(name, *args, **kwargs):
        if name.startswith("speechclip."):
            ours.append(name)
        return real_record(name, *args, **kwargs)

    assert not torch.autograd.profiler._is_profiler_enabled
    clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tracing, "time", Clock)
        mp.setattr(tracing, "_Span", NoSpan)
        mp.setattr(tracing._profiler, "record_function", record_function)
        trainer = run_fit(trainer_config, tmp_path_factory.mktemp("off"))
    return trainer, reads, ours


@pytest.fixture(scope="module")
def on_fit(trainer_config, tmp_path_factory):  # noqa: F811
    """The fit under ``torch.profiler.profile`` -> (trainer, records,
    totals, staged bytes, the profiler's event names)."""
    staged = []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        trainer = run_fit(trainer_config, tmp_path_factory.mktemp("on"), staged)
    names = {e.name for e in prof.events()}
    return trainer, tracing.records(), tracing.totals(), staged, names


def test_off_span_is_the_shared_noop():
    clear()
    assert not torch.autograd.profiler._is_profiler_enabled
    assert tracing.span("speechclip.a") is tracing.span("speechclip.b", device=True)
    assert tracing.span("speechclip.a") is tracing._NOOP
    tracing.count("speechclip.c", 5)
    tracing.count_bytes("speechclip.c", np.zeros(4))
    assert tracing.totals() == {"spans": {}, "counters": {}, "dropped": 0}


def test_off_fit_records_nothing_and_reads_only_its_own_timings(off_fit):
    """Off, the fit makes no span object, opens no ``record_function`` of
    a span, and every clock read is one of a ``Timed``'s two per use:
    ``loop_stats``' own timings (the data waits, the image cache, the
    validations, the saves)."""
    trainer, reads, ours = off_fit
    assert ours == []
    assert tracing.totals() == {"spans": {}, "counters": {}, "dropped": 0}
    assert reads and all(isinstance(r, tracing.Timed) for r in reads)
    stats = trainer.loop_stats
    batches = sum(len(w) for w in stats["data_waits"])
    epochs_ended_by_loader = len(stats["data_waits"]) - 1  # the last ends at max_steps
    uses = (batches + epochs_ended_by_loader + 1 + len(stats["validations"])
            + len(stats["saves"]))
    assert len(reads) == 2 * uses
    assert {r.name for r in reads} == {"speechclip.fit.data_wait", "speechclip.fit.image_cache",
                                       "speechclip.fit.validate", "speechclip.fit.save"}


@pytest.mark.parametrize("which", ["off", "on"])
def test_loop_stats_hold_one_wait_a_batch(which, request):
    trainer = request.getfixturevalue(f"{which}_fit")[0]
    stats = trainer.loop_stats
    assert [len(w) for w in stats["data_waits"]] == [1, 1, 1]
    waits = [w for epoch in stats["data_waits"] for w in epoch]
    assert all(w > 0 for w in waits) and stats["data_wait_s"] >= sum(waits)
    assert stats["image_cache_s"] > 0
    assert len(stats["validations"]) == len(stats["saves"]) == 3


@pytest.mark.parametrize("name,parent", FIT_SPANS, ids=[n for n, _p in FIT_SPANS])
def test_profiled_fit_records_each_span_with_its_parent(on_fit, name, parent):
    _trainer, records, totals, _staged, _names = on_fit
    mine = [r for r in records if r.name == name]
    assert mine and not any(r.error for r in mine)
    assert parent in {r.parent for r in mine}
    assert all((r.thread != MAIN) == (name in POOL_SPANS) for r in mine)
    t = totals["spans"][name]
    assert t["calls"] == len(mine) and 0 < t["self_s"] <= t["host_s"]
    assert t["device_s"] is None  # no card: no CUDA events


def test_profiled_fit_counts_the_staged_bytes(on_fit):
    """The staged bytes, and beside them only HuBERT's pos_conv route
    counter (each of its calls, on the plain route on the CPU) and the
    cascaded branch's row counters: B * K keyword rows scored and B * (K +
    2) text-tower rows a call, every batch of the tiny fit (train and dev)
    holding 8 rows."""
    trainer, records, totals, staged, _names = on_fit
    pos_conv_calls = totals["spans"]["speechclip.hubert.pos_conv"]["calls"]
    rows = 8 * totals["spans"]["speechclip.branch.cascaded"]["calls"]
    k = trainer.model.keyword_num
    assert staged and pos_conv_calls and rows and totals["counters"] == {
        "speechclip.h2d.bytes": sum(staged), "speechclip.pos_conv.plain": pos_conv_calls,
        "speechclip.vq.rows": rows * k, "speechclip.cascaded.text_rows": rows * (k + 2)}
    assert totals["spans"]["speechclip.fit.h2d"]["calls"] == len(staged)


def test_main_thread_spans_are_in_the_profiler_events(on_fit):
    _trainer, records, _totals, _staged, names = on_fit
    main = {r.name for r in records if r.thread == MAIN}
    assert main >= {n for n, _p in FIT_SPANS if n not in POOL_SPANS}
    assert main <= names
    assert not any(n.startswith("speechclip::") for n in main)


def test_a_second_session_drops_the_first(on_fit):
    """After the fit's session, an encode and a retrieval under another
    profiler: only their spans remain, with their parents."""
    trainer = on_fit[0]
    params, state = trainer.model.init(0)
    wav = torch.randn(2, 2400)
    lens = torch.tensor([2400, 1800])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = trainer.model.encode_speech(params, state, wav, lens)
        feats = out["parallel_audio_feat"]
        retrieval.retrieve(feats, torch.randn(5, feats.shape[1]), 3)
    spans = tracing.totals()["spans"]
    assert not any(n.startswith("speechclip.fit.") for n in spans)
    assert spans["speechclip.encode_speech"]["calls"] == spans["speechclip.retrieve"]["calls"] == 1
    parents = {(r.name, r.parent) for r in tracing.records()}
    assert {("speechclip.hubert.frontend", "speechclip.encode_speech"),
            ("speechclip.branch.parallel", "speechclip.encode_speech"),
            ("speechclip.retrieve", None)} <= parents


def test_cascaded_forward_records_its_three_parts_and_rows():
    """One train-mode cascaded forward (B = 3, K = 4) under a profiler: the
    head, the VQ and the text tower each once, inside the branch's span,
    and the row counters B * K and B * (K + 2)."""
    from speechclip_tpu_torch.config import tiny_flagship_config
    from speechclip_tpu_torch.models.speechclip import SpeechCLIPModel

    model = SpeechCLIPModel(tiny_flagship_config(), device="cpu")
    params, state = model.init(0)
    b, k = 3, model.keyword_num
    batch = {"wav": torch.randn(b, 2400), "wav_len": torch.tensor([2400, 1800, 1200]),
             "id": torch.arange(b), "image_feat_frozen": torch.randn(b, 16)}
    clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        model.forward(params, state, batch, generator=torch.Generator().manual_seed(0),
                      train=True)
    totals = tracing.totals()
    parts = ("speechclip.cascaded.head", "speechclip.cascaded.vq", "speechclip.cascaded.text")
    assert {(r.name, r.parent) for r in tracing.records() if r.name in parts} == {
        (n, "speechclip.branch.cascaded") for n in parts}
    assert all(totals["spans"][n]["calls"] == 1 for n in parts)
    rows = {n: v for n, v in totals["counters"].items() if ".pos_conv." not in n}
    assert rows == {"speechclip.vq.rows": b * k, "speechclip.cascaded.text_rows": b * (k + 2)}


def test_a_span_left_by_an_exception_is_kept_marked_and_left_out():
    clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.span("speechclip.outer"):
            with tracing.span("speechclip.inner"):
                pass
            with pytest.raises(KeyError):
                with tracing.span("speechclip.inner"):
                    raise KeyError("x")
    recs = tracing.records()
    assert [(r.name, r.error) for r in recs] == [
        ("speechclip.inner", False), ("speechclip.inner", True), ("speechclip.outer", False)]
    spans = tracing.totals()["spans"]
    assert spans["speechclip.inner"]["calls"] == 1
    outer = spans["speechclip.outer"]
    children = sum(r.end_ns - r.start_ns for r in recs[:2]) / 1e9
    assert outer["self_s"] == pytest.approx(outer["host_s"] - children, abs=1e-9)


def test_threads_lose_no_span_or_count():
    """More threads than cores, switching every microsecond, each opening
    nested spans and counting: every call is in the totals once."""
    threads, calls = 16, 200

    def work():
        for _ in range(calls):
            with tracing.span("speechclip.outer"):
                with tracing.span("speechclip.inner"):
                    tracing.count("speechclip.n")

    clear()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    got = tracing.totals()
    assert got["counters"] == {"speechclip.n": threads * calls}
    assert {n: s["calls"] for n, s in got["spans"].items()} == {
        "speechclip.outer": threads * calls, "speechclip.inner": threads * calls}
    assert all(r.parent == "speechclip.outer" for r in tracing.records()
               if r.name == "speechclip.inner")
