"""The port's serving runtime (``speechclip_tpu_torch/serving.py``) on the
CPU against the JAX package's (``speechclip_tpu/serving.py``): both
``EncoderService.from_model`` over one tiny both-branch model (JAX's seeded
init carried across), the micro-batcher, padding, buckets, the int16 wav,
the bf16 cast, the guards, round-robin devices, the load generator, the
gallery and retrieval.

Limits: f32 features within 1e-4 of JAX's; with ``dtype="bf16"`` each
feature's cosine to JAX's bf16 service 0.999; retrieval's ids equal JAX's
and its scores within 1e-4; int16 payloads bitwise the f32 service's on the
same PCM."""

import threading
import time

import numpy as np
import pytest
import torch

from speechclip_tpu_torch.serving import (
    EncoderService,
    MicroBatcher,
    _next_pow2,
    drive_requests,
    main,
)
from tests.torch_serving_common import ATOL, BUCKET, MIN_COSINE, Models, row_cosine, text_ids


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return Models(tmp_path_factory.mktemp("serving_cfg"))


@pytest.fixture(scope="module")
def services(models):
    port, ref = models.port(), models.jax()
    yield port, ref
    port.close()
    ref.close()


class TestMicroBatcher:
    def test_coalesces_concurrent_requests(self):
        calls = []

        def batch_fn(items):
            calls.append(len(items))
            return [x * 2 for x in items]

        b = MicroBatcher(batch_fn, max_batch=4, max_wait_ms=50.0)
        futs = [b.submit(i) for i in range(8)]
        assert [f.result(timeout=5) for f in futs] == [2 * i for i in range(8)]
        assert sum(calls) == 8 and len(calls) <= 4 and max(calls) > 1
        b.close()

    def test_close_drains_queued_requests(self):
        def slow_fn(items):
            time.sleep(0.4)
            return items

        b = MicroBatcher(slow_fn, max_batch=1, max_wait_ms=1.0)
        futs = [b.submit(i) for i in range(3)]
        time.sleep(0.05)  # the worker takes the first item
        b.close()
        assert futs[0].result(timeout=5) == 0  # the batch in flight completes
        assert sum(isinstance(f.exception(timeout=5), RuntimeError) for f in futs[1:]) >= 1
        with pytest.raises(RuntimeError, match="closed"):
            b.submit(99)

    def test_batch_fn_error_propagates_to_every_waiter(self):
        def batch_fn(items):
            raise ValueError("boom")

        b = MicroBatcher(batch_fn, max_batch=2, max_wait_ms=10.0)
        for f in [b.submit(i) for i in range(2)]:
            with pytest.raises(ValueError, match="boom"):
                f.result(timeout=5)
        b.close()

    def test_pipeline_depth_bounds_batches_in_flight(self):
        """Pipelined mode: the worker dispatches at most ``pipeline_depth``
        batches ahead of a fetch that has not finished (backpressure)."""
        gate = threading.Event()
        dispatched = []

        def dispatch(items):
            dispatched.append(items[0])
            return items

        def finalize(handle):
            gate.wait(timeout=10)
            return handle

        b = MicroBatcher(dispatch, max_batch=1, max_wait_ms=0.0, finalize_fn=finalize,
                         pipeline_depth=1)
        futs = [b.submit(i) for i in range(5)]
        time.sleep(0.3)
        # one batch in the fetcher, one in the queue, one in the worker's put
        assert len(dispatched) == 3
        gate.set()
        assert [f.result(timeout=10) for f in futs] == list(range(5))
        b.close()


class TestEncoderService:
    def test_f32_features_match_jax(self, services, models):
        """Speech (both branches), image and text features, each through its
        batcher, within 1e-4 of JAX's service."""
        port, ref = services
        rng = np.random.default_rng(0)
        wav = rng.standard_normal(1500).astype(np.float32)
        got, want = port.encode_speech(wav), ref.encode_speech(wav)
        assert sorted(got) == sorted(want) == ["cascaded_audio_feat", "keywords",
                                               "parallel_audio_feat"]
        for key in got:
            np.testing.assert_allclose(got[key], want[key], atol=ATOL, err_msg=key)
        img = rng.integers(0, 256, (48, 40, 3), dtype=np.uint8)
        np.testing.assert_allclose(port.encode_image(img), ref.encode_image(img), atol=ATOL)
        ids, eot = text_ids(models.model)
        np.testing.assert_allclose(port.encode_text(ids, eot), ref.encode_text(ids, eot),
                                   atol=ATOL)

    def test_bf16_cast_features_match_jax(self, models):
        """``dtype="bf16"`` casts every float param (biases, LayerNorms and
        the text tower too): per-row cosine 0.999 to JAX's bf16 service, and
        the cast moves the features."""
        port, ref, f32 = models.port(dtype="bf16"), models.jax(dtype="bf16"), models.port()
        try:
            assert port._speech_buckets[0]["exported"]._captures[0]["clip"]["text"][
                "ln_final"]["bias"].dtype == torch.bfloat16
            rng = np.random.default_rng(1)
            wav = rng.standard_normal(1700).astype(np.float32)
            got, want = port.encode_speech(wav), ref.encode_speech(wav)
            for key in ("parallel_audio_feat", "cascaded_audio_feat"):
                assert row_cosine(got[key], want[key]) >= MIN_COSINE, key
            assert not np.array_equal(got["parallel_audio_feat"],
                                      f32.encode_speech(wav)["parallel_audio_feat"])
            img = rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)
            assert row_cosine(port.encode_image(img), ref.encode_image(img)) >= MIN_COSINE
            ids, eot = text_ids(models.model)
            assert row_cosine(port.encode_text(ids, eot), ref.encode_text(ids, eot)) >= MIN_COSINE
        finally:
            for s in (port, ref, f32):
                s.close()

    def test_int16_payload_and_compact_wav(self, services, models):
        """int16 PCM requests equal f32 / 32768; ``compact_wav`` ships int16
        to the model and equals the f32 service on int16-origin payloads
        (float payloads quantize: close, not equal)."""
        port, _ = services
        i16 = models.port(compact_wav=True)
        try:
            assert i16._route_speech(1000)["wav_dtype"] == np.int16
            rng = np.random.default_rng(6)
            pcm = rng.integers(-30000, 30000, 1100, dtype=np.int16)
            a = port.encode_speech(pcm)["parallel_audio_feat"]
            np.testing.assert_array_equal(
                a, port.encode_speech(pcm.astype(np.float32) / 32768.0)["parallel_audio_feat"])
            np.testing.assert_array_equal(a, i16.encode_speech(pcm)["parallel_audio_feat"])
            wav = rng.standard_normal(1500).astype(np.float32) * 0.1
            diff = (port.encode_speech(wav)["parallel_audio_feat"]
                    - i16.encode_speech(wav)["parallel_audio_feat"])
            assert 0 < np.linalg.norm(diff) < 1e-2
        finally:
            i16.close()

    def test_buckets_route_and_crop(self, models):
        """Two buckets: a request takes the smallest that fits, overlong
        audio crops to the largest; the features within 1e-4 of JAX's direct
        call on the padded row, a cropped request bitwise the request cut to
        the bucket."""
        import jax.numpy as jnp

        port = models.port(wav_buckets=(2000, 4000), batch=2)
        try:
            assert sorted(port.batchers) == ["encode_image", "encode_speech@2000",
                                             "encode_speech@4000", "encode_text"]
            assert [port._route_speech(n)["wav_samples"] for n in (1500, 2000, 3000, 9000)] == [
                2000, 2000, 4000, 4000]
            rng = np.random.default_rng(7)
            wav = rng.standard_normal(4500).astype(np.float32)
            got = port.encode_speech(wav[:3000])["parallel_audio_feat"]
            row = np.zeros((1, 4000), np.float32)
            row[0, :3000] = wav[:3000]
            want = models.jax_model.encode_speech(
                models.jax_params, models.jax_state, jnp.asarray(row),
                jnp.asarray([3000]))["parallel_audio_feat"]
            np.testing.assert_allclose(got, np.asarray(want)[0], atol=ATOL)
            np.testing.assert_array_equal(port.encode_speech(wav)["parallel_audio_feat"],
                                          port.encode_speech(wav[:4000])["parallel_audio_feat"])
            stats = port.stats()
            assert stats["encode_speech@4000"]["items"] == 3
            assert stats["encode_speech@2000"]["items"] == 0
        finally:
            port.close()

    def test_padding_to_a_power_of_two_or_the_fixed_batch(self, models):
        """Polymorphic batches pad to the next power of two, ``fixed_batch``
        ones to exactly ``batch``; pad rows carry the full valid length;
        overflowing a fixed batch raises (exact shapes and lengths)."""
        poly, fixed = models.port(batch=8), models.port(fixed_batch=True)
        try:
            seen = []
            for svc in (poly, fixed):
                bucket = svc._route_speech(100)
                enc = bucket["exported"]
                call = enc.call

                def record(*args, device=None, _call=call):
                    seen.append((args[0].shape, args[1].tolist()))
                    return _call(*args, device=device)

                enc.call = record
                for n in (1, 3):
                    handle = svc._speech_dispatch([np.zeros(100, np.float32)] * n, bucket)
                    assert handle[1] == n and len(svc._finalize_call(handle)) == n
            assert seen == [((1, BUCKET), [100]), ((4, BUCKET), [100, 100, 100, BUCKET]),
                            ((4, BUCKET), [100, BUCKET, BUCKET, BUCKET]),
                            ((4, BUCKET), [100, 100, 100, BUCKET])]
            assert [_next_pow2(n) for n in (1, 2, 3, 5, 8)] == [1, 2, 4, 8, 8]
            with pytest.raises(ValueError, match="exceeds"):
                fixed._speech_batch([np.zeros(10, np.float32)] * 8, fixed._route_speech(10))
        finally:
            poly.close()
            fixed.close()


class TestServiceGuards:
    """The guards JAX's ``TestServiceGuards`` and service tests pin."""

    def test_max_batch_clamps_to_the_fixed_batch(self, models):
        svc = models.port(fixed_batch=True, max_batch=16, max_wait_ms=50.0)
        try:
            assert {b.max_batch for b in svc.batchers.values()} == {4}
            results = [None] * 6

            def worker(i):
                results[i] = svc.encode_speech(np.zeros(500, np.float32))

            threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert all(r is not None for r in results)
        finally:
            svc.close()

    def test_batch_caps_the_batchers_unless_max_batch_is_set(self, models):
        svc = models.port(batch=16, max_batch=None)
        svc2 = models.port(batch=16, max_batch=4)
        try:
            assert {b.max_batch for b in svc.batchers.values()} == {16}
            assert svc2.batchers["encode_speech"].max_batch == 4
        finally:
            svc.close()
            svc2.close()

    def test_request_guards(self, services, models):
        port, _ = services
        with pytest.raises(ValueError, match="ONE 1-D waveform"):
            port.encode_speech(np.zeros((2, 100), np.float32))
        with pytest.raises(ValueError, match="context"):
            port.encode_text(np.zeros(100, np.int32), 0)
        ids, _ = text_ids(models.model)
        with pytest.raises(ValueError, match="eot_position"):
            port.encode_text(ids, len(ids))
        with pytest.raises(ValueError, match="preprocessed"):
            port.encode_image(np.zeros((8, 8, 3), np.float32))

    def test_duplicate_buckets_collapse_and_a_missing_surface_is_clear(self, models):
        svc = models.port(wav_buckets=(2000, 2000))
        try:
            assert len(svc._speech_buckets) == 1 and "encode_speech" in svc.batchers
        finally:
            svc.close()
        image_only = EncoderService(None, _encoders=[
            (stem, enc) for stem, enc in [("encode_image",
                                           svc._exported["encode_image"])]])
        try:
            with pytest.raises(RuntimeError, match="encode_speech"):
                image_only.encode_speech(np.zeros(100, np.float32))
        finally:
            image_only.close()

    def test_artifacts_wait_for_the_export_item(self, tmp_path):
        with pytest.raises(NotImplementedError, match=r"Queue 1 item 6"):
            EncoderService(str(tmp_path))
        with pytest.raises(NotImplementedError, match=r"Queue 1 item 6"):
            main(["--artifacts", str(tmp_path), "--platform", "cpu"])
        with pytest.raises(TypeError, match="from_checkpoint"):
            EncoderService()


def test_round_robin_over_two_devices(models):
    """``devices=["cpu", "cpu"]``: consecutive batches alternate between the
    two entries and the features agree bitwise; on another device the model
    and params are copied there once."""
    svc = models.port(devices=["cpu", "cpu"])
    try:
        bucket = svc._route_speech(900)
        enc = bucket["exported"]
        devices, call = [], enc.call

        def record(*args, device=None):
            devices.append(device)
            return call(*args, device=device)

        enc.call = record
        wav = np.random.default_rng(8).standard_normal(900).astype(np.float32)
        r1 = svc._speech_batch([wav], bucket)[0]
        r2 = svc._speech_batch([wav], bucket)[0]
        r3 = svc.encode_speech(wav)
        assert devices == ["cpu", "cpu", "cpu"] and next(svc._rr) == 3
        for r in (r2, r3):
            np.testing.assert_array_equal(r["parallel_audio_feat"], r1["parallel_audio_feat"])
        assert enc._on("cpu")[0] is models.model and not enc._placed  # the model's own device
        other = enc._on("cpu:0")  # another device: the model and params copied there once
        assert enc._on("cpu:0") is other and list(enc._placed) == ["cpu:0"]
        assert other[0].device == torch.device("cpu:0") and other[0] is not models.model
        assert other[1][0]["weighted_sum"]["weights"] is not models.params["weighted_sum"]["weights"]
    finally:
        svc.close()


def test_dispatch_runs_under_inference_mode_on_the_worker_thread(models):
    """Grad mode is thread-local: the batcher's worker enters
    ``torch.inference_mode()`` itself, so no kernel records a graph."""
    svc = models.port()
    try:
        enc = svc._route_speech(100)["exported"]
        seen, call = [], enc.call

        def record(*args, device=None):
            seen.append((threading.current_thread().name, torch.is_inference_mode_enabled(),
                         torch.is_grad_enabled()))
            out = call(*args, device=device)
            seen.append(all(not v.requires_grad for v in out.values()))
            return out

        enc.call = record
        with torch.enable_grad():
            svc.encode_speech(np.zeros(300, np.float32))
        assert seen == [("microbatcher-encode_speech", True, False), True]
    finally:
        svc.close()


def test_warmup_runs_every_surface_without_touching_the_stats(models):
    svc = models.port(batch=4)
    try:
        before = svc.stats()
        calls = []
        for name in ("_speech_batch", "_image_batch", "_text_batch"):
            fn = getattr(svc, name)
            setattr(svc, name, lambda items, *a, _fn=fn, _name=name, **k: (
                calls.append((_name, len(items))), _fn(items, *a, **k))[1])
        svc.warmup()
        assert svc.stats() == before
        assert calls == [(n, s) for n in ("_speech_batch", "_image_batch", "_text_batch")
                         for s in (1, 2, 4)]
        assert np.isfinite(svc.encode_speech(np.zeros(700, np.float32))["parallel_audio_feat"]).all()
    finally:
        svc.close()


class TestDriveRequests:
    class _FakeService:
        def __init__(self, fail_at=None):
            self.calls = 0
            self._fail_at = fail_at
            self._lock = threading.Lock()

        def encode_speech(self, wav):
            with self._lock:
                self.calls += 1
                n = self.calls
            if self._fail_at is not None and n == self._fail_at:
                raise RuntimeError("device fell over")
            return {"parallel_audio_feat": np.zeros(4)}

    def test_all_requests_complete(self):
        svc = self._FakeService()
        elapsed, latencies = drive_requests(svc, [np.zeros(8, np.float32)], 20, 4)
        assert svc.calls == 20 and len(latencies) == 20 and elapsed > 0

    def test_client_error_reraises_without_hanging(self):
        svc = self._FakeService(fail_at=5)
        with pytest.raises(RuntimeError, match="device fell over"):
            drive_requests(svc, [np.zeros(8, np.float32)], 1000, 8)
        assert svc.calls < 1000

    def test_drives_the_service(self, services):
        port, _ = services
        before = port.stats()["encode_speech"]
        wavs = [np.random.default_rng(i).standard_normal(800 + 100 * i).astype(np.float32)
                for i in range(3)]
        elapsed, latencies = drive_requests(port, wavs, 12, 6)
        after = port.stats()["encode_speech"]
        assert len(latencies) == 12 and after["items"] - before["items"] == 12
        assert after["batches"] - before["batches"] < 12  # coalesced


class TestGallery:
    def test_retrieve_matches_jax(self, models):
        """The same images added to both galleries, the same query: the
        same ids in the same order (host ``argsort(-scores)``), scores
        within 1e-4; an unknown feature raises."""
        port, ref = models.port(), models.jax()
        try:
            rng = np.random.default_rng(11)
            wav = rng.standard_normal(1800).astype(np.float32)
            assert port.retrieve(wav, k=3) == []
            for i in range(5):
                img = rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)
                assert port.gallery_add(img, f"img{i}") == ref.gallery_add(img, f"img{i}")
            for feat in ("parallel", "cascaded"):
                got, want = port.retrieve(wav, k=4, feat=feat), ref.retrieve(wav, k=4, feat=feat)
                assert [h["id"] for h in got] == [h["id"] for h in want]
                np.testing.assert_allclose([h["score"] for h in got],
                                           [h["score"] for h in want], atol=ATOL)
            with pytest.raises(ValueError, match="audio feature"):
                port.retrieve(wav, feat="bogus")
        finally:
            port.close()
            ref.close()

    def test_lifecycle_and_files_readable_by_either_package(self, models, tmp_path):
        """Save and load, FIFO eviction at ``gallery_max`` with monotonic
        auto-ids, a load trimmed to the newest rows; a gallery saved by
        either package loads in the other with the same ids and sequence,
        its rows within 1e-4 of the other's."""
        port, ref = models.port(gallery_max=3), models.jax(gallery_max=3)
        try:
            rng = np.random.default_rng(31)
            imgs = [rng.integers(0, 256, (40, 40, 3), dtype=np.uint8) for _ in range(4)]
            for i, img in enumerate(imgs):
                port.gallery_add(img, f"g{i}")
                ref.gallery_add(img, f"g{i}")
            assert port.gallery_size() == 3 and port._gallery_ids == ["g1", "g2", "g3"]
            assert port.gallery_add(imgs[0]) == "4" and port._gallery_ids == ["g2", "g3", "4"]
            ref.gallery_add(imgs[0])
            p_path, j_path = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
            assert port.gallery_save(p_path) == ref.gallery_save(j_path) == 3
            assert ref.gallery_load(p_path) == 3 and port.gallery_load(j_path) == 3
            for svc in (port, ref):
                assert svc._gallery_ids == ["g2", "g3", "4"] and svc._gallery_seq == 5
            np.testing.assert_allclose(np.stack(port._gallery_feats),
                                       np.stack(ref._gallery_feats), atol=ATOL)
            wav = rng.standard_normal(1500).astype(np.float32)
            assert [h["id"] for h in port.retrieve(wav, 3)] == [h["id"] for h in
                                                                 ref.retrieve(wav, 3)]
        finally:
            port.close()
            ref.close()
        small = models.port(gallery_max=2)
        try:
            assert small.gallery_load(p_path) == 2 and small._gallery_ids == ["g3", "4"]
        finally:
            small.close()
