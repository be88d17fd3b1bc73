"""The port's artifact backend (``EncoderService(artifact_dir)``, ``--artifacts``)
on the CPU against the JAX package's, mirroring ``tests/test_serving.py``'s
artifact cases: one tiny both-branch model (JAX's seeded init carried
across), each package's artifacts exported at a fixed batch of 4 (or a
polymorphic batch) and served by its own ``EncoderService``.

Limits: artifact-served features within 1e-5 of JAX's artifact-served ones
(tests/test_export.py's limit) and bitwise the port's eager service
(``from_model``) on the same padded batch; the export and serving CLIs end
to end in subprocesses within 1e-4 of the model's direct call (the limit of
the port's other CLI test)."""

import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from speechclip_tpu.export import export_encode_image as jax_export_image
from speechclip_tpu.export import export_encode_speech as jax_export_speech
from speechclip_tpu.export import export_encode_text as jax_export_text
from speechclip_tpu.serving import EncoderService as JaxService
from speechclip_tpu_torch.export import (
    export_encode_image,
    export_encode_speech,
    export_encode_text,
)
from speechclip_tpu_torch.serving import EncoderService
from tests.test_torch_serving_http import REPO, _free_port, request
from tests.torch_serving_common import ATOL, BUCKET, Models, npy_bytes, text_ids

torch.set_num_threads(2)

ART_ATOL = 1e-5  # artifact features, port against JAX


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return Models(tmp_path_factory.mktemp("artifact_cfg"))


def write_port(models, out, batch=4, buckets=(BUCKET,), polymorphic=False, gallery=True):
    """The port's artifacts under ``out``: a speech bucket per wav length,
    and with ``gallery`` the image and text surfaces."""
    os.makedirs(out, exist_ok=True)
    blobs = {("encode_speech" if len(buckets) == 1 else f"encode_speech@{n}"):
             export_encode_speech(models.model, models.params, models.state, batch, n,
                                  polymorphic_batch=polymorphic) for n in buckets}
    if gallery:
        blobs["encode_image"] = export_encode_image(models.model, models.params, batch,
                                                    polymorphic_batch=polymorphic)
        blobs["encode_text"] = export_encode_text(models.model, models.params, batch,
                                                  polymorphic_batch=polymorphic)
    for name, blob in blobs.items():
        with open(os.path.join(out, f"{name}.pt2"), "wb") as f:
            f.write(blob)
    return str(out)


def write_jax(models, out, batch=4):
    os.makedirs(out, exist_ok=True)
    m, p, s = models.jax_model, models.jax_params, models.jax_state
    blobs = {"encode_speech": jax_export_speech(m, p, s, batch_size=batch, wav_samples=BUCKET,
                                                platforms=("cpu",)),
             "encode_image": jax_export_image(m, p, batch_size=batch, platforms=("cpu",)),
             "encode_text": jax_export_text(m, p, batch_size=batch, platforms=("cpu",))}
    for name, blob in blobs.items():
        with open(os.path.join(out, f"{name}.stablehlo"), "wb") as f:
            f.write(blob)
    return str(out)


@pytest.fixture(scope="module")
def artifact_dirs(models, tmp_path_factory):
    return (write_port(models, tmp_path_factory.mktemp("port_art")),
            write_jax(models, tmp_path_factory.mktemp("jax_art")))


def test_artifact_features_match_jax_artifacts(models, artifact_dirs):
    """Speech (both branches), image and text, each through its batcher:
    the port's artifacts within 1e-5 of JAX's, the buckets read from the
    artifacts (wav length, fixed batch, dtypes)."""
    port, ref = EncoderService(artifact_dirs[0]), JaxService(artifact_dirs[1])
    try:
        assert sorted(port.batchers) == sorted(ref.batchers)
        assert (port.wav_samples, port.fixed_batch_speech) == (BUCKET, 4)
        assert [a.shape for a in port._speech_buckets[0]["exported"].in_avals] == [
            (4, BUCKET), (4,)]
        assert port._speech_buckets[0]["wav_dtype"] == np.float32
        rng = np.random.default_rng(0)
        wav = rng.standard_normal(1500).astype(np.float32)
        got, want = port.encode_speech(wav), ref.encode_speech(wav)
        assert sorted(got) == sorted(want)
        for key in ("parallel_audio_feat", "cascaded_audio_feat"):
            np.testing.assert_allclose(got[key], want[key], atol=ART_ATOL, err_msg=key)
        img = rng.integers(0, 256, (48, 40, 3), dtype=np.uint8)
        np.testing.assert_allclose(port.encode_image(img), ref.encode_image(img), atol=ART_ATOL)
        ids, eot = text_ids(models.model)
        np.testing.assert_allclose(port.encode_text(ids, eot), ref.encode_text(ids, eot),
                                   atol=ART_ATOL)
    finally:
        port.close()
        ref.close()


def test_eager_features_equal_artifact_features(models, artifact_dirs):
    """The two backends serve the same computation: ``from_model`` with a
    fixed batch of 4 pads as the artifacts do, and every feature is
    bitwise equal."""
    art = EncoderService(artifact_dirs[0], max_wait_ms=5.0)
    eager = models.port(fixed_batch=True)
    try:
        rng = np.random.default_rng(21)
        wav = rng.standard_normal(1700).astype(np.float32)
        a, e = art.encode_speech(wav), eager.encode_speech(wav)
        assert sorted(a) == sorted(e)
        for key in a:
            np.testing.assert_array_equal(a[key], e[key], err_msg=key)
        img = rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)
        np.testing.assert_array_equal(art.encode_image(img), eager.encode_image(img))
        ids, eot = text_ids(models.model, 1)
        np.testing.assert_array_equal(art.encode_text(ids, eot), eager.encode_text(ids, eot))
    finally:
        art.close()
        eager.close()


def test_large_batch_contract(models, artifact_dirs, tmp_path):
    """A fixed-batch artifact refuses a larger batch loudly; a polymorphic
    one takes any batch, its bucket reading None as the batch."""
    wavs = [np.zeros(100, np.float32)] * 8
    fixed = EncoderService(artifact_dirs[0])
    try:
        with pytest.raises(ValueError, match="exceeds"):
            fixed._speech_batch(wavs, fixed._route_speech(100))
    finally:
        fixed.close()
    poly = EncoderService(write_port(models, tmp_path, polymorphic=True, gallery=False))
    try:
        assert poly.fixed_batch_speech is None and "encode_image" not in poly.batchers
        assert poly._speech_buckets[0]["exported"].in_avals[0].shape == (None, BUCKET)
        outs = poly._speech_batch(wavs, poly._route_speech(100))
        assert len(outs) == 8
        rng = np.random.default_rng(3)
        wav = rng.standard_normal(900).astype(np.float32)
        padded = np.zeros((1, BUCKET), np.float32)
        padded[0, :900] = wav
        with torch.no_grad():
            want = models.model.encode_speech(models.params, models.state,
                                              torch.from_numpy(padded), torch.tensor([900]))
        np.testing.assert_allclose(poly.encode_speech(wav)["parallel_audio_feat"],
                                   want["parallel_audio_feat"][0].numpy(), atol=ART_ATOL)
    finally:
        poly.close()


def test_max_batch_clamped_to_fixed_artifact(artifact_dirs):
    """An oversized max_batch must not make coalesced batches fail under
    load: the cap clamps to the artifact's fixed batch, and a burst of 6
    splits into batches of at most 4."""
    svc = EncoderService(artifact_dirs[0], max_batch=16, max_wait_ms=50.0)
    try:
        assert all(b.max_batch == 4 for b in svc.batchers.values())
        wavs = [np.zeros(500, np.float32)] * 6
        results = [None] * 6

        def worker(i):
            results[i] = svc.encode_speech(wavs[i])

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert all(r is not None for r in results)
        assert svc.stats()["encode_speech"]["batches"] >= 2
    finally:
        svc.close()


def test_missing_speech_artifact_is_a_clear_error(models, tmp_path):
    with open(tmp_path / "encode_image.pt2", "wb") as f:
        f.write(export_encode_image(models.model, models.params, 2))
    svc = EncoderService(str(tmp_path))
    try:
        with pytest.raises(RuntimeError, match="encode_speech"):
            svc.encode_speech(np.zeros(100, np.float32))
    finally:
        svc.close()
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="speechclip_tpu_torch.export"):
        EncoderService(str(empty))


def test_duplicate_wav_length_artifacts_collapse_to_one_bucket(models, tmp_path):
    blob = export_encode_speech(models.model, models.params, models.state, 2, BUCKET)
    for fname in ("encode_speech.pt2", f"encode_speech@{BUCKET}.pt2"):
        with open(tmp_path / fname, "wb") as f:
            f.write(blob)
    svc = EncoderService(str(tmp_path))
    try:
        assert len(svc._speech_buckets) == 1
        assert sorted(svc.batchers) == ["encode_speech"]
    finally:
        svc.close()


def test_requests_route_to_wav_length_buckets(models, tmp_path):
    """Several encode_speech@<n> artifacts are serving-side length buckets:
    a request goes to the smallest bucket that fits, overlong audio crops
    to the largest; the answer is the direct call's on the padded row."""
    svc = EncoderService(write_port(models, tmp_path, batch=2, buckets=(BUCKET, 2 * BUCKET),
                                    gallery=False), max_wait_ms=5.0)
    try:
        assert sorted(svc.batchers) == [f"encode_speech@{BUCKET}", f"encode_speech@{2 * BUCKET}"]
        assert [svc._route_speech(n)["wav_samples"] for n in (1500, 2000, 3000, 9000)] == [
            BUCKET, BUCKET, 2 * BUCKET, 2 * BUCKET]
        wav = np.random.default_rng(7).standard_normal(3000).astype(np.float32)
        got = svc.encode_speech(wav)
        padded = np.zeros((2, 2 * BUCKET), np.float32)
        padded[0, :3000] = wav
        with torch.no_grad():
            want = models.model.encode_speech(models.params, models.state,
                                              torch.from_numpy(padded),
                                              torch.tensor([3000, 2 * BUCKET]))
        np.testing.assert_allclose(got["parallel_audio_feat"],
                                   want["parallel_audio_feat"][0].numpy(), atol=ART_ATOL)
        stats = svc.stats()
        assert stats[f"encode_speech@{2 * BUCKET}"]["items"] == 1
        assert stats[f"encode_speech@{BUCKET}"]["items"] == 0
    finally:
        svc.close()


def test_round_robin_dispatch_across_devices(artifact_dirs):
    """``devices=["cpu", "cpu"]``: consecutive batches alternate over the
    two entries (one loaded module each) and agree bitwise."""
    svc = EncoderService(artifact_dirs[0], max_wait_ms=5.0, devices=["cpu", "cpu"])
    try:
        wav = np.random.default_rng(8).standard_normal(900).astype(np.float32)
        bucket = svc._route_speech(900)
        r1 = svc._finalize_call(svc._speech_dispatch([wav], bucket))[0]
        r2 = svc._finalize_call(svc._speech_dispatch([wav], bucket))[0]
        for key in r1:
            np.testing.assert_array_equal(r1[key], r2[key])
        np.testing.assert_array_equal(svc.encode_speech(wav)["parallel_audio_feat"],
                                      r1["parallel_audio_feat"])
        assert len(bucket["exported"]._modules) == 1  # "cpu" twice: one module
    finally:
        svc.close()


def test_the_export_and_serving_clis_end_to_end(models, tmp_path):
    """``python -m speechclip_tpu_torch.export --ckpt <run>/ckpts/last
    --platform cpu`` writes the three artifacts (``encode_speech@<n>.pt2``
    for two wav lengths); ``python -m speechclip_tpu_torch.serving
    --artifacts <dir> --platform cpu`` serves them: /encode_speech within
    1e-4 of the model's direct call."""
    from speechclip_tpu_torch.config import ConfigTree
    from speechclip_tpu_torch.training.checkpoint import CheckpointManager
    from speechclip_tpu_torch.training.train_step import create_train_state
    from tests.test_models import tiny_speechclip_config

    tree = ConfigTree(tiny_speechclip_config(tmp_path).to_dict())
    state = create_train_state(models.model, params=models.params, model_state=models.state)
    CheckpointManager(str(tmp_path / "ckpts")).save(state, 1, {"val_loss": 1.0}, tree)
    out = tmp_path / "exports"
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "speechclip_tpu_torch.export", "--ckpt",
         str(tmp_path / "ckpts" / "last"), "--out", str(out), "--batch", "2", "--wav-samples",
         str(BUCKET), str(2 * BUCKET), "--platform", "cpu"],
        cwd=REPO, capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert sorted(os.listdir(out)) == ["encode_image.pt2", f"encode_speech@{BUCKET}.pt2",
                                       f"encode_speech@{2 * BUCKET}.pt2", "encode_text.pt2"]
    assert proc.stdout.count("wrote ") == 4
    port = _free_port()
    server = subprocess.Popen(
        [sys.executable, "-m", "speechclip_tpu_torch.serving", "--artifacts", str(out),
         "--platform", "cpu", "--port", str(port), "--host", "127.0.0.1"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                status, health = request(("127.0.0.1", port), "GET", "/healthz")
                break
            except OSError:
                assert server.poll() is None, server.communicate()[1][-3000:]
                assert time.monotonic() < deadline, "the server did not come up"
                time.sleep(0.2)
        assert status == 200 and f"encode_speech@{BUCKET}" in health["endpoints"]
        wav = np.random.default_rng(5).standard_normal(1200).astype(np.float32)
        status, body = request(("127.0.0.1", port), "POST", "/encode_speech", npy_bytes(wav))
        assert status == 200, body
        padded = np.zeros((2, BUCKET), np.float32)
        padded[0, :1200] = wav
        with torch.no_grad():
            want = models.model.encode_speech(models.params, models.state,
                                              torch.from_numpy(padded),
                                              torch.tensor([1200, BUCKET]))
        for key in ("parallel_audio_feat", "cascaded_audio_feat"):
            np.testing.assert_allclose(body["features"][key], want[key][0].numpy(), atol=ATOL)
    finally:
        server.send_signal(signal.SIGINT)
        try:
            _, err = server.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            server.kill()
            _, err = server.communicate()
    assert server.returncode == 0, err[-3000:]
