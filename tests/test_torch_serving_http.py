"""The port's HTTP front (``speechclip_tpu_torch.serving.make_http_server``)
against the JAX package's server over the same tiny model (JAX's seeded
init carried across): every endpoint's answer to the same request, the
400 / 404 / 500 split, the ``?path=`` confinement of the gallery files, and
the CLI ``python -m speechclip_tpu_torch.serving --ckpt <run> --platform
cpu`` in a subprocess.

Limits: features and scores within 1e-4 of JAX's answers (f32); ids,
statuses and the other fields equal."""

import http.client
import io
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from speechclip_tpu.serving import make_http_server as jax_http_server
from speechclip_tpu_torch.serving import main, make_http_server
from tests.torch_serving_common import ATOL, BUCKET, Models, npy_bytes, text_ids

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return Models(tmp_path_factory.mktemp("http_cfg"))


def _serve(server):
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server.server_address


@pytest.fixture(scope="module")
def servers(models, tmp_path_factory):
    """(port address, JAX address, port service, JAX service, gallery dir)."""
    gdir = tmp_path_factory.mktemp("galleries")
    port, ref = models.port(), models.jax()
    for svc, name in ((port, "port"), (ref, "jax")):
        (gdir / name).mkdir()
        svc.gallery_path = str(gdir / name / "gallery.npz")
    p_srv = make_http_server(port, "127.0.0.1", 0)
    j_srv = jax_http_server(ref, "127.0.0.1", 0)
    yield _serve(p_srv), _serve(j_srv), port, ref, gdir
    for srv in (p_srv, j_srv):
        srv.shutdown()
        srv.server_close()
    port.close()
    ref.close()


def request(addr, method, path, body=None):
    conn = http.client.HTTPConnection(*addr, timeout=60)
    conn.request(method, path, body=body)
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read())
    conn.close()
    return out


def both(servers, method, path, body=None):
    """(port's (status, json), JAX's (status, json)) for one request."""
    return request(servers[0], method, path, body), request(servers[1], method, path, body)


def assert_features_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), atol=ATOL, err_msg=k)


def test_encode_endpoints_answer_as_jax(servers, models):
    """/encode_speech (npy float32 and int16), /encode_image (npy uint8 and
    JPEG), /encode_text (JSON): each feature within 1e-4 of JAX's answer."""
    rng = np.random.default_rng(3)
    pcm = rng.integers(-20000, 20000, 1300, dtype=np.int16)
    for payload in (rng.standard_normal(1000).astype(np.float32), pcm):
        (ps, pb), (js, jb) = both(servers, "POST", "/encode_speech", npy_bytes(payload))
        assert ps == js == 200, pb
        assert_features_equal(pb["features"], jb["features"])
    img = rng.integers(0, 256, (64, 48, 3), dtype=np.uint8)
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG")
    for payload in (npy_bytes(img), buf.getvalue()):
        (ps, pb), (js, jb) = both(servers, "POST", "/encode_image", payload)
        assert ps == js == 200, pb
        assert_features_equal(pb["features"], jb["features"])
    ids, eot = text_ids(models.model)
    body = json.dumps({"token_ids": ids.tolist(), "eot_position": eot}).encode()
    (ps, pb), (js, jb) = both(servers, "POST", "/encode_text", body)
    assert ps == js == 200, pb
    assert_features_equal(pb["features"], jb["features"])


def test_gallery_retrieve_and_files_answer_as_jax(servers):
    """/gallery/add, /retrieve?k=, /gallery/save and /gallery/load (the
    default file, a relative and an absolute ?path= inside the gallery's
    directory), /healthz: the answers equal JAX's, scores within 1e-4."""
    rng = np.random.default_rng(12)
    for i in range(3):
        img = npy_bytes(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8))
        (ps, pb), (js, jb) = both(servers, "POST", f"/gallery/add?id=h{i}", img)
        assert ps == js == 200 and pb == jb, (pb, jb)
    wav = npy_bytes(rng.standard_normal(900).astype(np.float32))
    for query in ("/retrieve?k=2", "/retrieve?k=3&feat=cascaded"):
        (ps, pb), (js, jb) = both(servers, "POST", query, wav)
        assert ps == js == 200, pb
        assert [h["id"] for h in pb["results"]] == [h["id"] for h in jb["results"]]
        np.testing.assert_allclose([h["score"] for h in pb["results"]],
                                   [h["score"] for h in jb["results"]], atol=ATOL)
    gdir = servers[4]
    for query, name in (("/gallery/save", "gallery.npz"), ("/gallery/save?path=rel.npz", "rel.npz"),
                        ("/gallery/load?path=rel.npz", "rel.npz")):
        p_ans = request(servers[0], "POST", query)
        j_ans = request(servers[1], "POST", query)
        assert p_ans[0] == j_ans[0] == 200
        assert p_ans[1]["path"] == str(gdir / "port" / name)
        assert {k: v for k, v in p_ans[1].items() if k != "path"} == {
            k: v for k, v in j_ans[1].items() if k != "path"}
    absolute = str(gdir / "port" / "abs.npz")
    assert request(servers[0], "POST", f"/gallery/save?path={absolute}") == (
        200, {"saved": 3, "path": absolute})
    (ps, pb), (js, jb) = both(servers, "GET", "/healthz")
    assert ps == js == 200 and pb == jb, (pb, jb)
    assert pb["gallery_size"] == 3 and "encode_speech" in pb["endpoints"]


def test_malformed_requests_are_400_and_unknown_paths_404(servers):
    for path, body in (("/encode_speech", b"not an npy"), ("/encode_text", b"{not json"),
                       ("/encode_text", b'{"token_ids": [1, 2]}'),
                       ("/retrieve?feat=bogus", npy_bytes(np.zeros(500, np.float32))),
                       ("/encode_speech", npy_bytes(np.zeros((2, 300), np.float32))),
                       ("/encode_text", json.dumps({"token_ids": [1, 2],
                                                    "eot_position": 5}).encode())):
        (ps, pb), (js, _) = both(servers, "POST", path, body)
        assert ps == js == 400 and "error" in pb, (path, pb)
    for method in ("GET", "POST"):
        (ps, _), (js, _) = both(servers, method, "/nowhere", b"")
        assert ps == js == 404


def test_a_server_fault_is_500_without_its_detail(servers, monkeypatch):
    port = servers[2]

    def boom(wav):
        raise RuntimeError("secret internal state")

    monkeypatch.setattr(port, "encode_speech", boom)
    status, body = request(servers[0], "POST", "/encode_speech", npy_bytes(np.zeros(100,
                                                                                   np.float32)))
    assert status == 500 and "RuntimeError" in body["error"] and "secret" not in body["error"]


def test_gallery_paths_are_confined(models, tmp_path):
    """Without --gallery both forms of save answer 400; with it, a ?path=
    outside its directory answers 400."""
    svc = models.port()
    server = make_http_server(svc, "127.0.0.1", 0)
    addr = _serve(server)
    try:
        for query in ("/gallery/save", f"/gallery/save?path={tmp_path / 'x.npz'}"):
            status, body = request(addr, "POST", query)
            assert status == 400 and "--gallery" in body["error"]
        svc.gallery_path = str(tmp_path / "g.npz")
        for bad in ("/tmp/evil.npz", str(tmp_path / "sub" / "evil.npz"),
                    str(tmp_path / ".." / "evil.npz")):
            status, body = request(addr, "POST", f"/gallery/save?path={bad}")
            assert status == 400 and "directory" in body["error"], bad
    finally:
        server.shutdown()
        server.server_close()
        svc.close()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_the_cli_serves_a_run_checkpoint_on_the_cpu(models, tmp_path):
    """``python -m speechclip_tpu_torch.serving --ckpt <run>/ckpts/last
    --platform cpu`` answers /encode_speech with the checkpoint's features
    (1e-4 of the model's direct call) and stops on SIGINT; without
    ``--platform`` the service needs the card, which this machine lacks."""
    import signal

    import torch

    from speechclip_tpu_torch.config import ConfigTree
    from speechclip_tpu_torch.training.checkpoint import CheckpointManager
    from speechclip_tpu_torch.training.train_step import create_train_state
    from tests.test_models import tiny_speechclip_config

    tree = ConfigTree(tiny_speechclip_config(tmp_path).to_dict())
    state = create_train_state(models.model, params=models.params, model_state=models.state)
    CheckpointManager(str(tmp_path / "ckpts")).save(state, 1, {"val_loss": 1.0}, tree)
    last = str(tmp_path / "ckpts" / "last")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--ckpt", last])
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "speechclip_tpu_torch.serving", "--ckpt", last, "--platform",
         "cpu", "--port", str(port), "--host", "127.0.0.1", "--wav-samples", str(BUCKET),
         "--batch", "2"], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                status, health = request(("127.0.0.1", port), "GET", "/healthz")
                break
            except OSError:
                assert proc.poll() is None, proc.communicate()[1][-3000:]
                assert time.monotonic() < deadline, "the server did not come up"
                time.sleep(0.2)
        assert status == 200 and "encode_speech" in health["endpoints"]
        wav = np.random.default_rng(5).standard_normal(1200).astype(np.float32)
        status, body = request(("127.0.0.1", port), "POST", "/encode_speech", npy_bytes(wav))
        assert status == 200, body
        padded = np.zeros((1, BUCKET), np.float32)
        padded[0, :1200] = wav
        with torch.no_grad():
            want = models.model.encode_speech(models.params, models.state,
                                              torch.from_numpy(padded), torch.tensor([1200]))
        for key in ("parallel_audio_feat", "cascaded_audio_feat"):
            np.testing.assert_allclose(body["features"][key], want[key][0].numpy(), atol=ATOL)
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            out, err = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    assert f"on 127.0.0.1:{port}" in out
