"""The port's export (``speechclip_tpu_torch/export.py``) on the CPU against
the JAX package's (``speechclip_tpu/export.py``), case for case with
``tests/test_export.py``: one tiny both-branch model (JAX's seeded init
carried across by ``convert/from_jax.py``), each package's artifact loaded
by its own ``load_exported``; JAX's exported for the CPU, as its own tests
export it.

- f32: the port's artifact within 1e-5 of JAX's artifact (the limit of
  JAX's own round-trip test), and bitwise the port's direct call;
- bf16 weights (``cast_float_params``): per-row cosine 0.999 to JAX's bf16
  artifact (``tests/torch_serving_common.py``'s limit);
- a graph at full layer width on each route (the layers of
  ``tests/test_torch_long_utterance.py``): one op node per kernel call, no
  plain version's aten ops in their place, the loaded artifact bitwise the
  direct call;
- the moves between devices: an f32 artifact moves, a bf16-compute speech
  artifact (its conv front end branches on the device) refuses another
  device type; the CLI takes one ``--platform``;
- the two branches on the batch size against JAX's symbolic export: the
  chunked conv front end raises in both; the whole-row attention gate holds
  its route at a symbolic batch where JAX's does and raises where JAX's
  would leave the route its fixed-batch artifact takes.
"""

import collections
import io
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import export as jexport

from speechclip_tpu.export import cast_float_params as jax_cast_float_params
from speechclip_tpu.export import export_encode_image as jax_export_image
from speechclip_tpu.export import export_encode_speech as jax_export_speech
from speechclip_tpu.export import export_encode_text as jax_export_text
from speechclip_tpu.export import load_exported as jax_load_exported
from speechclip_tpu.kernels import attention_vmem as jav
from speechclip_tpu.models.speechclip import SpeechCLIPModel as JaxModel
from speechclip_tpu_torch.config import ConfigTree, model_config_from_tree
from speechclip_tpu_torch.export import (
    cast_float_params,
    export_encode_image,
    export_encode_speech,
    export_encode_text,
    kernel_nodes,
    load_exported,
    load_program,
)
from speechclip_tpu_torch.kernels import attention_vmem as pav
from speechclip_tpu_torch.models.speechclip import SpeechCLIPModel
from speechclip_tpu_torch.ops import attention as pattn
from tests.test_models import tiny_speechclip_config
from tests.test_torch_config import port_config_from_jax
from tests.test_torch_long_utterance import jax_config
from tests.torch_serving_common import MIN_COSINE, Models, row_cosine

torch.set_num_threads(2)

ATOL = 1e-5  # f32 artifacts, port against JAX (tests/test_export.py's limit)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    return Models(tmp_path_factory.mktemp("export_cfg"))


def _wav(b, samples=2000, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, samples)).astype(np.float32)


def _text(model):
    text = np.zeros((2, 77), np.int32)
    text[:, 0] = model.sot_id
    text[0, 1:4] = [5, 6, 7]
    text[0, 4] = model.eot_id
    text[1, 1] = model.eot_id
    return text, np.array([4, 1], np.int32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=0)


def test_speech_roundtrip_matches_jax_artifact(models):
    blob = export_encode_speech(models.model, models.params, models.state, 2, 2000)
    assert isinstance(blob, bytes) and len(blob) > 1000
    fn = load_exported(blob)
    ref = jax_load_exported(jax_export_speech(
        models.jax_model, models.jax_params, models.jax_state, batch_size=2, wav_samples=2000,
        platforms=("cpu",)))
    wav, wav_len = _wav(2), np.array([2000, 1200], np.int32)
    got = fn(torch.from_numpy(wav), torch.from_numpy(wav_len))
    want = ref(jnp.asarray(wav), jnp.asarray(wav_len))
    assert sorted(got) == sorted(want) == ["cascaded_audio_feat", "keywords",
                                           "parallel_audio_feat"]
    assert "vq_results" not in got  # diagnostics stripped for serving
    for key in ("parallel_audio_feat", "cascaded_audio_feat"):
        _close(got[key], want[key])
    direct = models.model.encode_speech(models.params, models.state, torch.from_numpy(wav),
                                        torch.from_numpy(wav_len))
    for key in got:
        assert torch.equal(got[key], direct[key]), key


def test_image_and_text_roundtrip_match_jax_artifacts(models):
    rng = np.random.default_rng(1)
    images = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    got = load_exported(export_encode_image(models.model, models.params, 2))(
        torch.from_numpy(images))
    want = jax_load_exported(jax_export_image(models.jax_model, models.jax_params, batch_size=2,
                                              platforms=("cpu",)))(jnp.asarray(images))
    _close(got, want)
    assert torch.equal(got, models.model.forward_image(models.params, torch.from_numpy(images)))

    text, eots = _text(models.model)
    got = load_exported(export_encode_text(models.model, models.params, 2))(
        torch.from_numpy(text), torch.from_numpy(eots))
    want = jax_load_exported(jax_export_text(models.jax_model, models.jax_params, batch_size=2,
                                             platforms=("cpu",)))(jnp.asarray(text),
                                                                  jnp.asarray(eots))
    _close(got, want)
    assert got.shape == (2, want.shape[1])


def test_polymorphic_batch_serves_multiple_sizes(models):
    """One artifact with a symbolic batch serves the sizes of
    tests/test_export.py (speech 1, 3, 5; image 1, 4), each within 1e-5 of
    JAX's polymorphic artifact and bitwise the port's direct call."""
    fn = load_exported(export_encode_speech(models.model, models.params, models.state, 2, 2000,
                                            polymorphic_batch=True))
    ref = jax_load_exported(jax_export_speech(
        models.jax_model, models.jax_params, models.jax_state, batch_size=2, wav_samples=2000,
        platforms=("cpu",), polymorphic_batch=True))
    for b in (1, 3, 5):
        wav, wav_len = _wav(b, seed=b), np.full((b,), 2000, np.int32)
        got = fn(torch.from_numpy(wav), torch.from_numpy(wav_len))
        want = ref(jnp.asarray(wav), jnp.asarray(wav_len))
        _close(got["parallel_audio_feat"], want["parallel_audio_feat"])
        direct = models.model.encode_speech(models.params, models.state, torch.from_numpy(wav),
                                            torch.from_numpy(wav_len))
        assert torch.equal(got["parallel_audio_feat"], direct["parallel_audio_feat"]), b
    img = load_exported(export_encode_image(models.model, models.params, 2,
                                            polymorphic_batch=True))
    img_ref = jax_load_exported(jax_export_image(models.jax_model, models.jax_params,
                                                 batch_size=2, platforms=("cpu",),
                                                 polymorphic_batch=True))
    rng = np.random.default_rng(2)
    for b in (1, 4):
        images = rng.standard_normal((b, 32, 32, 3)).astype(np.float32)
        _close(img(torch.from_numpy(images)), img_ref(jnp.asarray(images)))


def _weight_bytes(blob: bytes) -> int:
    """The bytes of an artifact's baked weights (its archive's
    ``data/weights`` entries); the tiny model's graph, a few hundred KB of
    JSON, outweighs them."""
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        return sum(i.file_size for i in z.infolist()
                   if "/data/weights/weight" in i.filename)


def test_bf16_cast_shrinks_the_artifact(models):
    """``cast_float_params(bf16)`` shrinks the artifact and roughly halves
    its baked weights; the features stay within bf16 noise of JAX's bf16
    artifact."""
    blob_f32 = export_encode_image(models.model, models.params, 2)
    blob_bf16 = export_encode_image(models.model, cast_float_params(models.params,
                                                                    torch.bfloat16), 2)
    assert len(blob_bf16) < len(blob_f32)
    assert _weight_bytes(blob_bf16) < 0.75 * _weight_bytes(blob_f32), (
        _weight_bytes(blob_bf16), _weight_bytes(blob_f32))
    ref = jax_load_exported(jax_export_image(
        models.jax_model, jax_cast_float_params(models.jax_params, jnp.bfloat16),
        batch_size=2, platforms=("cpu",)))
    images = np.random.default_rng(3).standard_normal((2, 32, 32, 3)).astype(np.float32)
    got = load_exported(blob_bf16)(torch.from_numpy(images)).float().numpy()
    want = np.asarray(ref(jnp.asarray(images)), np.float32)
    assert min(row_cosine(g, w) for g, w in zip(got, want)) >= MIN_COSINE


def test_the_artifact_runs_on_another_device(models):
    """JAX lowers one artifact for several platforms
    (tests/test_export.py's ``platforms=("cpu", "tpu")``); the port moves a
    program traced on one device to another at load
    (``load_exported(..., device=)``): the weights and every device argument
    of the graph move, so the program runs there (here the meta device,
    which computes shapes alone) and back on the CPU equals the direct
    call."""
    blob = export_encode_image(models.model, models.params, 2)
    images = np.random.default_rng(5).standard_normal((2, 32, 32, 3)).astype(np.float32)
    on_meta = load_exported(blob, device="meta")(torch.from_numpy(images).to("meta"))
    assert on_meta.device.type == "meta" and on_meta.shape == (2, 16)
    moved = load_program(blob, device="meta")
    assert all(t.device.type == "meta" for t in moved.state_dict.values())
    got = load_exported(blob, device="cpu")(torch.from_numpy(images))
    assert torch.equal(got, models.model.forward_image(models.params, torch.from_numpy(images)))


@pytest.mark.parametrize("precision", [32, "bf16"])
def test_a_speech_artifact_moves_only_without_device_branches(models, tmp_path, precision):
    """HuBERT's bf16 convolutions branch on the device (an f32 upcast on the
    CPU, cuDNN's bf16 convolution on the card) and the graph keeps the
    traced branch: a bf16-compute speech artifact records the branch and
    refuses another device type, at load and when a service is built on
    it, while it still loads on its own device bitwise the direct call; an
    f32 one records none and moves."""
    import dataclasses

    from speechclip_tpu_torch.export import device_branches

    model = SpeechCLIPModel(dataclasses.replace(models.model.config, precision=precision),
                            device="cpu")
    blob = export_encode_speech(model, models.params, models.state, 2, 2000)
    if precision == 32:
        assert device_branches(load_program(blob)) == ()
        moved = load_program(blob, device="meta")
        assert all(t.device.type == "meta" for t in moved.state_dict.values())
        return
    assert device_branches(load_program(blob)) == ("kernels/pos_conv.py pos_conv_term",
                                                   "models/hubert.py _conv1d")
    with pytest.raises(ValueError, match=r"traced on cpu through branches that depend on the "
                                         r"device \(kernels/pos_conv\.py pos_conv_term, "
                                         r"models/hubert\.py _conv1d"):
        load_exported(blob, device="meta")
    (tmp_path / "encode_speech.pt2").write_bytes(blob)
    from speechclip_tpu_torch.serving import EncoderService

    with pytest.raises(ValueError, match="Export it on meta"):
        EncoderService(str(tmp_path), devices=["meta"])
    wav, wav_len = torch.from_numpy(_wav(2)), torch.tensor([2000, 1500], dtype=torch.int32)
    got = load_exported(blob, device="cpu")(wav, wav_len)
    direct = model.encode_speech(models.params, models.state, wav, wav_len)
    for key in got:
        assert torch.equal(got[key], direct[key]), key


@pytest.mark.parametrize("platform", ["cuda,cpu", "tpu"])
def test_the_cli_takes_one_platform(tmp_path, platform):
    """``--platform`` names one device: a comma list (JAX's multi-platform
    artifact) raises with the reason before any checkpoint is read."""
    from speechclip_tpu_torch.export import main

    with pytest.raises(SystemExit, match="--platform takes one device"):
        main(["--ckpt", str(tmp_path / "absent"), "--out", str(tmp_path / "out"),
              "--platform", platform])
    assert not (tmp_path / "out").exists()


# --------------------------------------------------------------------------
# the graph on each route, at full layer width
# --------------------------------------------------------------------------
ROUTES = {  # samples, backend, kernel nodes (one per layer: HuBERT's and the branch's)
    "fused_t319": (102400, "auto", {"mha_layer_block": 2, "ffn_block": 2}),
    "mha_t599": (192000, "auto", {"mha_layer_block": 2}),
    "vmem_t849": (272000, "auto", {"attention_vmem": 2}),
    "flash_t319": (102400, "pallas", {"flash_attention": 2}),
}


@pytest.fixture(scope="module")
def wide():
    """The port's bf16 model of tests/test_torch_long_utterance.py (HuBERT
    and the parallel branch one layer each at D = 768, a 16-channel conv
    front end) from its own seeded init."""
    model = SpeechCLIPModel(port_config_from_jax(jax_config(16)), device="cpu")
    params, state = model.init(0)
    return model, params, state


def _aten_ops(program):
    ops = collections.Counter()
    for module in program.graph_module.modules():
        if isinstance(module, torch.fx.GraphModule):
            ops.update(str(n.target) for n in module.graph.nodes
                       if n.op == "call_function" and str(n.target).startswith("aten."))
    return ops


def _long_wavs(b, samples):
    rng = np.random.default_rng(samples + b)
    lens = np.array([samples, samples - 9000, samples - 300][:b], np.int32)
    wav = (0.1 * rng.standard_normal((b, samples))).astype(np.float32)
    return wav * (np.arange(samples)[None, :] < lens[:, None]), lens


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_the_graph_holds_one_op_node_per_kernel_call(wide, route):
    """The exported graph holds the route's kernel nodes; the same surface
    traced through the plain versions (``plain=True``) holds none of them
    and more aten ops, every one of the kernel graph's among them (no plain
    version decomposed in a kernel's place); the loaded artifact's CPU run
    is bitwise the direct call."""
    model, params, state = wide
    samples, backend, want = ROUTES[route]
    with pattn.attention_backend(backend):
        program = load_program(export_encode_speech(model, params, state, 2, samples))
        plain = torch.export.export(_PlainSpeech(model, params, state),
                                    (torch.zeros(2, samples), torch.full((2,), samples)))
    assert kernel_nodes(program) == want
    assert kernel_nodes(plain) == {}
    ops, plain_ops = _aten_ops(program), _aten_ops(plain)
    assert not ops - plain_ops and sum(plain_ops.values()) > sum(ops.values())
    wav, lens = _long_wavs(2, samples)
    got = program.module()(torch.from_numpy(wav), torch.from_numpy(lens))
    with pattn.attention_backend(backend):
        direct = model.encode_speech(params, state, torch.from_numpy(wav), torch.from_numpy(lens))
    assert torch.equal(got["parallel_audio_feat"], direct["parallel_audio_feat"])


class _PlainSpeech(torch.nn.Module):
    def __init__(self, model, params, state):
        super().__init__()
        self.model, self.params, self.state = model, params, state

    def forward(self, wav, wav_len):
        out = self.model.encode_speech(self.params, self.state, wav, wav_len, plain=True)
        return out["parallel_audio_feat"]


# --------------------------------------------------------------------------
# branches on the batch size, against JAX's symbolic export
# --------------------------------------------------------------------------
def test_a_chunked_conv_front_end_refuses_a_symbolic_batch(tmp_path):
    """``conv_batch_chunk`` branches on the batch: JAX's symbolic export
    raises there (the comparison is inconclusive) and so does the port's,
    naming the cause; at a fixed batch both export."""
    cfg = tiny_speechclip_config(tmp_path)
    cfg.audio_encoder.custom.conv_batch_chunk = 2
    jm = JaxModel(cfg)
    jp, js = jm.init(jax.random.key(0))
    with pytest.raises(Exception, match="inconclusive"):
        jax_export_speech(jm, jp, js, batch_size=2, wav_samples=2000, platforms=("cpu",),
                          polymorphic_batch=True)
    jax_export_speech(jm, jp, js, batch_size=3, wav_samples=2000, platforms=("cpu",))
    pm = SpeechCLIPModel(model_config_from_tree(ConfigTree(cfg.to_dict())), device="cpu")
    assert pm.audio_cfg.conv_batch_chunk == 2
    params, state = pm.init(0)
    with pytest.raises(ValueError, match="conv_batch_chunk"):
        export_encode_speech(pm, params, state, 2, 2000, polymorphic_batch=True)
    wav, lens = _wav(3, seed=7), np.array([2000, 1500, 900], np.int32)
    got = load_exported(export_encode_speech(pm, params, state, 3, 2000))(
        torch.from_numpy(wav), torch.from_numpy(lens))
    direct = pm.encode_speech(params, state, torch.from_numpy(wav), torch.from_numpy(lens))
    assert torch.equal(got["parallel_audio_feat"], direct["parallel_audio_feat"])


def test_the_whole_row_gate_at_a_symbolic_batch(wide):
    """At 17 s (HuBERT 12 heads, T = 849; the branch 8 heads, 850 rows)
    JAX's gate holds at a symbolic batch, and the port's polymorphic
    artifact keeps both ``attention_vmem`` nodes and serves B = 3 bitwise as
    the direct call. With one head of 64 at T = 849, JAX's symbolic gate
    says no where a fixed B = 2 says yes (its artifact would take the XLA
    attention at every batch): the port's raises instead."""
    (b,) = jexport.symbolic_shape("b")
    for heads, t, dh in ((12, 849, 64), (8, 850, 96)):
        assert jav.vmem_eligible(b, heads, t, t, dh, 2)
    model, params, state = wide
    program = load_program(export_encode_speech(model, params, state, 2, 272000,
                                                polymorphic_batch=True))
    assert kernel_nodes(program) == {"attention_vmem": 2}
    wav, lens = _long_wavs(3, 272000)
    got = program.module()(torch.from_numpy(wav), torch.from_numpy(lens))
    direct = model.encode_speech(params, state, torch.from_numpy(wav), torch.from_numpy(lens))
    assert torch.equal(got["parallel_audio_feat"], direct["parallel_audio_feat"])

    assert not jav.vmem_eligible(b, 1, 849, 849, 64, 2) and jav.vmem_eligible(2, 1, 849, 849, 64, 2)
    assert pav.vmem_eligible(2, 1, 849, 849, 64)

    class OneHead(torch.nn.Module):
        def forward(self, q):
            return q * 2 if pav.vmem_eligible(q.shape[0], 1, 849, 849, 64) else q

    with pytest.raises(ValueError, match="depends on the batch"):
        torch.export.export(OneHead(), (torch.zeros(2, 1, 849, 64),),
                            dynamic_shapes=({0: torch.export.Dim("b", min=1)},))
