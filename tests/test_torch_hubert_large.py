"""HuBERT-large in the port against the JAX package: the preset field by
field, and ``hubert_apply`` with every switch HuBERT-large sets (the
``layer_norm`` extractor with conv biases, pre-norm layers, per-utterance
waveform normalization, ragged lengths), at small widths and at the real
width (1024 wide, 16 heads, 2 layers, a 0.4 s wave), from one JAX init
whose biases and LayerNorms are drawn at random (JAX's init leaves them at
0 and 1), carried over by convert.from_jax; and the converters on
synthetic HuBERT-large state dicts (fairseq's ``conv_layers.{i}.2.1``
LayerNorms and conv biases, HuggingFace's ``layer_norm``), through
``SpeechCLIPModel.load_pretrained`` too.

Off the TPU the JAX model runs its XLA path, so this holds the port's plain
layer math against JAX's XLA math. Tolerances as in
``tests/test_torch_hubert.py``: f32 max abs diff <= 1e-4 (in units of the
state's largest magnitude where that passes 1), bf16 per-row cosine >=
0.999. Lengths equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speechclip_tpu.convert import from_torch as jax_from_torch
from speechclip_tpu.models import hubert as jh
from speechclip_tpu_torch.convert import from_torch
from speechclip_tpu_torch.convert.from_jax import speechclip_params_from_jax
from speechclip_tpu_torch.models import hubert as ph
from speechclip_tpu_torch.models.speechclip import cast_params
from tests.test_torch_config import PORT_HUBERT_FIELDS, TRAINING_ONLY_FIELDS
from tests.test_torch_from_torch import _assert_trees_equal, _numpy, hubert_sd

torch.set_num_threads(2)

F32_ATOL = 1e-4
MIN_COSINE = 0.999
DTYPES = [torch.float32, torch.bfloat16]

# HuBERT-large's switches at small widths (three convs, 20x downsampling)
SMALL_LARGE = jh.HubertConfig(
    conv_layers=((16, 10, 5), (16, 3, 2), (16, 3, 2)),
    conv_bias=True, extractor_mode="layer_norm", layer_norm_first=True,
    normalize_waveform=True, encoder_embed_dim=32, encoder_layers=2, encoder_ffn_dim=64,
    encoder_heads=4, downsample_rate=20,
)
# the real widths: HuBERT-large's conv chain and 1024-wide layers, 2 of 24
REAL_WIDTH = dataclasses.replace(jh.HUBERT_LARGE, encoder_layers=2)


def port_hubert_config(cfg: jh.HubertConfig) -> ph.HubertConfig:
    return ph.HubertConfig(**{k: v for k, v in dataclasses.asdict(cfg).items()
                              if k in PORT_HUBERT_FIELDS})


def randomize(tree, rng):
    """Every bias and LayerNorm leaf drawn at random (scale ~ 1 + 0.1 N,
    others 0.1 N), so a dropped or misplaced one shows."""
    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, key) for v in node]
        if node is None:
            return None
        a = np.asarray(node, np.float32)
        if key == "scale":
            return (1 + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if key in ("b", "bias"):
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return a
    return walk(tree)


def towers(cfg, wav_len, lens, seed=0):
    """(JAX params, the port's params per dtype, the wave) for ``cfg``."""
    jae = jax.jit(lambda k: jh.hubert_init(k, cfg))(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    jae = randomize(jax.tree.map(np.asarray, jae), rng)
    pae = speechclip_params_from_jax({"audio_encoder": jae})["audio_encoder"]
    wav = (0.1 * rng.standard_normal((len(lens), wav_len)) + 0.05).astype(np.float32)
    wav *= np.arange(wav_len)[None, :] < lens[:, None]
    return jae, {dt: cast_params(pae, dt, device="cpu") for dt in DTYPES}, wav


def assert_match(got: torch.Tensor, want, dtype):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape
    if dtype == torch.float32:
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, atol=F32_ATOL * scale, rtol=0)
        return
    a, b = got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-12)
    assert cos.min() >= MIN_COSINE, cos.min()


def run_both(cfg, jae, pae, wav, lens, dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jstates, jlens = jh.hubert_apply(jax.tree.map(jnp.asarray, jae), cfg,
                                     jnp.asarray(wav).astype(jdt), jnp.asarray(lens))
    pstates, plens = ph.hubert_apply(pae[dtype], port_hubert_config(cfg),
                                     torch.from_numpy(wav).to(dtype), torch.from_numpy(lens))
    return jstates, jlens, pstates, plens


def test_hubert_large_preset_matches_jax_field_by_field():
    jax_fields = dataclasses.asdict(jh.HUBERT_LARGE)
    assert set(jax_fields) - PORT_HUBERT_FIELDS == TRAINING_ONLY_FIELDS
    assert dataclasses.asdict(ph.HUBERT_LARGE) == {
        k: v for k, v in jax_fields.items() if k in PORT_HUBERT_FIELDS}
    assert set(ph.NAMED_CONFIGS) == set(jh.NAMED_CONFIGS)
    for name, cfg in jh.NAMED_CONFIGS.items():
        assert ph.NAMED_CONFIGS[name] == port_hubert_config(cfg), name
    assert ph.HUBERT_LARGE.num_hidden_states == 25


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_large_switches_match_jax_every_state_and_lengths(dtype):
    lens = np.array([1200, 910, 477], np.int32)
    jae, pae, wav = towers(SMALL_LARGE, 1200, lens)
    jstates, jlens, pstates, plens = run_both(SMALL_LARGE, jae, pae, wav, lens, dtype)
    assert len(pstates) == len(jstates) == SMALL_LARGE.encoder_layers + 1
    for got, want in zip(pstates, jstates):
        assert got.dtype == dtype
        assert_match(got, want, dtype)
    np.testing.assert_array_equal(plens.numpy(), np.asarray(jlens))


def test_layer_norm_extractor_keeps_conv_batch_chunk_exact():
    """The ``layer_norm`` extractor (a LayerNorm after every conv, through
    the (B, C, T) <-> (B, T, C) transpose) over batch chunks equals the
    whole batch (1e-6: the CPU convolution may pick another algorithm at
    another batch size)."""
    lens = np.array([1200, 910, 477, 1100, 640], np.int32)
    _, pae, wav = towers(SMALL_LARGE, 1200, lens, seed=1)
    cfg = port_hubert_config(SMALL_LARGE)
    x = torch.from_numpy(wav)
    whole = ph.conv_feature_extractor(pae[torch.float32]["feature_extractor"], cfg, x)
    chunked = ph.conv_feature_extractor(pae[torch.float32]["feature_extractor"],
                                        dataclasses.replace(cfg, conv_batch_chunk=2), x)
    torch.testing.assert_close(chunked, whole, rtol=0, atol=1e-6)


def test_pre_norm_states_skip_the_encoder_layer_norm():
    """With ``layer_norm_first`` the states are the layer outputs as they
    are: neither package applies ``encoder.layer_norm`` to them (fairseq
    does, after the last layer); changing its params changes nothing."""
    lens = np.array([800, 640], np.int32)
    _, pae, wav = towers(SMALL_LARGE, 800, lens, seed=2)
    cfg = port_hubert_config(SMALL_LARGE)
    params = pae[torch.float32]
    moved = dict(params, encoder=dict(params["encoder"], layer_norm={
        "scale": params["encoder"]["layer_norm"]["scale"] * 3.0,
        "bias": params["encoder"]["layer_norm"]["bias"] + 1.0}))
    x, n = torch.from_numpy(wav), torch.from_numpy(lens)
    for a, b in zip(ph.hubert_apply(params, cfg, x, n)[0], ph.hubert_apply(moved, cfg, x, n)[0]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_real_width_two_layers_match_jax(dtype):
    """1024 wide, 16 heads of 64, FFN 4096, HuBERT-large's conv chain, 2
    layers, a 0.4 s wave (T = 19) with one ragged length."""
    lens = np.array([6400, 4000], np.int32)
    jae, pae, wav = towers(REAL_WIDTH, 6400, lens, seed=3)
    jstates, jlens, pstates, plens = run_both(REAL_WIDTH, jae, pae, wav, lens, dtype)
    assert pstates[0].shape == (2, 19, 1024)
    for got, want in zip(pstates, jstates):
        assert_match(got, want, dtype)
    np.testing.assert_array_equal(plens.numpy(), np.asarray(jlens))


def large_hubert_sd(ae, flavor):
    """``hubert_sd`` plus what the ``layer_norm`` extractor adds: a conv
    bias on every layer and its LayerNorm, fairseq's at ``.2.1`` (a
    Sequential of TransposeLast, Fp32LayerNorm, TransposeLast), HF's at
    ``.layer_norm``."""
    sd = hubert_sd({**ae, "feature_extractor": [
        {"w": layer["w"]} for layer in ae["feature_extractor"]]}, flavor)
    for i, layer in enumerate(ae["feature_extractor"]):
        prefix = f"feature_extractor.conv_layers.{i}."
        sd[prefix + ("conv.bias" if flavor == "hf" else "0.bias")] = layer["b"]
        norm = prefix + ("layer_norm" if flavor == "hf" else "2.1")
        sd[f"{norm}.weight"], sd[f"{norm}.bias"] = layer["norm"]["scale"], layer["norm"]["bias"]
    return sd


@pytest.mark.parametrize("flavor", ["fairseq", "hf"])
def test_large_state_dict_converts_back_and_as_jax_does(flavor):
    _, pae, _ = towers(SMALL_LARGE, 400, np.array([400], np.int32), seed=4)
    ae = pae[torch.float32]
    sd = large_hubert_sd(ae, flavor)
    norm = ".2.1.weight" if flavor == "fairseq" else ".layer_norm.weight"
    assert all(f"feature_extractor.conv_layers.{i}{norm}" in sd for i in range(3))
    cfg = port_hubert_config(SMALL_LARGE)
    convert = from_torch.hubert_from_hf if flavor == "hf" else from_torch.hubert_from_fairseq
    got = convert(sd, cfg)
    _assert_trees_equal(got, ae)
    jax_convert = (jax_from_torch.hubert_from_hf if flavor == "hf"
                   else jax_from_torch.hubert_from_fairseq)
    jax_tree = jax.tree.map(np.asarray, jax_convert(_numpy(sd), SMALL_LARGE))
    _assert_trees_equal(got, speechclip_params_from_jax({"audio_encoder": jax_tree})[
        "audio_encoder"])


def test_load_pretrained_reads_a_fairseq_hubert_large_file(tmp_path):
    """A ``{"model": state_dict, "cfg": ...}`` fairseq file of the large
    layout, named by ``audio_pretrained_path``, loads into the model's
    HuBERT, cast as ``cast_params`` casts."""
    from speechclip_tpu_torch import tiny_config
    from speechclip_tpu_torch.models.speechclip import SpeechCLIPModel
    from speechclip_tpu_torch.training.optim import tree_leaves

    _, pae, _ = towers(SMALL_LARGE, 400, np.array([400], np.int32), seed=5)
    ae = pae[torch.float32]
    torch.save({"model": large_hubert_sd(ae, "fairseq"), "cfg": {}}, tmp_path / "large.pt")
    cfg = dataclasses.replace(tiny_config(), audio=port_hubert_config(SMALL_LARGE),
                              audio_pretrained_path=str(tmp_path / "large.pt"))
    model = SpeechCLIPModel(cfg, device="cpu")
    params, _ = model.init(0)
    loaded = model.load_pretrained(cast_params(params, model.compute_dtype, "cpu"))
    keyed = lambda tree: {jax.tree_util.keystr(path): leaf for path, leaf
                          in jax.tree_util.tree_flatten_with_path(tree)[0]}
    want = keyed(cast_params(ae, model.compute_dtype, "cpu"))
    got = keyed(loaded["audio_encoder"])
    assert got.keys() == want.keys() and len(got) == len(list(tree_leaves(ae)))
    assert all(got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]) for k in want)
