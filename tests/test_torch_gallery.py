"""The gallery side of the port against the JAX package: the ViT image
tower (``models/clip.py`` ``encode_image``), the model's ``forward_image``
/ ``encode_image_tower`` / ``project_image_feat`` / ``forward_text``,
``clip.get_scores``, the CLIP towers carried by convert.from_jax, the
attention routes of the four towers, and ``init``'s draw order.

The tiny config is ``flagship_tiny_config()`` (a 32 x 32 image, 8 x 8
patches, width 32, 2 layers, 4 heads; both branches live) with an image
projection (16 -> 16) set, from ONE JAX ``init`` carried over by
convert.from_jax. Where the JAX side dispatches, it does so as on one TPU
(``_on_tpu`` monkeypatched, a one-device kernel mesh, the Pallas kernels in
interpret mode; tests/test_torch_attention.py's ``jax_kernels``), and the
kernels it called are asserted beside the port's route.

Tolerances: f32 — max abs diff <= 1e-4. bf16 — per-row cosine >= 0.999
(the JAX XLA path rounds in other places than the port's plain layers).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speechclip_tpu.config import ConfigNode, flagship_tiny_config
from speechclip_tpu.kernels.mha_block import mha_block as jax_mha_block
from speechclip_tpu.models import clip as jax_clip
from speechclip_tpu.models.speechclip import SpeechCLIPModel as JaxModel
from speechclip_tpu.ops import attention as jattn
from speechclip_tpu_torch import config as port_config
from speechclip_tpu_torch.convert.from_jax import speechclip_params_from_jax
from speechclip_tpu_torch.kernels.mha_block import mha_layer_block_plain
from speechclip_tpu_torch.models import branches, clip as port_clip, hubert
from speechclip_tpu_torch.models.speechclip import SpeechCLIPModel, cast_params
from speechclip_tpu_torch.ops import attention as pattn
from speechclip_tpu_torch.ops.mlp import mlp_init
from speechclip_tpu_torch.ops.weighted_sum import weighted_sum_init
from tests.test_torch_attention import jax_kernels  # noqa: F401  (fixture)
from tests.test_torch_config import port_config_from_jax
from tests.test_torch_slice import _row_cosine

torch.set_num_threads(2)

F32_ATOL = 1e-4
MIN_COSINE = 0.999
B = 3


def jax_config(precision):
    cfg = flagship_tiny_config()
    cfg.trainer.precision = precision
    cfg.model_settings.image_encoder_projection = ConfigNode({"dimensions": [16, 16]})
    return cfg


@pytest.fixture(scope="module")
def setup():
    jparams, _ = jax.jit(JaxModel(jax_config(32)).init)(jax.random.key(0))
    rng = np.random.default_rng(11)
    return dict(
        jparams=jparams,
        pparams=speechclip_params_from_jax(jax.tree.map(np.asarray, jparams)),
        images=rng.standard_normal((B, 32, 32, 3)).astype(np.float32),
        uint8=rng.integers(0, 256, (B, 40, 52, 3), dtype=np.uint8),
        text=rng.integers(0, 62, (B, 77)).astype(np.int32),
        eot=np.array([76, 9, 40], np.int32),
    )


def _models(setup, precision):
    cfg = jax_config(precision)
    pm = SpeechCLIPModel(port_config_from_jax(cfg), device="cpu")
    return JaxModel(cfg), pm, cast_params(setup["pparams"], pm.compute_dtype, device="cpu")


def assert_agrees(got: torch.Tensor, want, precision):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    if precision == 32:
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    else:
        assert _row_cosine(got.reshape(-1, got.shape[-1]),
                           want.reshape(-1, want.shape[-1])).min() >= MIN_COSINE


@pytest.mark.parametrize("backend", ["auto", "pallas"])
@pytest.mark.parametrize("precision", [32, 16])
def test_vit_encode_image_matches_jax(setup, jax_kernels, precision, backend):
    """Both towers' layers take the same route: "sdpa" under "auto" (17
    rows are under every gate), ``flash_attention`` under "pallas"."""
    jm, pm, pparams = _models(setup, precision)
    images = setup["images"]
    with jattn.attention_backend(backend):
        want = jax.jit(lambda p, x: jax_clip.encode_image(p, jm.clip_cfg, x))(
            setup["jparams"]["clip"], jnp.asarray(images).astype(jm.compute_dtype))
    called = list(jax_kernels)
    with pattn.attention_backend(backend):
        got = port_clip.encode_image(pparams["clip"], pm.vision_cfg,
                                     torch.from_numpy(images).to(pm.compute_dtype))
    v = pm.vision_cfg
    rows = (v.image_size // v.patch_size) ** 2 + 1
    route = pattn.attention_route(B, rows, rows, v.width, v.heads, 4 if precision == 32 else 2,
                                  backend=backend)
    assert route == {"auto": "sdpa", "pallas": "flash_attention"}[backend]
    assert called == ([] if route == "sdpa" else [route] * v.layers)
    assert got.dtype == pm.compute_dtype and tuple(got.shape) == (B, 16)
    assert_agrees(got, want, precision)


@pytest.mark.parametrize("precision", [32, 16])
def test_vit_b32_resblock_at_full_width_matches_jax(precision):
    """One ViT-B/32 resblock (B = 2, 50 rows, 768 wide, 12 heads) against
    the JAX XLA path."""
    rng = np.random.default_rng(50)
    block = jax.tree.map(np.asarray, jax_clip._block_init(jax.random.key(1), 768, 3072))
    block = jax.tree.map(  # non-trivial LayerNorms and biases
        lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32) if a.ndim == 1
        else a, block)
    x = rng.standard_normal((2, 50, 768)).astype(np.float32)
    jdt = jnp.float32 if precision == 32 else jnp.bfloat16
    want = jax.jit(lambda p, x: jax_clip._resblock(p, x, 12, False))(
        jax.tree.map(jnp.asarray, block), jnp.asarray(x).astype(jdt))
    tdt = torch.float32 if precision == 32 else torch.bfloat16
    pblock = cast_params(jax.tree.map(lambda a: torch.from_numpy(np.array(a)), block), tdt,
                         device="cpu")
    got = port_clip._resblock(pblock, torch.from_numpy(x).to(tdt), 12, False)
    assert got.dtype == tdt
    assert_agrees(got, want, precision)


# (rows, width, heads, causal) of each tower's layers, and their route under
# "auto" and "pallas" in bf16 at B = 64 and 256
TOWER_ROUTES = {
    "ViT-B/32": ((50, 768, 12, False), "sdpa"),
    "ViT-B/16": ((197, 768, 12, False), "mha_block"),
    "ViT-L/14": ((257, 1024, 16, False), "mha_block"),
    "text": ((77, 512, 8, True), "sdpa"),
}
JAX_KERNEL = {"mha_block": "mha_block", "attention_vmem": "attention_vmem",
              "flash_attention": "flash_attention", "sdpa": None}


@pytest.mark.parametrize("backend", ["auto", "pallas"])
@pytest.mark.parametrize("tower", sorted(TOWER_ROUTES))
def test_tower_route_table(jax_kernels, tower, backend):
    """The port's ``attention_route`` and the kernel JAX's dispatcher calls
    (traced with ``jax.eval_shape`` at the full shapes) name the same body."""
    (rows, width, heads, causal), auto = TOWER_ROUTES[tower]
    want = auto if backend == "auto" else "flash_attention"
    if tower != "text":
        v = port_config.NAMED_CLIP_CONFIGS[tower].vision
        assert (rows, width, heads) == ((v.image_size // v.patch_size) ** 2 + 1, v.width, v.heads)
    params = {"in_proj": {"w": jax.ShapeDtypeStruct((width, 3 * width), jnp.float32),
                          "b": jax.ShapeDtypeStruct((3 * width,), jnp.float32)},
              "out_proj": {"w": jax.ShapeDtypeStruct((width, width), jnp.float32),
                           "b": jax.ShapeDtypeStruct((width,), jnp.float32)}}
    for b in (64, 256):
        assert pattn.attention_route(b, rows, rows, width, heads, 2, causal=causal,
                                     backend=backend) == want
        jax_kernels.clear()
        x = jax.ShapeDtypeStruct((b, rows, width), jnp.bfloat16)
        with jattn.attention_backend(backend):
            jax.eval_shape(lambda p, x: jattn.multi_head_attention(p, x, x, x, heads,
                                                                   causal=causal), params, x)
        assert jax_kernels == ([JAX_KERNEL[want]] if JAX_KERNEL[want] else [])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mha_layer_block_none_at_vit_l14_rows_matches_jax(dtype):
    """``mha_layer_block_plain`` in "none" (ViT-L/14 under "auto": 257 rows,
    1024 wide, 16 heads, no key lengths) against the Pallas ``mha_block`` in
    interpret mode."""
    rng = np.random.default_rng(257)
    d, h = 1024, 16
    x = rng.standard_normal((2, 257, d)).astype(np.float32)
    mk = lambda *s: (rng.standard_normal(s) * s[0] ** -0.5).astype(np.float32)
    w_in, b_in, w_out, b_out = mk(d, 3 * d), 0.1 * mk(3 * d), mk(d, d), 0.1 * mk(d)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_mha_block(jnp.asarray(x).astype(jdt), *map(jnp.asarray, (w_in, b_in, w_out, b_out)),
                         None, h)
    t = lambda a: torch.from_numpy(a)
    got = mha_layer_block_plain(t(x).to(tdt), t(w_in).to(tdt), t(b_in), t(w_out).to(tdt),
                                t(b_out), None, None, None, h, "none", 1e-5)
    assert got.dtype == tdt
    assert_agrees(got, want, 32 if dtype == "float32" else 16)


@pytest.mark.parametrize("kind", ["float", "uint8"])
@pytest.mark.parametrize("precision", [32, 16])
def test_forward_image_matches_jax(setup, precision, kind):
    """Normalized float images, and uint8 images of another size that take
    ``device_clip_preprocess`` first; the tower, then ``img_enc_proj``."""
    jm, pm, pparams = _models(setup, precision)
    images = setup["images"] if kind == "float" else setup["uint8"]
    want = jax.jit(jm.forward_image)(setup["jparams"], jnp.asarray(images))
    got = pm.forward_image(pparams, torch.from_numpy(images))
    assert got.dtype == pm.compute_dtype and tuple(got.shape) == (B, 16)
    assert_agrees(got, want, precision)


@pytest.mark.parametrize("precision", [32, 16])
def test_encode_image_tower_and_project_image_feat_match_jax(setup, precision):
    jm, pm, pparams = _models(setup, precision)
    images = jnp.asarray(setup["images"])
    tower = jax.jit(jm.encode_image_tower)(setup["jparams"], images)
    got = pm.encode_image_tower(pparams, torch.from_numpy(setup["images"]))
    assert_agrees(got, tower, precision)
    feat = np.array(tower.astype(jnp.float32))
    want = jax.jit(jm.project_image_feat)(setup["jparams"], jnp.asarray(feat).astype(tower.dtype))
    got = pm.project_image_feat(pparams, torch.from_numpy(feat).to(pm.compute_dtype))
    assert_agrees(got, want, precision)
    no_proj = {k: v for k, v in pparams.items() if k != "img_enc_proj"}
    assert pm.project_image_feat(no_proj, got) is got


@pytest.mark.parametrize("eot", [True, False])
@pytest.mark.parametrize("precision", [32, 16])
def test_forward_text_matches_jax(setup, precision, eot):
    """77 token ids through the causal text tower, pooled at the given EOT
    positions, or at ``argmax`` of the ids without them."""
    jm, pm, pparams = _models(setup, precision)
    text, pos = setup["text"], setup["eot"] if eot else None
    want = jax.jit(jm.forward_text)(setup["jparams"], jnp.asarray(text),
                                    None if pos is None else jnp.asarray(pos))
    got = pm.forward_text(pparams, torch.from_numpy(text),
                          None if pos is None else torch.from_numpy(pos))
    # the tower runs in the token table's dtype, f32 at every precision in
    # both packages (cast_params keeps the whole text tower f32, as the JAX
    # model keeps its params), so f32's tolerance holds at both precisions
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert tuple(got.shape) == (B, 16)
    assert_agrees(got, want, 32)


@pytest.mark.parametrize("precision", [32, 16])
def test_forward_text_under_pallas_matches_jax(setup, jax_kernels, precision):
    """Under "pallas" both packages run each causal text layer through
    ``flash_attention`` in f32 (JAX's Pallas kernel in interpret mode; the
    port's plain version of the f32 form here on the CPU)."""
    jm, pm, pparams = _models(setup, precision)
    text, pos = setup["text"], setup["eot"]
    with jattn.attention_backend("pallas"):
        want = jax.jit(jm.forward_text)(setup["jparams"], jnp.asarray(text), jnp.asarray(pos))
    assert list(jax_kernels) == ["flash_attention"] * pm.clip_cfg.layers
    with pattn.attention_backend("pallas"):
        got = pm.forward_text(pparams, torch.from_numpy(text), torch.from_numpy(pos))
    assert pattn.attention_route(B, 77, 77, pm.clip_cfg.width, pm.clip_cfg.heads, 4,
                                 causal=True, backend="pallas") == "flash_attention"
    assert got.dtype == torch.float32
    assert_agrees(got, want, 32)


def test_cast_params_keeps_the_text_tower_f32(setup):
    """At precision 16 the whole CLIP text tower stays f32; the cascaded
    branch's bf16 pass through it (``encode_keywords``) casts each weight
    where it is used, so it gives bit for bit what bf16-cast weights give."""
    p16 = cast_params(setup["pparams"], torch.bfloat16, device="cpu")
    assert all(t.dtype == torch.float32 for t in jax.tree.leaves(p16["clip"]["text"]))
    assert p16["clip"]["visual"]["proj"].dtype == torch.bfloat16
    text32 = p16["clip"]["text"]
    text16 = jax.tree.map(lambda t: t.bfloat16() if t.dim() >= 2 else t, text32)
    text16["token_embedding"] = text32["token_embedding"]
    cfg = port_config_from_jax(jax_config(16)).clip_text
    kw = text32["token_embedding"][torch.tensor([[5, 9, 11], [1, 40, 60]])].bfloat16()
    got = port_clip.encode_keywords({"text": text32}, cfg, kw, 60, 61)
    want = port_clip.encode_keywords({"text": text16}, cfg, kw, 60, 61)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.parametrize("precision", [32, 16])
def test_get_scores_matches_jax(setup, precision):
    jm, pm, pparams = _models(setup, precision)
    images = setup["images"]
    want = jax.jit(lambda p, x, t, e: jax_clip.get_scores(p, jm.clip_cfg, x, t, e))(
        setup["jparams"]["clip"], jnp.asarray(images).astype(jm.compute_dtype),
        jnp.asarray(setup["text"]), jnp.asarray(setup["eot"]))
    got = port_clip.get_scores(pparams["clip"], pm.vision_cfg, pm.clip_cfg,
                               torch.from_numpy(images).to(pm.compute_dtype),
                               torch.from_numpy(setup["text"]), torch.from_numpy(setup["eot"]))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        # logits are 100 x a cosine: the features' tolerance scaled by 100
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-4 if precision == 32 else 0.5)
    torch.testing.assert_close(got[1], got[0].T, rtol=0, atol=0)


def test_from_jax_carries_the_clip_towers_by_value(setup):
    """conv1 turns HWIO -> OIHW; square linear weights (a block's
    out-projection, the image projection) copy straight across, so a
    transposed copy fails here; ``logit_scale`` and the text tower come
    along; the loss temperature does not."""
    jp, pp = jax.tree.map(np.asarray, setup["jparams"]), setup["pparams"]
    jv, pv = jp["clip"]["visual"], pp["clip"]["visual"]
    np.testing.assert_array_equal(jv["conv1"]["w"].transpose(3, 2, 0, 1), pv["conv1"]["w"].numpy())
    assert tuple(pv["conv1"]["w"].shape) == (32, 3, 8, 8)
    for jb, pb in zip(jv["blocks"], pv["blocks"]):
        w = jb["attn"]["out_proj"]["w"]
        assert w.shape[0] == w.shape[1] and not np.allclose(w, w.T)
        np.testing.assert_array_equal(w, pb["attn"]["out_proj"]["w"].numpy())
    for key in ("class_embedding", "positional_embedding", "proj"):
        np.testing.assert_array_equal(jv[key], pv[key].numpy())
    w = jp["img_enc_proj"]["layers"][0]["w"]
    assert w.shape == (16, 16) and not np.allclose(w, w.T)
    np.testing.assert_array_equal(w, pp["img_enc_proj"]["layers"][0]["w"].numpy())
    assert float(pp["clip"]["logit_scale"]) == float(jp["clip"]["logit_scale"]) == pytest.approx(
        np.log(1 / 0.07))
    np.testing.assert_array_equal(jp["clip"]["text"]["text_projection"],
                                  pp["clip"]["text"]["text_projection"].numpy())
    assert "criterion" in jp and "criterion" not in pp


def _speech_side_init(model, seed):
    """The port's ``init`` as it drew before the CLIP image tower was added:
    the speech side, and the text tower for the cascaded branch only."""
    cfg, gen = model.config, torch.Generator().manual_seed(seed)
    params = {"audio_encoder": hubert.hubert_init(gen, model.audio_cfg)}
    params["weighted_sum"] = weighted_sum_init(model.audio_cfg.num_hidden_states, model.device)
    if model.use_cascaded:
        params["clip"] = {"text": port_clip.text_init(gen, model.clip_cfg)}
        params["cascaded_branch"], _ = branches.cascaded_branch_init(
            gen, cfg.cascaded_branch, model.audio_cfg.encoder_embed_dim, model.clip_cfg.width,
            params["clip"]["text"]["token_embedding"])
    if model.use_parallel:
        params["parallel_branch"] = branches.parallel_branch_init(
            gen, cfg.parallel_branch, model.audio_cfg.encoder_embed_dim, cfg.clip_embed_dim)
    for key, dims in (("p_branch_proj", cfg.parallel_branch_projection),
                      ("c_branch_proj", cfg.cascaded_branch_projection)):
        if dims is not None:
            params[key] = mlp_init(gen, dims)
    return params


@pytest.mark.parametrize("preset", ["tiny", "tiny_flagship"])
def test_speech_side_init_is_unchanged_by_the_towers(preset):
    """A seed's speech-side params (and the cascaded branch's text tower)
    are bit for bit what the draw order before the image tower gave; the
    towers and the image projection draw after them."""
    cfg = dataclasses.replace(
        getattr(port_config, f"{preset}_config")(), parallel_branch_projection=(16, 16),
        cascaded_branch_projection=(16, 16), image_encoder_projection=(16, 16))
    model = SpeechCLIPModel(cfg, device="cpu")
    params, _ = model.init(5)
    want = _speech_side_init(model, 5)
    got = {k: v for k, v in params.items() if k in want}
    got["clip"] = {"text": params["clip"]["text"]}
    if "clip" not in want:
        del got["clip"]
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert all(torch.equal(a, b) for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)))
    assert set(params["clip"]) == {"visual", "text", "logit_scale"} and "img_enc_proj" in params
