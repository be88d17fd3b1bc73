"""The port's ModifiedResNet image tower (``models/clip.py``, the RN names)
against the JAX package's ``encode_image`` at tiny RN dims (width 8, one
bottleneck a stage, 64 x 64 images, 4 attnpool heads), from ONE JAX
``clip_init`` carried over by convert.from_jax with random BatchNorm
running statistics (scale, bias, mean, var) on both sides; the named RN
presets' shapes, built at full width by the port's own init, against the
JAX init's (traced only).

Tolerances: f32 — max abs diff <= 1e-4 on the features (the same math;
another summation order). bf16 — per-row cosine >= 0.999 (the rounding
points are JAX's: convs summed in f32 and rounded once, BN folded to an f32
scale and bias cast to bf16, the average pool summed in f32, the pool's
logits and softmax in f32 with the weights rounded to bf16; XLA's CPU
fusions may keep other intermediates in f32).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from speechclip_tpu.models import clip as jax_clip
from speechclip_tpu_torch import config as port_config
from speechclip_tpu_torch.convert.from_jax import speechclip_params_from_jax
from speechclip_tpu_torch.models import clip as port_clip
from speechclip_tpu_torch.models.speechclip import cast_params
from tests.test_torch_slice import _row_cosine

torch.set_num_threads(2)

TINY_RN = jax_clip.CLIPConfig(
    vision=jax_clip.CLIPResNetVisionConfig(image_size=64, width=8, layers=(1, 1, 1, 1),
                                           heads=4, output_dim=16),
    text=jax_clip.CLIPTextConfig(vocab_size=64, width=32, layers=1, heads=4, output_dim=16),
)
PORT_TINY_RN = port_config.CLIPResNetVisionConfig(image_size=64, width=8, layers=(1, 1, 1, 1),
                                                  heads=4, output_dim=16)


def _randomize_bn(tree, rng):
    """Every BatchNorm dict (scale, bias, mean, var) gets random values."""
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias", "mean", "var"}:
            n = tree["scale"].shape
            return {"scale": (1 + 0.2 * rng.standard_normal(n)).astype(np.float32),
                    "bias": (0.1 * rng.standard_normal(n)).astype(np.float32),
                    "mean": (0.1 * rng.standard_normal(n)).astype(np.float32),
                    "var": rng.uniform(0.5, 2.0, n).astype(np.float32)}
        return {k: _randomize_bn(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_randomize_bn(v, rng) for v in tree]
    return tree


@pytest.fixture(scope="module")
def resnet():
    jparams = jax.tree.map(np.asarray, jax.jit(lambda k: jax_clip.clip_init(k, TINY_RN))(
        jax.random.key(3)))
    rng = np.random.default_rng(3)
    jparams = dict(jparams, visual=_randomize_bn(jparams["visual"], rng))
    images = rng.standard_normal((3, 64, 64, 3)).astype(np.float32)
    return jparams, speechclip_params_from_jax({"clip": jparams})["clip"], images


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resnet_encode_image_matches_jax(resnet, dtype):
    jparams, pparams, images = resnet
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax.jit(lambda p, x: jax_clip.encode_image(p, TINY_RN, x))(
        jax.tree.map(jnp.asarray, jparams), jnp.asarray(images).astype(jdt))
    want = np.asarray(want.astype(jnp.float32))
    got = port_clip.encode_image(cast_params(pparams, tdt, device="cpu"), PORT_TINY_RN,
                                 torch.from_numpy(images).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == want.shape == (3, 16)
    got = got.float().numpy()
    assert np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    else:
        assert _row_cosine(got, want).min() >= 0.999


def test_resnet_conv_kernels_turn_to_oihw(resnet):
    """The stem's and a bottleneck's convs (HWIO -> OIHW), by value."""
    jparams, pparams, _ = resnet
    for path in (("stem", "conv1"), ("layer1", 0, "conv2"), ("layer2", 0, "downsample", "conv")):
        j, p = jparams["visual"], pparams["visual"]
        for key in path:
            j, p = j[key], p[key]
        np.testing.assert_array_equal(j["w"].transpose(3, 2, 0, 1), p["w"].numpy())


@pytest.mark.parametrize("name", ["RN50", "RN101", "RN50x4"])
def test_named_resnet_init_shapes_match_jax(name):
    """The port's own init of a named RN tower at full width builds the JAX
    init's tree of shapes (OIHW convs)."""
    want = jax.eval_shape(lambda k: jax_clip.clip_init(k, jax_clip.NAMED_CONFIGS[name]),
                          jax.random.key(0))["visual"]
    oihw = lambda s: (s[3], s[2], s[0], s[1]) if len(s) == 4 else tuple(s)
    own = port_clip.vision_init(torch.Generator().manual_seed(0),
                                port_config.NAMED_CLIP_CONFIGS[name].vision)
    assert (jax.tree.map(lambda t: tuple(t.shape), own)
            == jax.tree.map(lambda a: oihw(a.shape), want))
