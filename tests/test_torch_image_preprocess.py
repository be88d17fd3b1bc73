"""The port's image preprocessing (``data/image.py``) against the JAX
package's: ``device_clip_preprocess`` on uint8 batches (square, wide, tall
and an upscale), and the PIL host loaders on PNGs this test writes.

Tolerance: ``device_clip_preprocess`` max abs diff <= 1e-4 in normalized
units (f32 resize weights summed in another order). A resize without
antialiasing (``F.interpolate``'s default) is 0.1-0.25 of the pixel range
off JAX's at these sizes; a planted ``antialias=False`` must fail the same
check. The host loaders run the same PIL calls on both sides: equal.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from speechclip_tpu.data import image as jax_image
from speechclip_tpu_torch.data import image as port_image

torch.set_num_threads(2)

ATOL = 1e-4
SIZES = [(256, 256), (200, 300), (256, 384), (180, 180)]


def check_against_jax(hw, seed):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    want = np.asarray(jax_image.device_clip_preprocess(jnp.asarray(images)))
    got = port_image.device_clip_preprocess(torch.from_numpy(images))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (2, 224, 224, 3)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= ATOL, err


@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_device_clip_preprocess_matches_jax(hw):
    check_against_jax(hw, seed=sum(hw))


def test_a_planted_resize_without_antialiasing_fails(monkeypatch):
    real = F.interpolate

    def no_antialias(*args, **kwargs):
        return real(*args, **dict(kwargs, antialias=False))

    monkeypatch.setattr(port_image.F, "interpolate", no_antialias)
    with pytest.raises(AssertionError):
        check_against_jax((256, 256), seed=512)


def test_device_clip_preprocess_other_sizes_and_constants():
    """A 32-pixel tower's crop of a wide image, and the CLIP constants."""
    np.testing.assert_array_equal(port_image.CLIP_IMAGE_MEAN, jax_image.CLIP_IMAGE_MEAN)
    np.testing.assert_array_equal(port_image.CLIP_IMAGE_STD, jax_image.CLIP_IMAGE_STD)
    images = np.random.default_rng(1).integers(0, 256, (3, 40, 52, 3), dtype=np.uint8)
    want = np.asarray(jax_image.device_clip_preprocess(jnp.asarray(images), 32))
    got = port_image.device_clip_preprocess(torch.from_numpy(images), 32).numpy()
    assert got.shape == want.shape == (3, 32, 32, 3)
    assert np.abs(got - want).max() <= ATOL


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    pil = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(2)
    paths = []
    for i, (h, w) in enumerate([(40, 30), (64, 64), (33, 50)]):
        path = tmp_path_factory.mktemp("png") / f"{i}.png"
        pil.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(path)
        paths.append(str(path))
    return paths


@pytest.mark.parametrize("loader, kwargs", [
    ("load_image", dict(size=24)),
    ("load_image_raw", dict(decode_size=28)),
])
def test_host_loaders_match_jax(pngs, loader, kwargs):
    for path in pngs:
        want = getattr(jax_image, loader)(path, **kwargs)
        got = getattr(port_image, loader)(path, **kwargs)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_pil_transforms_match_jax(pngs):
    from PIL import Image

    for path in pngs:
        with Image.open(path) as img:
            np.testing.assert_array_equal(port_image.clip_preprocess_pil(img, 20),
                                          jax_image.clip_preprocess_pil(img, 20))
            np.testing.assert_array_equal(port_image.simple_image_transform(img, 18, 26),
                                          jax_image.simple_image_transform(img, 18, 26))
            np.testing.assert_array_equal(port_image.simple_image_transform(img, 18),
                                          jax_image.simple_image_transform(img, 18))
