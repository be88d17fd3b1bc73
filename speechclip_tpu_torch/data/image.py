"""Image preprocessing (port of speechclip_tpu/data/image.py): the CLIP
preprocess contract (bicubic shorter-side resize -> center crop -> RGB
float -> per-channel normalize).

- host path: PIL decode and resize per image (``clip_preprocess_pil``,
  ``load_image``, ``simple_image_transform``); PIL is imported inside each
  loader, so the package imports without it;
- device path: ``load_image_raw`` decodes to a fixed uint8 square on the
  host, then ``device_clip_preprocess`` resizes and normalizes a batch on
  the images' device.

``jax.image.resize(..., "bicubic")`` antialiases when it shrinks (its kernel
is stretched by the scale) and uses the Keys cubic with a = -0.5;
``F.interpolate(mode="bicubic")`` does neither unless ``antialias=True``
(then it takes the same kernel). Without it the two differ by up to a
quarter of the pixel range at 256 -> 224.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

CLIP_IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def clip_preprocess_pil(img, size: int = 224) -> np.ndarray:
    """PIL image -> normalized float32 (size, size, 3)."""
    from PIL import Image

    img = img.convert("RGB")
    w, h = img.size
    scale = size / min(w, h)
    new_w, new_h = int(round(w * scale)), int(round(h * scale))
    img = img.resize((new_w, new_h), Image.BICUBIC)
    left = (new_w - size) // 2
    top = (new_h - size) // 2
    img = img.crop((left, top, left + size, top + size))
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - CLIP_IMAGE_MEAN) / CLIP_IMAGE_STD


def load_image(path: str, size: int = 224) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as img:
        return clip_preprocess_pil(img, size)


def load_image_raw(path: str, decode_size: int = 256) -> np.ndarray:
    """Decode + a cheap bilinear shorter-side resize + center crop to a
    uint8 (decode_size, decode_size, 3) square on the host, so batches
    stack; the resize and normalize then run batched on the device."""
    from PIL import Image

    with Image.open(path) as img:
        img = img.convert("RGB")
        w, h = img.size
        scale = decode_size / min(w, h)
        img = img.resize((int(round(w * scale)), int(round(h * scale))), Image.BILINEAR)
        left = (img.size[0] - decode_size) // 2
        top = (img.size[1] - decode_size) // 2
        img = img.crop((left, top, left + decode_size, top + decode_size))
        return np.asarray(img, np.uint8)


def device_clip_preprocess(images_uint8: torch.Tensor, size: int = 224) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, size, size, 3) f32 on the images' device:
    x / 255, an antialiased bicubic resize of the shorter side to ``size``,
    the center crop at JAX's offsets, then (x - mean) / std."""
    x = images_uint8.float() / 255.0
    _, h, w, _ = x.shape
    scale = size / min(h, w)
    new_h, new_w = int(round(h * scale)), int(round(w * scale))
    x = F.interpolate(x.permute(0, 3, 1, 2), size=(new_h, new_w), mode="bicubic",
                      antialias=True, align_corners=False)
    top, left = (new_h - size) // 2, (new_w - size) // 2
    x = x[:, :, top:top + size, left:left + size].permute(0, 2, 3, 1)
    mean = torch.from_numpy(CLIP_IMAGE_MEAN).to(x.device)
    std = torch.from_numpy(CLIP_IMAGE_STD).to(x.device)
    return (x - mean) / std


def simple_image_transform(img, h: int, w: int = -1) -> np.ndarray:
    """Bilinear resize to (h, w) + to float in [0, 1] (the reference's
    alternative transform)."""
    from PIL import Image

    if w <= 0:
        w = h
    img = img.convert("RGB").resize((w, h), Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0
