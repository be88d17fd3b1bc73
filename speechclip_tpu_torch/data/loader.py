"""Bucketed batch loader (port of speechclip_tpu/data/loader.py; its
batches are bitwise those of the JAX package's loader on the same dataset
and seed).

- every batch's waveform buffer is one of a small fixed set of bucket
  lengths (multiples of 3200 samples, 0.2 s), so a bucket's batches share
  one shape;
- train mode random-crops to ``max_audio_len`` first, then buckets;
- samples are decoded in a thread pool (the native batch decode of
  ``data/native.py`` where the library loads) and assembled into numpy
  buffers; lengths ride along for masking. The trainer stages them on the
  card (``training/train_step.device_prefetch``).

``np.random.default_rng(seed + epoch)`` draws the shuffles and crops in the
JAX loader's order: the bucket shuffles, the plan shuffle, then one child
generator per batch.
"""

from __future__ import annotations

import concurrent.futures as cf
import logging
import math
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)

from ..utils import tracing
from .audio import random_crop_max_length


def make_buckets(
    lengths: Sequence[int],
    max_len: Optional[int] = None,
    num_buckets: int = 4,
    multiple: int = 3200,
) -> List[int]:
    """Quantile-based bucket boundaries rounded up to `multiple` (0.2 s)."""
    arr = np.asarray(lengths)
    if max_len:
        arr = np.minimum(arr, max_len)
    qs = np.quantile(arr, np.linspace(1.0 / num_buckets, 1.0, num_buckets))
    buckets = sorted(
        {int(math.ceil(q / multiple) * multiple) for q in qs}
    )
    return buckets


def bucket_for(length: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


class BucketedLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        buckets: Optional[Sequence[int]] = None,
        max_audio_len: int = -1,
        train: bool = False,
        seed: int = 7122,
        num_workers: int = 8,
        drop_last: Optional[bool] = None,
        num_bucket_groups: int = 4,
        compact_wav: bool = False,
        skip_images: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.train = train
        self.max_audio_len = max_audio_len if train else -1
        self.seed = seed
        self.num_workers = num_workers
        self.drop_last = train if drop_last is None else drop_last
        # ship wav as int16 PCM (half the H2D bytes; the model rescales on
        # device). Exact for PCM16 sources: f32 = pcm/32768 round-trips.
        self.compact_wav = compact_wav
        # don't decode/ship images at all (trainer.cache_image_features:
        # the trainer swaps in precomputed frozen-tower features per batch)
        self.skip_images = skip_images
        self.epoch = 0

        self._lengths = np.array(
            [dataset.wav_length(i) for i in range(len(dataset))]
        )
        if buckets is None:
            buckets = make_buckets(
                self._lengths,
                max_len=self.max_audio_len if self.max_audio_len > 0 else None,
                num_buckets=num_bucket_groups,
            )
        self.buckets = list(buckets)

        # bucket membership is fixed once lengths/max_audio_len/buckets are
        # (all set above): precompute it vectorized instead of re-running an
        # O(num_buckets x N) python scan on every __iter__ AND __len__ call
        # (~2.4M bucket_for calls per SpokenCOCO epoch before this).
        # searchsorted(left) == bucket_for: first bucket >= length, clamped.
        eff = self._lengths
        if self.max_audio_len > 0:
            eff = np.minimum(eff, self.max_audio_len)
        barr = np.asarray(self.buckets)
        pos = np.minimum(
            np.searchsorted(barr, eff, side="left"), len(barr) - 1
        )
        self._bucket_members = {
            int(b): np.flatnonzero(pos == k).astype(np.int64)
            for k, b in enumerate(self.buckets)
        }

    def __len__(self) -> int:
        # read sizes off the precomputed membership directly: the
        # _bucket_indices copy exists only for __iter__'s in-place shuffle
        sizes = (self._bucket_members[int(b)].size for b in self.buckets)
        if self.drop_last:
            return sum(s // self.batch_size for s in sizes)
        return sum(-(-s // self.batch_size) for s in sizes)

    def _bucket_indices(self, bucket: int) -> np.ndarray:
        # copy: __iter__ shuffles the returned array in place
        return self._bucket_members[int(bucket)].copy()

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(self.seed + self.epoch)
        self.epoch += 1

        plans = []  # (bucket_len, indices)
        for b in self.buckets:
            idx = self._bucket_indices(b)
            if self.train:
                rng.shuffle(idx)
            for s in range(0, len(idx), self.batch_size):
                chunk = idx[s : s + self.batch_size]
                if len(chunk) < self.batch_size and self.drop_last:
                    continue
                plans.append((b, chunk))
        if self.train:
            rng.shuffle(plans)

        # np.random.Generator is not thread-safe: give each (double-buffered)
        # _assemble call its own child generator
        plan_rngs = [np.random.default_rng(seq) for seq in rng.spawn(len(plans))]

        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            # double-buffer: assemble batch k+1 while k is consumed
            pending = None
            for plan, plan_rng in zip(plans, plan_rngs):
                fut = pool.submit(self._assemble, plan, plan_rng)
                if pending is not None:
                    yield self._wait(pending)
                pending = fut
            if pending is not None:
                yield self._wait(pending)

    @staticmethod
    def _wait(pending: cf.Future) -> Dict[str, np.ndarray]:
        with tracing.span("speechclip.loader.wait"):
            return pending.result()

    def _assemble(self, plan, rng) -> Dict[str, np.ndarray]:
        with tracing.span("speechclip.loader.assemble"):
            return self._assemble_batch(plan, rng)

    def _assemble_batch(self, plan, rng) -> Dict[str, np.ndarray]:
        bucket_len, indices = plan
        entries = [self.dataset.data[int(i)] for i in indices]
        n = len(entries)

        # native fast path: threaded C++ decode straight into the batch
        # buffer (native/wavio.cc); python per-sample decode otherwise
        from . import native as native_mod

        use_native = native_mod.available() and all(
            "wav" in e for e in entries
        )
        if use_native:
            offsets = None
            if self.train and self.max_audio_len > 0:
                # random crop: offset in [0, len - crop), as
                # random_crop_max_length draws it
                full = np.minimum(self._lengths[indices], 10**12)
                crop = np.minimum(full, self.max_audio_len)
                room = np.maximum(full - crop, 0)
                offsets = np.array(
                    [rng.integers(0, r) if r > 0 else 0 for r in room],
                    np.int64,
                )
            try:
                with tracing.span("speechclip.loader.decode"):
                    wav, wav_len = native_mod.decode_wav_batch(
                        [e["wav"] for e in entries],
                        max_len=bucket_len,
                        target_sr=self.dataset.target_sr,
                        offsets=offsets,
                    )
            except RuntimeError as e:
                # one exotic/malformed WAV in the batch (IEEE-float,
                # 24-bit, WAVE_FORMAT_EXTENSIBLE): the documented contract
                # is python fallback (native/wavio.cc:21-22) — wav_length()
                # already falls back at dataset construction; do the same
                # here per batch instead of crashing mid-epoch
                logger.warning(
                    "native wav decode failed (%s); python fallback for "
                    "this batch", e
                )
                use_native = False
        if use_native:
            if self.max_audio_len > 0:
                with tracing.span("speechclip.loader.mask"):
                    clip = np.minimum(wav_len, self.max_audio_len)
                    mask = (
                        np.arange(bucket_len)[None, :] < clip[:, None]
                    )
                    wav = np.where(mask, wav, 0.0).astype(np.float32)
                    wav_len = clip
            batch: Dict[str, np.ndarray] = {
                "wav": wav,
                "wav_len": wav_len.astype(np.int32),
                "id": np.array([e["id"] for e in entries], np.int64),
            }
            # image fast path: one threaded C++ JPEG batch decode
            # (native/jpegio.cc) instead of per-sample PIL
            native_jpeg = (
                "image" in entries[0]
                and not self.skip_images
                and getattr(self.dataset, "image_mode", None) == "raw"
                and native_mod.has_jpeg()
                and all(
                    str(e.get("image", "")).lower().endswith((".jpg", ".jpeg"))
                    for e in entries
                )
            )
            if native_jpeg:
                try:
                    batch["image"] = native_mod.decode_jpeg_batch(
                        [e["image"] for e in entries],
                        self.dataset.raw_decode_size,
                    )
                except RuntimeError as e:
                    # e.g. CMYK/YCCK or corrupt files libjpeg cannot convert;
                    # PIL handles more encodings — fall back for this batch
                    logger.warning("native jpeg decode failed (%s); PIL fallback", e)
                    native_jpeg = False
            if "image" in entries[0] or "text" in entries[0]:
                samples = [
                    self.dataset.get_item(
                        int(i),
                        skip_wav=True,
                        skip_image=native_jpeg or self.skip_images,
                    )
                    for i in indices
                ]
            else:
                samples = [{} for _ in indices]
        else:
            with tracing.span("speechclip.loader.decode"):
                samples = [
                    self.dataset.get_item(int(i), skip_image=self.skip_images)
                    for i in indices
                ]
            batch = {
                "wav": np.zeros((n, bucket_len), np.float32),
                "wav_len": np.zeros((n,), np.int32),
                "id": np.zeros((n,), np.int64),
            }
            for j, s in enumerate(samples):
                wav = s["wav"]
                if self.train and self.max_audio_len > 0:
                    wav = random_crop_max_length(
                        wav, self.max_audio_len, rng=rng
                    )
                wav = wav[:bucket_len]
                batch["wav"][j, : len(wav)] = wav
                batch["wav_len"][j] = len(wav)
                batch["id"][j] = s["id"]

        has_image = bool(samples) and "image" in samples[0]
        has_text = (
            bool(samples)
            and "text" in samples[0]
            and not isinstance(samples[0]["text"], str)
        )
        if has_image:
            imgs = np.stack([s["image"] for s in samples])
            # raw uint8 stays uint8 (device-side preprocess); else float32
            batch["image"] = (
                imgs if imgs.dtype == np.uint8 else imgs.astype(np.float32)
            )
        if has_text:
            batch["text"] = np.stack([s["text"] for s in samples]).astype(
                np.int64
            )
        if self.compact_wav:
            with tracing.span("speechclip.loader.mask"):
                batch["wav"] = np.clip(
                    np.round(batch["wav"].astype(np.float64) * 32768.0),
                    -32768,
                    32767,
                ).astype(np.int16)
        return batch
