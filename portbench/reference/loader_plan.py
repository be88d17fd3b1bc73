"""The train batches the trainer should see, worked out again from the
corpus on disk: a frozen, independent copy of what Flickr8k indexing, the
bucketed loader's plan and its random crops mean.

- entries: the split list's images in order, each image's WAVs by sorted
  path, pair id = the image's rank among all images that have WAVs;
- buckets: quantiles (1/4, 2/4, 3/4, 1) of the lengths capped at the crop,
  rounded up to 3200 samples; a row goes to the first bucket that holds it;
- epoch ``e`` draws from ``np.random.default_rng(seed + e)``: each bucket's
  rows shuffled, cut into full batches, the batches shuffled, then one
  child generator per batch (``rng.spawn``) draws each row's crop offset in
  ``[0, len - crop)``;
- a row is its WAV's samples / 32768 from the offset, at most ``crop``
  long, zero-padded to the bucket length.
"""

from __future__ import annotations

import math
import os
import wave
from typing import Dict, List, Tuple

import numpy as np


def read_pcm16(path: str) -> np.ndarray:
    with wave.open(path, "rb") as w:
        if w.getsampwidth() != 2 or w.getnchannels() != 1:
            raise ValueError(f"{path}: the corpus holds mono 16-bit PCM")
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")


def num_samples(path: str) -> int:
    with wave.open(path, "rb") as w:
        return w.getnframes()


def entries(root: str, split: str) -> List[Dict]:
    wav_dir = os.path.join(root, "flickr_audio", "wavs")
    wavs = sorted(p for p in os.listdir(wav_dir) if p.endswith(".wav"))
    by_image: Dict[str, List[str]] = {}
    for p in wavs:
        by_image.setdefault(p[:-6], []).append(os.path.join(wav_dir, p))
    pair_id = {name: i for i, name in enumerate(sorted(by_image))}
    out = []
    with open(os.path.join(root, f"Flickr_8k.{split}Images.txt")) as f:
        for line in f:
            name = line.strip().split(".")[0]
            if not name or name not in by_image:
                continue
            for p in sorted(by_image[name]):
                out.append({"id": pair_id[name], "wav": p,
                            "image": os.path.join(root, "Images", f"{name}.jpg")})
    return out


def buckets(lengths: np.ndarray, crop: int, n: int = 4, multiple: int = 3200) -> List[int]:
    capped = np.minimum(lengths, crop)
    qs = np.quantile(capped, np.linspace(1.0 / n, 1.0, n))
    return sorted({int(math.ceil(q / multiple) * multiple) for q in qs})


def epoch_plan(lengths: np.ndarray, bucket_list: List[int], crop: int, batch: int,
               seed: int, epoch: int) -> List[Tuple[int, np.ndarray, np.ndarray]]:
    """-> [(bucket length, row indices, crop offsets)] in the order the
    epoch's full batches run."""
    rng = np.random.default_rng(seed + epoch)
    capped = np.minimum(lengths, crop)
    pos = np.minimum(np.searchsorted(np.asarray(bucket_list), capped, side="left"),
                     len(bucket_list) - 1)
    plans = []
    for k, b in enumerate(bucket_list):
        idx = np.flatnonzero(pos == k).astype(np.int64)
        rng.shuffle(idx)
        for s in range(0, len(idx) - batch + 1, batch):
            plans.append((b, idx[s:s + batch]))
    rng.shuffle(plans)
    children = [np.random.default_rng(s) for s in rng.spawn(len(plans))]
    out = []
    for (b, idx), child in zip(plans, children):
        room = np.maximum(lengths[idx] - np.minimum(lengths[idx], crop), 0)
        offsets = np.array([child.integers(0, r) if r > 0 else 0 for r in room], np.int64)
        out.append((b, idx, offsets))
    return out


def assemble(rows: List[Dict], bucket_len: int, offsets: np.ndarray, crop: int
             ) -> Dict[str, np.ndarray]:
    wav = np.zeros((len(rows), bucket_len), np.float32)
    lens = np.zeros((len(rows),), np.int32)
    for j, (row, off) in enumerate(zip(rows, offsets)):
        pcm = read_pcm16(row["wav"])[off:off + crop][:bucket_len]
        wav[j, :len(pcm)] = pcm.astype(np.float32) / 32768.0
        lens[j] = len(pcm)
    return {"wav": wav, "wav_len": lens,
            "id": np.array([r["id"] for r in rows], np.int64),
            "image": [r["image"] for r in rows]}


def plans(root: str, crop: int, batch: int, seed: int, count: int):
    """-> (rows, [(bucket length, row indices, crop offsets)]): the first
    ``count`` train batches of a fit that starts at epoch 0, unread."""
    rows = entries(root, "train")
    lengths = np.array([num_samples(r["wav"]) for r in rows], np.int64)
    bucket_list = buckets(lengths, crop)
    out, epoch = [], 0
    while len(out) < count:
        plan = epoch_plan(lengths, bucket_list, crop, batch, seed, epoch)
        if not plan:
            raise ValueError("the corpus holds no full train batch")
        out.extend(plan[:count - len(out)])
        epoch += 1
    return rows, out


def first_batches(root: str, crop: int, batch: int, seed: int, count: int
                  ) -> List[Dict[str, np.ndarray]]:
    """The first ``count`` train batches of a fit that starts at epoch 0."""
    rows, plan = plans(root, crop, batch, seed, count)
    return [assemble([rows[i] for i in idx], b, offsets, crop) for b, idx, offsets in plan]


def batch_at(root: str, crop: int, batch: int, seed: int, index: int
             ) -> Tuple[Dict[str, np.ndarray], List[int]]:
    """-> (the fit's batch ``index``, counted from 0, the bucket lengths of
    the batches before it)."""
    rows, plan = plans(root, crop, batch, seed, index + 1)
    b, idx, offsets = plan[index]
    return assemble([rows[i] for i in idx], b, offsets, crop), [p[0] for p in plan[:index]]
