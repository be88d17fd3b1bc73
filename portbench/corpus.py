"""A seeded corpus in Flickr8k's on-disk layout, the layout that
``speechclip_tpu_torch.data.datasets.FlickrDataset`` reads:

  <root>/Flickr_8k.{train,dev,test}Images.txt   split lists
  <root>/flickr_audio/wavs/<image>_<n>.wav      16 kHz 16-bit PCM, mono
  <root>/Flickr8k.token.txt                     "<image>.jpg#<n>\\t<caption>"
  <root>/Images/<image>.jpg                     square JPEGs

Every utterance's duration is drawn once from the traffic file's
``layout_seed`` (uniform in its ``seconds`` range), so every run measures
the same set of lengths; a run's ``--seed`` reorders them (the trainer's
shuffles and crops) and makes the weights. Each WAV's samples are a slice,
at an offset drawn from ``layout_seed`` and the file's index, of one
seeded block of Gaussian noise, so the writer's time is the disk's. The
corpus is written once per checkout into a fixed directory named by a hash
of its parameters, and later runs read it from there (and from the page
cache).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import wave
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np

FORMAT_VERSION = 2
NOISE_SAMPLES = 1 << 26  # the shared block: 64 Mi samples, 70 min at 16 kHz


def corpus_key(spec: Dict) -> str:
    blob = json.dumps({"v": FORMAT_VERSION, **spec}, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def image_names(spec: Dict, split: str) -> List[str]:
    return [f"{split}{i:04d}" for i in range(int(spec["images"][split]))]


def durations(spec: Dict) -> Dict[str, np.ndarray]:
    """{split: (images, captions) seconds}, from ``layout_seed`` alone."""
    rng = np.random.default_rng(int(spec["layout_seed"]))
    lo, hi = spec["seconds"]
    n_cap = int(spec["captions_per_image"])
    return {split: rng.uniform(lo, hi, (int(n), n_cap))
            for split, n in sorted(spec["images"].items())}


def _write_wav(path: str, pcm: np.ndarray, sr: int) -> None:
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.astype("<i2").tobytes())


def _image(name: str, side: int, seed: int) -> np.ndarray:
    """A smooth seeded RGB image: a few random sinusoids per channel, so
    the JPEG stays small and decodes like a photograph rather than noise."""
    digest = hashlib.sha256(f"{seed}:{name}".encode()).digest()
    rng = np.random.default_rng(int.from_bytes(digest[:8], "little"))
    y, x = np.mgrid[0:side, 0:side].astype(np.float32) / side
    out = np.zeros((side, side, 3), np.float32)
    for c in range(3):
        for _ in range(4):
            fx, fy, ph = rng.uniform(0.5, 6.0), rng.uniform(0.5, 6.0), rng.uniform(0, 6.28)
            out[..., c] += np.sin(6.28 * (fx * x + fy * y) + ph)
    out = (out - out.min()) / max(float(out.max() - out.min()), 1e-6)
    return (out * 255.0).astype(np.uint8)


def write_corpus(root: str, spec: Dict) -> None:
    """Write the corpus ``spec`` describes into ``root`` (a new directory)."""
    from PIL import Image

    sr, side = int(spec["sample_rate"]), int(spec["image_side"])
    seed = int(spec["layout_seed"])
    wav_dir = os.path.join(root, "flickr_audio", "wavs")
    img_dir = os.path.join(root, "Images")
    os.makedirs(wav_dir)
    os.makedirs(img_dir)
    secs = durations(spec)
    captions = []
    jobs = []
    for split in sorted(spec["images"]):
        names = image_names(spec, split)
        for i, name in enumerate(names):
            for n, sec in enumerate(secs[split][i]):
                jobs.append((os.path.join(wav_dir, f"{name}_{n}.wav"), int(round(sec * sr)),
                             len(jobs)))
                captions.append(f"{name}.jpg#{n}\tcaption {n} of {name} .")
        with open(os.path.join(root, f"Flickr_8k.{split}Images.txt"), "w") as f:
            f.write("\n".join(f"{name}.jpg" for name in names) + "\n")
    with open(os.path.join(root, "Flickr_8k.testImages.txt"), "w") as f:
        f.write("\n".join(f"{name}.jpg" for name in image_names(spec, "dev")) + "\n")
    with open(os.path.join(root, "Flickr8k.token.txt"), "w") as f:
        f.write("\n".join(captions) + "\n")

    noise = np.random.default_rng(seed).standard_normal(NOISE_SAMPLES, dtype=np.float32)
    noise = np.clip(np.rint(noise * float(spec["pcm_std"])), -32768, 32767).astype("<i2")

    def one_wav(job):
        path, n, k = job
        off = int(np.random.default_rng([seed, k]).integers(0, NOISE_SAMPLES - n))
        _write_wav(path, noise[off:off + n], sr)

    def one_image(name):
        Image.fromarray(_image(name, side, seed)).save(
            os.path.join(img_dir, f"{name}.jpg"), quality=90)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(one_wav, jobs))
        list(pool.map(one_image, [n for s in sorted(spec["images"])
                                  for n in image_names(spec, s)]))
        # written back now, in set-up, not while a later window reads it
        list(pool.map(_fsync, [os.path.join(d, f) for d, _s, fs in os.walk(root) for f in fs]))


def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def ensure_corpus(cache_dir: str, spec: Dict) -> str:
    """The corpus directory for ``spec`` under ``cache_dir``, written there
    first if no complete copy exists (a temporary sibling renamed into
    place, so a cut run leaves no half corpus behind)."""
    root = os.path.join(cache_dir, f"corpus-{corpus_key(spec)}")
    if os.path.exists(os.path.join(root, "COMPLETE")):
        return root
    tmp = root + ".partial"
    shutil.rmtree(tmp, ignore_errors=True)
    shutil.rmtree(root, ignore_errors=True)
    write_corpus(tmp, spec)
    with open(os.path.join(tmp, "COMPLETE"), "w") as f:
        f.write(json.dumps(spec, sort_keys=True))
    os.replace(tmp, root)
    return root
