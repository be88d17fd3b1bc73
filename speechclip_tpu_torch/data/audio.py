"""Host-side audio ingest (port of speechclip_tpu/data/audio.py): a
stdlib/numpy WAV reader plus polyphase resampling. The Flickr8k and
SpokenCOCO corpora are 16 kHz 16-bit PCM WAVs, so the hot path is a copy and
an int16 -> f32 scale; resampling (scipy, imported where it is used) runs
only on mismatched rates."""

from __future__ import annotations

import wave
from typing import Optional

import numpy as np


def read_wav(path: str, target_sr: int = 16_000) -> np.ndarray:
    """-> mono float32 waveform in [-1, 1] at target_sr."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n_channels = w.getnchannels()
        sampwidth = w.getsampwidth()
        n_frames = w.getnframes()
        raw = w.readframes(n_frames)

    if sampwidth == 2:
        wav = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 4:
        wav = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 1:
        wav = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {sampwidth} ({path})")

    if n_channels > 1:
        wav = wav.reshape(-1, n_channels).mean(axis=1)

    if sr != target_sr:
        wav = resample(wav, sr, target_sr)
    return wav


def wav_num_samples(path: str, target_sr: int = 16_000) -> int:
    """Length metadata from the header only (no payload read) — used for
    length bucketing without decoding the corpus twice."""
    with wave.open(path, "rb") as w:
        n, sr = w.getnframes(), w.getframerate()
    if sr == target_sr:
        return n
    return int(round(n * target_sr / sr))


def resample(wav: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(orig_sr, target_sr)
    return resample_poly(wav, target_sr // g, orig_sr // g).astype(np.float32)


def random_crop_max_length(
    audio: np.ndarray,
    max_len: int,
    orig_len: Optional[int] = None,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Train-time random crop to ``max_len`` samples, offset drawn from
    ``rng`` with an exclusive high end (in the data pipeline, so a bucket's
    shapes stay fixed)."""
    audio_len = min(len(audio), orig_len if orig_len is not None else len(audio))
    if audio_len <= max_len or max_len < 0:
        return audio[:audio_len]
    rng = rng or np.random.default_rng()
    offset = int(rng.integers(0, audio_len - max_len))
    return audio[offset : offset + max_len]
