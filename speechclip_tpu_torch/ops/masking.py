"""Length -> mask helpers (port of speechclip_tpu/ops/masking.py)."""

from __future__ import annotations

import torch


def key_padding_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """Bool (B, T) mask, True at PADDING positions (torch convention)."""
    pos = torch.arange(max_length, device=lengths.device)
    return pos[None, :] >= lengths.long()[:, None]


def valid_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """Bool (B, T) mask, True at VALID positions."""
    return ~key_padding_mask(lengths, max_length)


def hubert_feature_lengths(
    wav_lengths: torch.Tensor, downsample_rate: int, max_frames: int
) -> torch.Tensor:
    """``round(len / rate)`` clamped to ``max_frames``, int32. Rounds half to
    even, as ``jnp.rint`` and Python's ``round`` do (``torch.round`` too)."""
    feat_len = torch.round(wav_lengths.float() / float(downsample_rate))
    return feat_len.to(torch.int32).clamp(max=max_frames)


def conv_frame_valid_lengths(
    wav_lengths: torch.Tensor, padded_wav_len: int, num_frames: int
) -> torch.Tensor:
    """Frame-level valid lengths of fairseq's ``forward_padding_mask``:
    with chunk ``c = padded_wav_len // num_frames``, frame i is valid iff
    ``i * c < len``, i.e. ``ceil(min(len, c * num_frames) / c)``, int32."""
    chunk = max(padded_wav_len // num_frames, 1)
    clipped = wav_lengths.to(torch.int32).clamp(max=chunk * num_frames)
    return ((clipped + chunk - 1) // chunk).clamp(max=num_frames).to(torch.int32)
