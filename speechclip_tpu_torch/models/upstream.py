"""The s3prl-style upstreams besides HuBERT (port of
speechclip_tpu/models/upstream.py, the reference's
``S3prlSpeechEncoderPlus`` contract): ``audio_encoder.type: s3prl_plus``
with ``name: apc`` or ``modified_cpc``.

An upstream is an ``Upstream`` handle: its config (``encoder_embed_dim``,
``num_hidden_states``, ``downsample_rate`` 160), ``init(generator) ->
params`` and ``apply(params, wav, wav_len, generator, train) ->
(hidden states, feature lengths)``, the states a tuple of (B, T, D) as
``models/hubert.py`` gives them, ``feat_len = round(len / 160)`` clamped
to T. ``resolve_upstream`` maps the hubert family to None (HuBERT keeps
its own module) and raises for a name outside the registry.

- **apc**: an 80-mel log-mel front end at a 10 ms hop (``log_mel``: Hann
  window of 400 samples, ``rfft`` at 512, an HTK mel filterbank, log of
  ``max(mel, 1e-10)``), a linear prenet and a stack of unidirectional GRU
  layers, one hidden state each.
- **modified_cpc**: a strided conv encoder z (strides 5, 4, 2, 2, 2) and a
  GRU context network c: two states of different widths, so no weighted
  sum, only an index list or a named key.

The GRU (``gru_layer_apply``: torch's r, z, n gate order, JAX's (in, 3H)
weight layout) takes the input half of its gates as one (B*T, 3H) product
up front, then steps over time with the (B, H) @ (H, 3H) recurrent
product: JAX's ``lax.scan``, written as a loop. Every step rounds at the
compute dtype where JAX does. Pretrained s3prl weights are not available
offline, in JAX as here: the init is random.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.basic import Params, linear, uniform
from ..ops.masking import hubert_feature_lengths
from .hubert import _conv1d

S3PRL_DEFAULT_DOWNSAMPLE = 160  # reference speech_encoder_plus.py:149


# ---------------------------------------------------------------------------
# log-mel front end
# ---------------------------------------------------------------------------
def mel_filterbank(n_mels: int, n_fft: int, sample_rate: int = 16000) -> np.ndarray:
    """(n_fft // 2 + 1, n_mels) HTK-style triangular mel filterbank."""

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    n_freqs = n_fft // 2 + 1
    mel_pts = np.linspace(hz_to_mel(0.0), hz_to_mel(sample_rate / 2), n_mels + 2)
    bins = np.floor((n_fft + 1) * mel_to_hz(mel_pts) / sample_rate).astype(np.int64)
    fb = np.zeros((n_freqs, n_mels), np.float32)
    for m in range(n_mels):
        lo, ctr, hi = bins[m], bins[m + 1], bins[m + 2]
        for k in range(lo, ctr):
            fb[k, m] = (k - lo) / (ctr - lo)
        for k in range(ctr, hi):
            fb[k, m] = (hi - k) / (hi - ctr)
    return fb


def log_mel(wav: torch.Tensor, n_mels: int = 80, win_length: int = 400,
            hop_length: int = 160, n_fft: int = 512) -> torch.Tensor:
    """(B, L) -> (B, L // hop, n_mels) f32 log-mel features. The wav is
    right-padded by ``win - hop`` samples, so a length-L input gives exactly
    L // hop frames of ``win`` samples; each Hann-windowed frame is padded
    to ``n_fft`` by the ``rfft``. An input shorter than a hop has no frame:
    (B, 0, n_mels), as in JAX."""
    n_frames = wav.shape[1] // hop_length
    if n_frames == 0:  # MKL's and cuFFT's rfft refuse an empty batch of frames
        return wav.new_zeros((wav.shape[0], 0, n_mels), dtype=torch.float32)
    x = F.pad(wav.float(), (0, win_length - hop_length))
    idx = (torch.arange(n_frames, device=wav.device)[:, None] * hop_length
           + torch.arange(win_length, device=wav.device)[None, :])
    frames = x[:, idx]  # (B, N, win)
    window = torch.from_numpy(np.hanning(win_length).astype(np.float32)).to(wav.device)
    spec = torch.fft.rfft(frames * window, n=n_fft, dim=-1)
    power = spec.abs().square()  # (B, N, n_fft // 2 + 1)
    fb = torch.from_numpy(mel_filterbank(n_mels, n_fft)).to(wav.device)
    return torch.clamp(power @ fb, min=1e-10).log()


# ---------------------------------------------------------------------------
# GRU
# ---------------------------------------------------------------------------
def gru_layer_init(generator: torch.Generator, in_dim: int, hidden: int) -> Params:
    """torch.nn.GRU's U(-1/sqrt(H), 1/sqrt(H)) init in JAX's layout."""
    bound = 1.0 / math.sqrt(hidden)
    return {
        "w_ih": uniform((in_dim, 3 * hidden), bound, generator),
        "w_hh": uniform((hidden, 3 * hidden), bound, generator),
        "b_ih": uniform((3 * hidden,), bound, generator),
        "b_hh": uniform((3 * hidden,), bound, generator),
    }


def gru_layer_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """(B, T, D) -> (B, T, H), a unidirectional GRU from h = 0 in
    ``x.dtype``: r = sigmoid(x W_ir + b_ir + h W_hr + b_hr), z likewise,
    n = tanh(x W_in + b_in + r * (h W_hn + b_hn)), h' = (1 - z) n + z h."""
    gates_in = linear({"w": params["w_ih"], "b": params["b_ih"]}, x)  # (B, T, 3H)
    w_hh = params["w_hh"].to(x.dtype)
    b_hh = params["b_hh"].to(x.dtype)
    h = x.new_zeros((x.shape[0], w_hh.shape[0]))
    out = []
    for gi in gates_in.unbind(1):
        gh = h @ w_hh + b_hh
        ir, iz, inn = gi.chunk(3, dim=-1)
        hr, hz, hn = gh.chunk(3, dim=-1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        n = torch.tanh(inn + r * hn)
        h = (1.0 - z) * n + z * h
        out.append(h)
    if not out:  # no step: (B, 0, H), as JAX's scan gives
        return h[:, None, :].expand(-1, 0, -1)
    return torch.stack(out, dim=1)


def _feature_lengths(wav_lengths: torch.Tensor, rate: int, frames: int) -> torch.Tensor:
    """round(len / rate) clamped to [0, frames] (reference :286-290)."""
    return hubert_feature_lengths(wav_lengths.to(torch.int64), rate, frames).clamp(min=0)


# ---------------------------------------------------------------------------
# APC
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class APCConfig:
    n_mels: int = 80
    encoder_embed_dim: int = 512  # the GRU's hidden size (s3prl apc's out_dim)
    num_layers: int = 3
    downsample_rate: int = S3PRL_DEFAULT_DOWNSAMPLE
    win_length: int = 400
    hop_length: int = 160

    @property
    def num_hidden_states(self) -> int:
        return self.num_layers  # one per GRU layer, all encoder_embed_dim wide


def apc_init(generator: torch.Generator, cfg: APCConfig) -> Params:
    d = cfg.encoder_embed_dim
    prenet = {"w": uniform((cfg.n_mels, d), 1.0 / math.sqrt(cfg.n_mels), generator),
              "b": torch.zeros(d, dtype=torch.float32, device=generator.device)}
    return {"prenet": prenet,
            "layers": [gru_layer_init(generator, d, d) for _ in range(cfg.num_layers)]}


def apc_apply(params: Params, cfg: APCConfig, wav: torch.Tensor, wav_lengths: torch.Tensor,
              generator: Optional[torch.Generator] = None, train: bool = False
              ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """-> (one (B, T, D) state per GRU layer, feature lengths); no dropout."""
    mel = log_mel(wav, cfg.n_mels, cfg.win_length, cfg.hop_length).to(wav.dtype)
    x = linear(params["prenet"], mel)
    states = []
    for layer in params["layers"]:
        x = gru_layer_apply(layer, x)
        states.append(x)
    return tuple(states), _feature_lengths(wav_lengths, cfg.downsample_rate, mel.shape[1])


# ---------------------------------------------------------------------------
# CPC: heterogeneous states
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class CPCConfig:
    """s3prl's ``modified_cpc``: conv encoder z (``conv_dim`` wide; strides
    multiply to 160) and GRU context c (``context_dim`` wide)."""

    conv_dim: int = 512
    context_dim: int = 256
    conv_strides: tuple = (5, 4, 2, 2, 2)
    conv_kernels: tuple = (10, 8, 4, 4, 4)
    downsample_rate: int = S3PRL_DEFAULT_DOWNSAMPLE

    @property
    def encoder_embed_dim(self) -> int:
        return self.context_dim  # the last state's width (the reference's probe)

    @property
    def num_hidden_states(self) -> int:
        return 2  # (z, c)

    @property
    def hidden_state_dims(self) -> tuple:
        return (self.conv_dim, self.context_dim)


def cpc_init(generator: torch.Generator, cfg: CPCConfig) -> Params:
    """Conv kernels in torch's (out, in, k) layout (JAX's WIO turned by
    ``convert.from_jax``), biases at zero."""
    convs, in_ch = [], 1
    for k in cfg.conv_kernels:
        convs.append({"w": uniform((cfg.conv_dim, in_ch, k), 1.0 / math.sqrt(in_ch * k),
                                   generator),
                      "b": torch.zeros(cfg.conv_dim, dtype=torch.float32,
                                       device=generator.device)})
        in_ch = cfg.conv_dim
    return {"convs": convs, "gru": gru_layer_init(generator, cfg.conv_dim, cfg.context_dim)}


def cpc_apply(params: Params, cfg: CPCConfig, wav: torch.Tensor, wav_lengths: torch.Tensor,
              generator: Optional[torch.Generator] = None, train: bool = False
              ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """-> ((z (B, T, conv_dim), c (B, T, context_dim)), feature lengths):
    each conv padded k // 2 on both sides, its bias added and ReLU in the
    compute dtype."""
    x = wav[:, None, :]
    for conv, k, s in zip(params["convs"], cfg.conv_kernels, cfg.conv_strides):
        x = _conv1d(x, conv["w"], stride=s, padding=k // 2) + conv["b"].to(x.dtype)[None, :, None]
        x = torch.relu(x)
    z = x.transpose(1, 2)
    c = gru_layer_apply(params["gru"], z)
    return (z, c), _feature_lengths(wav_lengths, cfg.downsample_rate, z.shape[1])


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Upstream:
    """The S3prlSpeechEncoderPlus contract of one upstream."""

    name: str
    cfg: object  # encoder_embed_dim / num_hidden_states / downsample_rate
    init: Callable  # (generator) -> params
    apply: Callable  # (params, wav, wav_len, generator=None, train=False) -> (states, feat_len)


_FAMILIES = {"apc": (APCConfig, apc_init, apc_apply),
             "modified_cpc": (CPCConfig, cpc_init, cpc_apply)}


def upstream_for_config(name: str, cfg) -> Upstream:
    """The handle of registry name ``name`` over an already-built config."""
    _, init, apply = _FAMILIES[name]
    return Upstream(
        name=name, cfg=cfg, init=lambda generator: init(generator, cfg),
        apply=lambda params, wav, wav_len, generator=None, train=False: apply(
            params, cfg, wav, wav_len, generator, train))


def upstream_name(cfg) -> Optional[str]:
    """The registry name of an upstream config; None for any other (HuBERT's)."""
    return next((name for name, (cls, _, _) in _FAMILIES.items() if isinstance(cfg, cls)),
                None)


def resolve_upstream(name: str, overrides: Optional[Dict] = None) -> Optional[Upstream]:
    """None for the hubert family (``models/hubert.py``); the handle of a
    registered name with ``overrides`` on its config's defaults; raises
    for any other name (the reference would fail inside s3prl's hub, later)."""
    if name.startswith("hubert"):
        return None
    if name in _FAMILIES:
        return upstream_for_config(name, _FAMILIES[name][0](**(overrides or {})))
    raise NotImplementedError(
        f"s3prl upstream {name!r} is not in the offline registry "
        f"(available: hubert family, {sorted(_FAMILIES)})")
