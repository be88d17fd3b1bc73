"""The model surfaces a deployment serves (port of speechclip_tpu/export.py,
its first part).

- ``encode_speech_surface``: ``fn(params, state, wav, wav_len) -> feature
  dict``, tensors only (the VQ diagnostics dropped), the surface the serving
  runtime calls;
- ``cast_float_params``: every floating leaf to one dtype (``--dtype bf16``).

The artifact exporters (``export_encode_speech`` / ``_image`` / ``_text``),
``load_exported`` and the CLI wait for the ROADMAP item 'export' (Queue 1
item 6): ``torch.export`` traces no ``ctypes`` call, so each kernel must
first be registered as a ``torch.library`` custom op with a fake
implementation.
"""

from __future__ import annotations

from typing import Any

import torch


def encode_speech_surface(model):
    """``fn(params, state, wav, wav_len)``: ``model.encode_speech``'s
    tensors (``parallel_audio_feat``, ``cascaded_audio_feat``, ``keywords``,
    as the config enables them), ``vq_results`` dropped."""

    def fn(params, state, wav, wav_len):
        out = model.encode_speech(params, state, wav, wav_len)
        return {k: v for k, v in out.items() if k != "vq_results" and torch.is_tensor(v)}

    return fn


def cast_float_params(params: Any, dtype: torch.dtype) -> Any:
    """Every floating leaf to ``dtype`` (biases, LayerNorms and the text
    tower too, as the JAX function casts them); integer leaves and None
    stay. Not ``models.speechclip.cast_params``, which keeps vectors and the
    text tower in f32."""
    if isinstance(params, dict):
        return {k: cast_float_params(v, dtype) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(cast_float_params(v, dtype) for v in params)
    if torch.is_tensor(params) and params.is_floating_point():
        return params.detach().to(dtype)
    return params
