"""HuBERT speech encoder, eval mode (port of speechclip_tpu/models/hubert.py).

  wav (B, L)
    -> 7 strided 1-D convolutions, 320x downsampling           [conv frontend]
       (mode "default": per-channel GroupNorm after conv0; "layer_norm": LN
       after each)
    -> LayerNorm(512) -> Linear(512 -> D)                       [post-extract]
    -> + grouped conv positional embedding (k=128, g=16, GELU)  [pos_conv]
    -> (post-norm: LayerNorm) -> N transformer layers           [encoder]
  hidden_states = [pre-layer input] + [every layer output]

The convolutions are stock torch (cuDNN on the card), as the JAX package
leaves them to XLA. Every encoder layer runs through
``kernels.fused_layer.fused_encoder_layer``.

Parameters: the JAX package's pytree keys; linear weights (in, out); conv
weights in torch's (out, in / groups, k) layout.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.fused_layer import fused_encoder_layer
from ..ops.basic import Params, gelu, layer_norm, layer_norm_init, linear, normal
from ..ops.masking import (
    conv_frame_valid_lengths,
    hubert_feature_lengths,
    key_padding_mask,
    valid_mask,
)


@dataclasses.dataclass(frozen=True)
class HubertConfig:
    """The JAX package's HubertConfig minus its training-only fields
    (dropout rates, layerdrop, remat): this port runs eval mode only."""

    # conv frontend: (channels, kernel, stride) per layer; 320x total
    conv_layers: Tuple[Tuple[int, int, int], ...] = (
        (512, 10, 5),
        (512, 3, 2),
        (512, 3, 2),
        (512, 3, 2),
        (512, 3, 2),
        (512, 2, 2),
        (512, 2, 2),
    )
    extractor_mode: str = "default"  # "default" (GN on conv0) | "layer_norm"
    conv_bias: bool = False
    encoder_embed_dim: int = 768
    encoder_layers: int = 12
    encoder_ffn_dim: int = 3072
    encoder_heads: int = 12
    layer_norm_first: bool = False  # base: post-norm; large: pre-norm
    pos_conv_kernel: int = 128
    pos_conv_groups: int = 16
    normalize_waveform: bool = False
    downsample_rate: int = 320
    # batch chunk of the conv frontend (0 = whole batch): bounds the live
    # conv0 intermediate (B, 512, ~L/5); exact, every frontend op is per-sample
    conv_batch_chunk: int = 0

    @property
    def num_hidden_states(self) -> int:
        return self.encoder_layers + 1


HUBERT_BASE = HubertConfig()


def hubert_init(generator: torch.Generator, cfg: HubertConfig) -> Params:
    """Random init with the JAX package's distributions (real weights come
    through ``convert.from_jax``)."""
    dev = generator.device
    zeros = lambda n: torch.zeros(n, dtype=torch.float32, device=dev)

    convs: List[Params] = []
    in_ch = 1
    for i, (ch, k, _s) in enumerate(cfg.conv_layers):
        layer: Params = {
            "w": normal((ch, in_ch, k), (k * in_ch) ** -0.5, generator),
            "b": zeros(ch) if cfg.conv_bias else None,
        }
        if cfg.extractor_mode == "layer_norm" or (
            cfg.extractor_mode == "default" and i == 0
        ):
            layer["norm"] = layer_norm_init(ch, dev)
        convs.append(layer)
        in_ch = ch

    d, f = cfg.encoder_embed_dim, cfg.encoder_ffn_dim

    def lin(i, o):
        return {"w": normal((i, o), i**-0.5, generator), "b": zeros(o)}

    layers = [
        {
            "self_attn": {"in_proj": lin(d, 3 * d), "out_proj": lin(d, d)},
            "self_attn_layer_norm": layer_norm_init(d, dev),
            "fc1": lin(d, f),
            "fc2": lin(f, d),
            "final_layer_norm": layer_norm_init(d, dev),
        }
        for _ in range(cfg.encoder_layers)
    ]
    c_last = cfg.conv_layers[-1][0]
    return {
        "feature_extractor": convs,
        "layer_norm": layer_norm_init(c_last, dev),
        "post_extract_proj": lin(c_last, d) if c_last != d else None,
        "encoder": {
            "pos_conv": {
                "w": normal((d, d // cfg.pos_conv_groups, cfg.pos_conv_kernel), 0.02, generator),
                "b": zeros(d),
            },
            "layer_norm": layer_norm_init(d, dev),
            "layers": layers,
        },
    }


def _conv1d(x: torch.Tensor, w: torch.Tensor, **kwargs) -> torch.Tensor:
    """conv1d with JAX's ``preferred_element_type=f32``: the operands in the
    compute dtype, the sums in f32, the output rounded to ``x.dtype``.
    cuDNN's bf16 convolution accumulates in f32 already; PyTorch's CPU bf16
    convolution does not (its grouped form errs by more than the output's
    own magnitude), so on the CPU the bf16 operands are upcast first."""
    w = w.to(x.dtype)
    if x.device.type == "cpu" and x.dtype != torch.float32:
        return F.conv1d(x.float(), w.float(), **kwargs).to(x.dtype)
    return F.conv1d(x, w, **kwargs)


def _group_norm_per_channel(x: torch.Tensor, norm: Params) -> torch.Tensor:
    """GroupNorm(C, C) == per-channel instance norm over time, x (B, C, T).
    f32 statistics with var = E[x^2] - E[x]^2 clamped at 0, applied as one
    f32 multiply-add ``x * a + b`` and returned in ``x.dtype``."""
    x32 = x.float()
    mean = x32.mean(dim=2, keepdim=True)
    mean_sq = x32.square().mean(dim=2, keepdim=True)
    var = (mean_sq - mean.square()).clamp(min=0.0)
    a = norm["scale"].float()[None, :, None] * torch.rsqrt(var + 1e-5)
    b = norm["bias"].float()[None, :, None] - mean * a
    return (x32 * a + b).to(x.dtype)


def _conv_chain(params: List[Params], cfg: HubertConfig, wav: torch.Tensor) -> torch.Tensor:
    """wav (B, L) -> (B, T, C_last): VALID convs, stride per layer."""
    x = wav[:, None, :]  # (B, 1, L), channels first for conv1d
    for i, (layer, (_ch, _k, s)) in enumerate(zip(params, cfg.conv_layers)):
        x = _conv1d(x, layer["w"], stride=s)
        if layer.get("b") is not None:
            x = x + layer["b"].to(x.dtype)[None, :, None]
        if cfg.extractor_mode == "default" and i == 0:
            x = _group_norm_per_channel(x, layer["norm"])
        elif cfg.extractor_mode == "layer_norm":
            x = layer_norm(layer["norm"], x.transpose(1, 2)).transpose(1, 2)
        x = gelu(x)
    return x.transpose(1, 2)


def conv_feature_extractor(
    params: List[Params], cfg: HubertConfig, wav: torch.Tensor
) -> torch.Tensor:
    """The conv chain, over ``cfg.conv_batch_chunk`` utterances at a time
    when set, so only one chunk's conv0 output is live."""
    chunk = cfg.conv_batch_chunk
    if chunk and wav.shape[0] > chunk:
        return torch.cat(
            [_conv_chain(params, cfg, w) for w in wav.split(chunk, dim=0)], dim=0
        )
    return _conv_chain(params, cfg, wav)


def pos_conv_apply(params: Params, cfg: HubertConfig, x: torch.Tensor) -> torch.Tensor:
    """Grouped conv positional embedding over (B, T, D): pad k/2 both sides,
    SamePad drops the trailing step for even k, then GELU."""
    y = _conv1d(
        x.transpose(1, 2),
        params["w"],
        padding=cfg.pos_conv_kernel // 2,
        groups=cfg.pos_conv_groups,
    )
    y = y + params["b"].to(x.dtype)[None, :, None]
    if cfg.pos_conv_kernel % 2 == 0:
        y = y[:, :, :-1]
    return gelu(y.transpose(1, 2))


def encoder_layer_apply(
    params: Params,
    cfg: HubertConfig,
    x: torch.Tensor,
    frame_lens: Optional[torch.Tensor],
    plain: bool = False,
) -> torch.Tensor:
    """fairseq TransformerSentenceEncoderLayer, eval mode (post- or pre-norm)."""
    return fused_encoder_layer(
        x,
        frame_lens,
        heads=cfg.encoder_heads,
        mode="pre" if cfg.layer_norm_first else "post",
        eps=1e-5,
        attn=params["self_attn"],
        fc1=params["fc1"],
        fc2=params["fc2"],
        ln1=params["self_attn_layer_norm"],
        ln2=params["final_layer_norm"],
        plain=plain,
    )


def _encoder_prelude(
    params: Params, cfg: HubertConfig, wav: torch.Tensor, wav_lengths: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Everything before the layers -> (hidden state 0 (B, T, D), frame_lens)."""
    if cfg.normalize_waveform:
        # per-utterance layer norm over VALID samples only
        vm = valid_mask(wav_lengths, wav.shape[1]).float()
        n = vm.sum(dim=1, keepdim=True).clamp(min=1.0)
        w32 = wav.float() * vm
        mean = w32.sum(dim=1, keepdim=True) / n
        var = ((w32 - mean) * vm).square().sum(dim=1, keepdim=True) / n
        wav = ((wav.float() - mean) * torch.rsqrt(var + 1e-5) * vm).to(wav.dtype)

    feats = conv_feature_extractor(params["feature_extractor"], cfg, wav)
    feats = layer_norm(params["layer_norm"], feats)
    if params.get("post_extract_proj") is not None:
        feats = linear(params["post_extract_proj"], feats)

    num_frames = feats.shape[1]
    frame_lens = conv_frame_valid_lengths(wav_lengths, wav.shape[1], num_frames)
    kpm = key_padding_mask(frame_lens, num_frames)
    x = feats.masked_fill(kpm[..., None], 0.0)  # zero padding before pos_conv
    x = x + pos_conv_apply(params["encoder"]["pos_conv"], cfg, x)
    if not cfg.layer_norm_first:
        x = layer_norm(params["encoder"]["layer_norm"], x)
    return x, frame_lens


def hubert_apply(
    params: Params,
    cfg: HubertConfig,
    wav: torch.Tensor,  # (B, L) zero-padded, compute dtype
    wav_lengths: torch.Tensor,  # (B,) int
    plain: bool = False,
) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """-> (hidden states: input + one per layer, each (B, T, D);
    feature lengths round(len / downsample_rate) clamped to T).

    The layers mask keys with the conv-frame valid lengths; the feature
    lengths are what the branch masks with (plus its CLS)."""
    x, frame_lens = _encoder_prelude(params, cfg, wav, wav_lengths)
    hidden_states = [x]
    for layer in params["encoder"]["layers"]:
        x = encoder_layer_apply(layer, cfg, x, frame_lens, plain=plain)
        hidden_states.append(x)
    feat_lens = hubert_feature_lengths(wav_lengths, cfg.downsample_rate, x.shape[1])
    return tuple(hidden_states), feat_lens


def conv_output_length(cfg: HubertConfig, n_samples: int) -> int:
    """Static conv-frontend output length (VALID padding, per-layer stride)."""
    length = n_samples
    for (_ch, k, s) in cfg.conv_layers:
        length = (length - k) // s + 1
    return length


def normalize_hidden_states(
    hidden_states: Tuple[torch.Tensor, ...], method: str
) -> Tuple[torch.Tensor, ...]:
    """Optional per-state normalization (method1: unit rows; method2:
    divide by the mean row norm per utterance)."""
    if method == "method1":
        return tuple(
            h / (torch.linalg.vector_norm(h.float(), dim=-1, keepdim=True) + 1e-8)
            for h in hidden_states
        )
    if method == "method2":
        return tuple(
            h / torch.linalg.vector_norm(h.float(), dim=-1).mean(dim=-1)[:, None, None]
            for h in hidden_states
        )
    raise NotImplementedError(method)
