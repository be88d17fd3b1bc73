"""HuBERT speech encoder (port of speechclip_tpu/models/hubert.py).

  wav (B, L)
    -> 7 strided 1-D convolutions, 320x downsampling           [conv frontend]
       (mode "default": per-channel GroupNorm after conv0; "layer_norm": LN
       after each)
    -> LayerNorm(512) -> Linear(512 -> D)                       [post-extract]
    -> + grouped conv positional embedding (k=128, g=16, GELU)  [pos_conv]
    -> (post-norm: LayerNorm) -> N transformer layers           [encoder]
  hidden_states = [pre-layer input] + [every layer output]

The convolutions are stock torch (cuDNN on the card), as the JAX package
leaves them to XLA. An encoder layer runs through
``kernels.fused_layer.fused_encoder_layer`` where its gates admit the
shapes (T <= 782 at base width in bf16) and no dropout is active, else as
the unfused layer with ``ops.attention.multi_head_attention``
(``attention_vmem`` up to T = 934).

Train mode (a trainable encoder, ``hubert_apply(..., train=True,
generator=...)``): dropout on the encoder input, and in each unfused layer
on the attention weights, after the attention, after the FFN's GELU and
after fc2; ``layerdrop`` keeps a layer's input in place of its output with
probability ``layerdrop``; ``remat`` recomputes each layer in the backward
(``torch.utils.checkpoint``). At every dropout rate 0 the layers stay on
the fused kernels, whose backward is the plain recompute. Each layer draws
its dropout masks from a generator of its own, seeded from a per-layer seed
drawn up front (JAX splits ``layer_rngs``), so a recompute redraws them.

Presets: ``HUBERT_BASE`` (post-norm, GroupNorm extractor) and
``HUBERT_LARGE`` (hubert_large_ll60k: 1024 wide, 24 pre-norm layers of 16
heads, a LayerNorm after every conv, conv biases, per-utterance waveform
normalization), by name in ``NAMED_CONFIGS`` as in the JAX package.

``hubert_frozen_weighted_sum`` is the frozen encoder's weighted-sum
feature without the stack of hidden states (``audio_encoder.wsum_remat``):
a ``torch.autograd.Function`` whose forward folds each state into an f32
accumulator as the layer loop makes it, and whose backward recomputes the
encoder to contract each state with the cotangent.

Parameters: the JAX package's pytree keys; linear weights (in, out); conv
weights in torch's (out, in / groups, k) layout.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.fused_layer import fused_encoder_layer
from ..ops.attention import attention_backend, get_attention_backend, multi_head_attention
from ..ops.basic import (
    Params,
    conv_f32,
    dropout,
    gelu,
    layer_norm,
    layer_norm_init,
    linear,
    normal,
    seeded_generator,
)
from ..ops.masking import (
    conv_frame_valid_lengths,
    hubert_feature_lengths,
    key_padding_mask,
    valid_mask,
)


@dataclasses.dataclass(frozen=True)
class HubertConfig:
    """The JAX package's HubertConfig, field for field. The dropout rates,
    ``layerdrop`` and ``remat`` act in train mode only (a trainable
    encoder)."""

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
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.0
    layerdrop: float = 0.0
    downsample_rate: int = 320
    # recompute each encoder layer in the backward instead of keeping its
    # activations (train mode only)
    remat: bool = False
    # batch chunk of the conv frontend (0 = whole batch): bounds the live
    # conv0 intermediate (B, 512, ~L/5); exact, every frontend op is per-sample
    conv_batch_chunk: int = 0

    @property
    def num_hidden_states(self) -> int:
        return self.encoder_layers + 1


HUBERT_BASE = HubertConfig()
HUBERT_LARGE = HubertConfig(
    conv_bias=True,
    encoder_embed_dim=1024,
    encoder_layers=24,
    encoder_ffn_dim=4096,
    encoder_heads=16,
    layer_norm_first=True,
    extractor_mode="layer_norm",
    normalize_waveform=True,
)

NAMED_CONFIGS = {
    "hubert": HUBERT_BASE,
    "hubert_base": HUBERT_BASE,
    "hubert_large_ll60k": HUBERT_LARGE,
}


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
    """conv1d with f32 sums (``ops.basic.conv_f32``)."""
    return conv_f32(F.conv1d, x, w, "models/hubert.py _conv1d", **kwargs)


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


def _no_dropout(cfg: HubertConfig) -> bool:
    return cfg.dropout == 0.0 and cfg.attention_dropout == 0.0 and cfg.activation_dropout == 0.0


def encoder_layer_apply(
    params: Params,
    cfg: HubertConfig,
    x: torch.Tensor,
    frame_lens: Optional[torch.Tensor],
    plain: bool = False,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """fairseq TransformerSentenceEncoderLayer (post- or pre-norm): the
    fused layer where its gates admit the shapes and no dropout is active
    (eval, or train at every rate 0), else the unfused layer of the JAX
    package (hubert.py ``encoder_layer_apply``), whose train mode drops the
    attention weights, the attention output, the GELU output and fc2's
    output, drawing from ``generator``."""
    if not train or _no_dropout(cfg):
        fused = fused_encoder_layer(
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
        if fused is not None:
            return fused

    def attn(h):
        out = multi_head_attention(
            params["self_attn"], h, h, h, num_heads=cfg.encoder_heads,
            key_valid_lens=frame_lens, dropout_rate=cfg.attention_dropout, train=train,
            generator=generator, plain=plain,
        )[0]
        return dropout(out, cfg.dropout, train, generator)

    def ffn(h):
        h = dropout(gelu(linear(params["fc1"], h)), cfg.activation_dropout, train, generator)
        return dropout(linear(params["fc2"], h), cfg.dropout, train, generator)

    if cfg.layer_norm_first:
        x = x + attn(layer_norm(params["self_attn_layer_norm"], x))
        return x + ffn(layer_norm(params["final_layer_norm"], x))
    x = layer_norm(params["self_attn_layer_norm"], x + attn(x))
    return layer_norm(params["final_layer_norm"], x + ffn(x))


def _train_layer(params: Params, cfg: HubertConfig, x: torch.Tensor,
                 frame_lens: Optional[torch.Tensor], plain: bool, seed: Optional[int],
                 like: Optional[torch.Generator]):
    """One train-mode layer whose dropout draws from a generator seeded with
    ``seed`` (of ``like``'s rank shard) here, inside the call: under
    ``torch.utils.checkpoint`` the recompute builds it again and draws the
    same masks (the checkpoint restores the default generators' states, not
    an explicit one's)."""
    return encoder_layer_apply(params, cfg, x, frame_lens, plain=plain, train=True,
                               generator=seeded_generator(seed, x.device, like))


def layerdrop_select(keep: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The layer's output ``y`` where ``keep``, else its input ``x``: JAX's
    ``jnp.where(keep, y, x)``, value and gradient."""
    return torch.where(keep, y, x)


def _layer_seeds(generator: torch.Generator, n: int) -> List[int]:
    """``n`` seeds drawn from ``generator`` (two per layer: its dropout, its
    layerdrop), read back to the host (one wait on the card a step)."""
    return torch.randint(0, 2**62, (n,), generator=generator,
                         device=generator.device).tolist()


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
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """-> (hidden states: input + one per layer, each (B, T, D);
    feature lengths round(len / downsample_rate) clamped to T).

    The layers mask keys with the conv-frame valid lengths; the feature
    lengths are what the branch masks with (plus its CLS). ``train``: the
    encoder's dropout, layerdrop and ``remat`` (JAX's order: the input's
    dropout drawn from ``generator`` first, then two seeds a layer); hidden
    state 0 is the dropped input, as in JAX."""
    x, frame_lens = _encoder_prelude(params, cfg, wav, wav_lengths)
    x = dropout(x, cfg.dropout, train, generator)
    hidden_states = [x]
    layers = params["encoder"]["layers"]
    draws = train and (not _no_dropout(cfg) or cfg.layerdrop > 0)
    if draws and generator is None:
        raise ValueError("hubert_apply needs a generator when train=True and dropout or "
                         "layerdrop is > 0")
    seeds = _layer_seeds(generator, 2 * len(layers)) if draws else [None] * (2 * len(layers))
    for i, layer in enumerate(layers):
        if not train:
            y = encoder_layer_apply(layer, cfg, x, frame_lens, plain=plain)
        elif cfg.remat:
            y = checkpoint(_train_layer, layer, cfg, x, frame_lens, plain, seeds[2 * i],
                           generator, use_reentrant=False)
        else:
            y = _train_layer(layer, cfg, x, frame_lens, plain, seeds[2 * i], generator)
        if train and cfg.layerdrop > 0:
            g = seeded_generator(seeds[2 * i + 1], x.device)
            keep = torch.rand((), generator=g, device=x.device) < 1.0 - cfg.layerdrop
            x = layerdrop_select(keep, y, x)
        else:
            x = y
        hidden_states.append(x)
    feat_lens = hubert_feature_lengths(wav_lengths, cfg.downsample_rate, x.shape[1])
    return tuple(hidden_states), feat_lens


def conv_output_length(cfg: HubertConfig, n_samples: int) -> int:
    """Static conv-frontend output length (VALID padding, per-layer stride)."""
    length = n_samples
    for (_ch, k, s) in cfg.conv_layers:
        length = (length - k) // s + 1
    return length


# ---------------------------------------------------------------------------
# The frozen weighted sum with a backward recompute: O(2 states) live, not O(N)
# ---------------------------------------------------------------------------
def _process_state(h: torch.Tensor, norm_type: Optional[str]) -> torch.Tensor:
    """The per-state normalization before the weighted sum: method1 / method2
    (``normalize_hidden_states``) or the s3prl per-state LayerNorm."""
    if norm_type is None:
        return h
    if norm_type in ("method1", "method2"):
        return normalize_hidden_states((h,), norm_type)[0]
    if norm_type == "s3prl":
        return layer_norm(None, h)
    raise NotImplementedError(norm_type)


def _wsum_pass(
    cfg: HubertConfig,
    norm_type: Optional[str],
    params: Params,
    wav: torch.Tensor,
    wav_lengths: torch.Tensor,
    w: torch.Tensor,  # (N,) f32 softmax weights
    g: Optional[torch.Tensor] = None,
    plain: bool = False,
) -> torch.Tensor:
    """One eval-mode encoder pass that consumes each hidden state as the
    layer loop produces it, so at most the current state and the
    accumulator are live.

    ``g`` None (forward): the f32 accumulator ``sum_i w_i state_i`` in
    ``weighted_sum_apply``'s order of accumulation. ``g`` given (backward):
    ``dots`` (N,) f32, ``dots_i = <g, state_i>``, each state contracted to a
    scalar the moment it is made."""
    x, frame_lens = _encoder_prelude(params, cfg, wav, wav_lengths)
    g32 = None if g is None else g.float()

    def consume(i: int, h: torch.Tensor) -> torch.Tensor:
        s = _process_state(h, norm_type).float()
        return w[i] * s if g32 is None else torch.sum(g32 * s)

    acc = consume(0, x)
    dots = [acc]
    for i, layer in enumerate(params["encoder"]["layers"]):
        x = encoder_layer_apply(layer, cfg, x, frame_lens, plain=plain)
        c = consume(i + 1, x)
        if g is None:
            acc = acc + c
        else:
            dots.append(c)
    return acc if g is None else torch.stack(dots)


class FrozenWeightedSumFn(torch.autograd.Function):
    """The weighted-sum feature of a frozen encoder (JAX's ``_frozen_wsum``
    custom VJP). Forward: ``_wsum_pass`` under no_grad; it saves the weight
    logits, ``wav`` and the lengths, never a hidden state. Backward: the
    same eval-mode pass again, on the forward's kernel route (the same
    ``plain`` flag and attention backend), for ``dots``; then the softmax
    VJP ``d_logits = w * (dots - <w, dots>)``. The encoder and ``wav`` get
    no gradient."""

    @staticmethod
    def forward(ctx, logits, wav, wav_lengths, params, cfg, norm_type, plain):
        w = torch.softmax(logits.float(), dim=0)
        with torch.no_grad():
            acc = _wsum_pass(cfg, norm_type, params, wav, wav_lengths, w, plain=plain)
        ctx.save_for_backward(logits, wav, wav_lengths)
        ctx.params, ctx.cfg, ctx.norm_type, ctx.plain = params, cfg, norm_type, plain
        ctx.backend = get_attention_backend()
        # weighted_sum_apply's output dtype: the processed states' (f32 after
        # method1 / method2, the compute dtype otherwise)
        return acc.to(wav.dtype if norm_type in (None, "s3prl") else torch.float32)

    @staticmethod
    def backward(ctx, g):
        logits, wav, wav_lengths = ctx.saved_tensors
        w = torch.softmax(logits.float(), dim=0)
        with torch.no_grad(), attention_backend(ctx.backend):
            dots = _wsum_pass(ctx.cfg, ctx.norm_type, ctx.params, wav, wav_lengths, w, g=g,
                              plain=ctx.plain)
            d_logits = w * (dots - torch.sum(w * dots))
        return d_logits.to(logits.dtype), None, None, None, None, None, None


def hubert_frozen_weighted_sum(
    ws_params: Params,
    params: Params,
    cfg: HubertConfig,
    wav: torch.Tensor,
    wav_lengths: torch.Tensor,
    norm_type: Optional[str] = None,
    plain: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (the weighted-sum feature (B, T, D), feature lengths) of a FROZEN
    HuBERT without keeping its N hidden states (``audio_encoder.wsum_remat``).

    ``hubert_apply`` + ``weighted_sum_apply`` keep every state until the sum
    takes them: for HuBERT-large at B = 256 and 6.4 s that stack is 25 x 256
    x 319 x 1024 x 2 B = 4.2 GB, and the s3prl mode's LayerNorm and f32 copy
    of it stay saved for the logits' gradient. Here the states are consumed
    inside the layer loop, and the gradient of the logits is recomputed
    (``FrozenWeightedSumFn``): one more frozen forward per train step. Only
    for a frozen encoder: the recompute assumes a deterministic forward and
    returns no encoder gradient."""
    feat = FrozenWeightedSumFn.apply(ws_params["weights"], wav, wav_lengths, params, cfg,
                                     norm_type, plain)
    num_frames = conv_output_length(cfg, wav.shape[1])
    return feat, hubert_feature_lengths(wav_lengths, cfg.downsample_rate, num_frames)


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
