"""The plain reference of a SpeechCLIP parallel model: HuBERT (base or
large), the weighted sum of its hidden states, the parallel branch and its
projection, the CLIP ViT image tower, the masked contrastive loss, its
gradient, the global-norm clip and Adam; retrieval by cosine score.

Plain PyTorch in float32 with TF32 off (``f32_math``), written from the
published descriptions (fairseq HuBERT, torch ``TransformerEncoderLayer``,
OpenAI CLIP, s3prl's weighted sum), independent of the measured package.
Every matrix product and convolution goes through a ``Precision``, so the
same code computes the control: its operands rounded to float8 (e4m3, one
scale per tensor) before an f32 product.

The program's design choices that the reference follows, as the semantics
it is held to: HuBERT's padded frames are zeroed before the positional
conv and its layers mask keys past ``ceil(len / (L // T))`` frames; the
branch sees ``round(len / 320)`` frames plus its CLS; the pre-norm (large)
encoder's hidden states are taken without a final LayerNorm; GroupNorm
(base conv 0) spans the padded frames. Departure: GELU is the exact erf
form throughout (the program takes the tanh form in bf16).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


@contextlib.contextmanager
def f32_math():
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale for the tensor, in f32."""
    t = t.float()
    scale = t.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class _Fp8MatMul(torch.autograd.Function):
    """a @ b on float8 operands, forward and backward (the incoming
    gradient rounded to float8 too, each under its own scale), summed in f32."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = fp8(a), fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = fp8(g)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


class Precision:
    """f32 products, or (``fp8=True``) products of operands rounded to
    float8 e4m3 with one scale per tensor, in the backward as well."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return fp8(t.detach()) if self.fp8 else t.float()

    def mm(self, a, b):
        if not self.fp8:
            return a.float() @ b.float()
        if b.dim() == 2 and a.dim() > 2:
            return _Fp8MatMul.apply(a.float().reshape(-1, a.shape[-1]), b.float()).reshape(
                *a.shape[:-1], b.shape[-1])
        return _Fp8MatMul.apply(a.float(), b.float())

    def conv1d(self, x, w, **kw):
        return F.conv1d(self.q(x), self.q(w), **kw)

    def conv2d(self, x, w, **kw):
        return F.conv2d(self.q(x), self.q(w), **kw)


def f32(t):
    return None if t is None else t.float()


def layer_norm(x, p: Optional[Dict], eps: float = 1e-5):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    y = (x - mean) / torch.sqrt(var + eps)
    return y if p is None else y * f32(p["scale"]) + f32(p["bias"])


def linear(P: Precision, x, p: Dict):
    y = P.mm(x, p["w"])
    return y if p.get("b") is None else y + f32(p["b"])


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def attention(P: Precision, x, p: Dict, heads: int, key_lens: Optional[torch.Tensor],
              drop_w: Optional[torch.Tensor] = None, rate: float = 0.0):
    """Self-attention over (B, T, D); keys at or past ``key_lens`` masked;
    ``drop_w``: a keep mask (B, H, T, T) on the softmax weights."""
    b, t, d = x.shape
    dh = d // heads
    qkv = linear(P, x, p["in_proj"])
    q, k, v = (z.reshape(b, t, heads, dh).transpose(1, 2) for z in qkv.split(d, dim=-1))
    s = P.mm(q, k.transpose(-1, -2)) / math.sqrt(dh)
    if key_lens is not None:
        pad = torch.arange(t, device=x.device)[None, :] >= key_lens.long()[:, None]
        s = s.masked_fill(pad[:, None, None, :], float("-inf"))
    w = torch.softmax(s, dim=-1)
    if drop_w is not None:
        w = w * drop_w / (1.0 - rate)
    o = P.mm(w, v).transpose(1, 2).reshape(b, t, d)
    return linear(P, o, p["out_proj"])


# ------------------------------------------------------------------ HuBERT
def frame_lens(wav_len: torch.Tensor, padded: int, frames: int) -> torch.Tensor:
    chunk = max(padded // frames, 1)
    clipped = wav_len.long().clamp(max=chunk * frames)
    return ((clipped + chunk - 1) // chunk).clamp(max=frames)


def feature_lens(wav_len: torch.Tensor, rate: int, frames: int) -> torch.Tensor:
    return torch.round(wav_len.double() / rate).long().clamp(max=frames)


def hubert_states(P: Precision, p: Dict, a: Dict, wav: torch.Tensor, wav_len: torch.Tensor
                  ) -> List[torch.Tensor]:
    """wav (B, L) f32 zero-padded -> [pre-layer state, one per layer], (B, T, D)."""
    if a["normalize_waveform"]:
        valid = (torch.arange(wav.shape[1], device=wav.device)[None] < wav_len[:, None]).float()
        n = valid.sum(1, keepdim=True).clamp(min=1.0)
        mean = (wav * valid).sum(1, keepdim=True) / n
        var = ((wav - mean) * valid).square().sum(1, keepdim=True) / n
        wav = (wav - mean) / torch.sqrt(var + 1e-5) * valid
    x = wav[:, None, :]
    for i, (layer, (_ch, _k, s)) in enumerate(zip(p["feature_extractor"], a["conv_layers"])):
        x = P.conv1d(x, layer["w"], stride=s)
        if layer.get("b") is not None:
            x = x + f32(layer["b"])[None, :, None]
        if a["extractor_mode"] == "layer_norm":
            x = layer_norm(x.transpose(1, 2), layer["norm"]).transpose(1, 2)
        elif i == 0:  # GroupNorm(C, C): each channel over time
            mean = x.mean(2, keepdim=True)
            var = (x - mean).square().mean(2, keepdim=True)
            x = (x - mean) / torch.sqrt(var + 1e-5)
            x = x * f32(layer["norm"]["scale"])[None, :, None] + f32(layer["norm"]["bias"])[None, :, None]
        x = gelu(x)
    feats = layer_norm(x.transpose(1, 2), p["layer_norm"])
    if p.get("post_extract_proj") is not None:
        feats = linear(P, feats, p["post_extract_proj"])
    frames = feats.shape[1]
    lens = frame_lens(wav_len, wav.shape[1], frames)
    pad = torch.arange(frames, device=wav.device)[None, :] >= lens[:, None]
    x = feats.masked_fill(pad[..., None], 0.0)
    enc = p["encoder"]
    k = a["pos_conv_kernel"]
    pos = P.conv1d(x.transpose(1, 2), enc["pos_conv"]["w"], padding=k // 2,
                   groups=a["pos_conv_groups"]) + f32(enc["pos_conv"]["b"])[None, :, None]
    if k % 2 == 0:
        pos = pos[:, :, :-1]
    x = x + gelu(pos.transpose(1, 2))
    pre = a["layer_norm_first"]
    if not pre:
        x = layer_norm(x, enc["layer_norm"])
    states = [x]
    for layer in enc["layers"]:
        def ffn(h):
            return linear(P, gelu(linear(P, h, layer["fc1"])), layer["fc2"])
        if pre:
            x = x + attention(P, layer_norm(x, layer["self_attn_layer_norm"]), layer["self_attn"],
                              a["encoder_heads"], lens)
            x = x + ffn(layer_norm(x, layer["final_layer_norm"]))
        else:
            x = layer_norm(x + attention(P, x, layer["self_attn"], a["encoder_heads"], lens),
                           layer["self_attn_layer_norm"])
            x = layer_norm(x + ffn(x), layer["final_layer_norm"])
        states.append(x)
    return states


def hubert_stack(P: Precision, p: Dict, a: Dict, wav: torch.Tensor, wav_len: torch.Tensor,
                 rows: int, s3prl_norm: bool) -> torch.Tensor:
    """(N, B, T, D) hidden states, ``rows`` utterances at a time, without
    a graph; with ``s3prl_norm`` each state LayerNorm'd (no parameters)."""
    parts = []
    with torch.no_grad():
        for lo in range(0, wav.shape[0], rows):
            states = hubert_states(P, p, a, wav[lo:lo + rows], wav_len[lo:lo + rows])
            st = torch.stack(states)
            if s3prl_norm:
                st = layer_norm(st, None)
            parts.append(st)
            del states
    return torch.cat(parts, dim=1)


def weighted_sum(stack: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    return torch.einsum("n,nbtd->btd", torch.softmax(f32(logits), 0), stack)


# ------------------------------------------------------------------ branch
DROPOUT_SHAPES = ("attention weights", "attention output", "ffn middle", "ffn output")


def dropout_masks(generator: torch.Generator, b: int, t: int, br: Dict, rate: float
                  ) -> List[torch.Tensor]:
    """The keep masks of one train-mode branch layer, drawn in the order the
    layer uses them: the attention weights (B, H, T, T), the attention
    output (B, T, D), the FFN's middle (B, T, F), the FFN's output (B, T, D)."""
    h, d, f = br["nhead"], br["d_model"], br["dim_feedforward"]
    dev = generator.device
    return [torch.rand(shape, generator=generator, device=dev) < 1.0 - rate
            for shape in ((b, h, t, t), (b, t, d), (b, t, f), (b, t, d))]


def branch(P: Precision, p: Dict, br: Dict, feat: torch.Tensor, feat_len: torch.Tensor,
           masks: Optional[Sequence[List[torch.Tensor]]] = None, rate: float = 0.0):
    """The parallel branch on (B, T, D) features -> (B, E) (before the L2
    norm). ``masks``: per layer, ``dropout_masks``' four keep masks."""
    b = feat.shape[0]
    x = torch.cat([f32(p["cls"]).expand(b, 1, feat.shape[2]), feat], dim=1)
    key_lens = feat_len + 1
    scale = 1.0 / (1.0 - rate) if masks is not None else 1.0

    def drop(h, m):
        return h if m is None else h * m * scale

    for i, layer in enumerate(p["transformer"]["layers"]):
        m = masks[i] if masks is not None else [None] * 4
        a = attention(P, x, layer["self_attn"], br["nhead"], key_lens, m[0], rate)
        x = layer_norm(x + drop(a, m[1]), layer["norm1"], br["layer_norm_eps"])
        mid = drop(gelu(linear(P, x, layer["linear1"])), m[2])
        x = layer_norm(x + drop(linear(P, mid, layer["linear2"]), m[3]), layer["norm2"],
                       br["layer_norm_eps"])
    x = layer_norm(x, p["transformer"]["norm"])
    return linear(P, x[:, 0], p["proj"])


def l2n(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


# ------------------------------------------------------------------ ViT
def vit(P: Precision, p: Dict, v: Dict, images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) normalized images -> (B, output_dim)."""
    x = P.conv2d(images.permute(0, 3, 1, 2).float(), p["conv1"]["w"], stride=v["patch_size"])
    x = x.flatten(2).transpose(1, 2)
    b, _, w = x.shape
    x = torch.cat([f32(p["class_embedding"]).expand(b, 1, w), x], 1) + f32(p["positional_embedding"])
    x = layer_norm(x, p["ln_pre"])
    for blk in p["blocks"]:
        x = x + attention(P, layer_norm(x, blk["ln_1"]), blk["attn"], v["heads"], None)
        h = linear(P, layer_norm(x, blk["ln_2"]), blk["mlp"]["c_fc"])
        x = x + linear(P, h * torch.sigmoid(1.702 * h), blk["mlp"]["c_proj"])
    return P.mm(layer_norm(x[:, 0], p["ln_post"]), p["proj"])


CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def load_images(paths: Sequence[str], side: int):
    """CLIP's preprocessing: bicubic shorter-side resize to ``side``, centre
    crop, RGB in [0, 1], normalized per channel -> (N, side, side, 3) f32."""
    import numpy as np
    from PIL import Image

    out = []
    for path in paths:
        with Image.open(path) as img:
            img = img.convert("RGB")
            w, h = img.size
            scale = side / min(w, h)
            nw, nh = int(round(w * scale)), int(round(h * scale))
            if (nw, nh) != (w, h):
                img = img.resize((nw, nh), Image.BICUBIC)
            left, top = (nw - side) // 2, (nh - side) // 2
            img = img.crop((left, top, left + side, top + side))
            arr = np.asarray(img, np.float32) / 255.0
        out.append((arr - np.array(CLIP_MEAN, np.float32)) / np.array(CLIP_STD, np.float32))
    return np.stack(out)


# ------------------------------------------------------------------ loss
def contrastive_loss(audio: torch.Tensor, image: torch.Tensor, ids: torch.Tensor,
                     inv_temp: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE; other captions of a row's image are not negatives."""
    logits = (audio @ image.T) * inv_temp
    n = logits.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=logits.device)
    keep = (ids[:, None] != ids[None, :]) | eye
    masked = logits.masked_fill(~keep, float("-inf"))
    pos = torch.diagonal(logits)
    return ((torch.logsumexp(masked, 1) - pos).mean() + (torch.logsumexp(masked, 0) - pos).mean()) / 2


# ------------------------------------------------------------------ optimizer
def linear_warmup_decay(step: int, base: float, warmup: int, max_step: int, final: float) -> float:
    import numpy as np

    s = np.float32(step)
    if s < warmup:
        factor = (s + 1) / np.float32(warmup)
    else:
        slope = np.float32(1.0 - final / base)
        factor = np.float32(1.0) - slope * (s + 1 - np.float32(warmup)) / np.float32(max_step - warmup)
    return float(np.float32(base) * np.float32(factor))


def clip_global(grads: List[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    norm = torch.sqrt(sum(g.square().sum() for g in grads))
    if max_norm and float(norm) >= max_norm:
        return [g / norm * max_norm for g in grads]
    return grads


class Adam:
    """Adam with L2 weight decay added to the gradient (torch.optim.Adam's
    ``weight_decay``)."""

    def __init__(self, params: List[torch.Tensor], betas=(0.9, 0.999), eps=1e-8, wd=0.0):
        self.params, self.b1, self.b2, self.eps, self.wd = params, betas[0], betas[1], eps, wd
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    def step(self, grads: List[torch.Tensor], lr: float) -> List[torch.Tensor]:
        """Update in place; -> the gradients as the moments took them."""
        self.t += 1
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        taken = []
        with torch.no_grad():
            for p, g, m, v in zip(self.params, grads, self.m, self.v):
                g = g + self.wd * p
                taken.append(g)
                m.mul_(self.b1).add_(g, alpha=1 - self.b1)
                v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
                denom = (v.sqrt() / math.sqrt(bc2)).add_(self.eps)
                p.addcdiv_(m, denom, value=-lr / bc1)
        return taken
