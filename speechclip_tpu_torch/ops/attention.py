"""Multi-head attention with torch ``nn.MultiheadAttention`` semantics (in
train mode with dropout on the attention weights), and the attention
dispatcher (port of speechclip_tpu/ops/attention.py).

The backend switch has the JAX package's names: "auto" (the default: the
fused MHA block, else the whole-row kernel, where their gates admit the
shapes), "pallas" (every structured-mask attention through the streaming
flash kernel, the switch for long sequences) and "xla" (no kernel; here
stock torch, ``sdpa_plain``).

The route is a function of shapes, dtype, masks and backend alone, the same
on the CPU and on the card (``attention_route``); the device only picks the
body. A CUDA bf16 tensor on a kernel route launches the kernel or raises; a
CPU tensor, or ``plain=True``, runs the plain version of the same route.
Attention-weight dropout in train mode closes every kernel route, as in
JAX: the kernels never form the weights.
The JAX package's mesh plan (shard_map over a TPU mesh) has no counterpart:
under torch each rank already holds its local batch. Under a live model
axis (``parallel.tensor.model_mesh``) with ``in_proj`` sharded by heads,
each rank projects and attends its H/M heads (the route taken at the local
head count, never the fused block), draws its heads' part of the weights'
dropout, and the heads are gathered before the replicated out-projection.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Optional, Tuple

import torch

from .basic import Params, dropout, linear, matmul_f32
from ..parallel import collectives
from ..parallel import tensor as tp
from .masking import key_padding_mask as _key_padding_mask
from ..kernels._sdpa_ref import NEG_INF
from ..kernels.attention_vmem import attention_vmem, vmem_eligible
from ..kernels.flash_attention import flash_attention
from ..kernels.mha_block import block_eligible, mha_layer_block, mha_layer_block_plain

BACKENDS = ("auto", "xla", "pallas")
_ATTENTION_BACKEND = "auto"


def set_attention_backend(name: str) -> None:
    global _ATTENTION_BACKEND
    if name not in BACKENDS:
        raise ValueError(f"attention backend {name!r} not in {BACKENDS}")
    _ATTENTION_BACKEND = name


def get_attention_backend() -> str:
    return _ATTENTION_BACKEND


@contextmanager
def attention_backend(name: str):
    old = get_attention_backend()
    set_attention_backend(name)
    try:
        yield
    finally:
        set_attention_backend(old)


def _structured_masks(attn_mask, key_padding_mask, key_valid_lens) -> bool:
    """Kernel-expressible masking: per-batch valid key lengths and/or a
    causal flag. Arbitrary additive or bool masks stay on ``sdpa_plain``."""
    if attn_mask is not None:
        return False
    if key_padding_mask is not None and key_valid_lens is None:
        return False
    return True


def attention_route(b: int, l: int, s: int, d: int, heads: int, itemsize: int, *,
                    self_attention: bool = True, structured: bool = True,
                    causal: bool = False, backend: Optional[str] = None) -> str:
    """Which body ``multi_head_attention`` runs: "mha_block" (the fused
    QKV -> attention -> out-proj block), "attention_vmem", "flash_attention"
    or "sdpa" (``sdpa_plain``), in the JAX dispatcher's order.
    ``structured``: no weights asked for and only structured masks."""
    backend = backend or _ATTENTION_BACKEND
    if (self_attention and structured and not causal and backend == "auto"
            and block_eligible(b, l, d, heads, itemsize)):
        return "mha_block"
    if structured and backend == "auto" and vmem_eligible(b, heads, l, s, d // heads, itemsize):
        return "attention_vmem"
    if structured and backend == "pallas":
        return "flash_attention"
    return "sdpa"


def padding_bias(key_padding_mask: Optional[torch.Tensor],
                 attn_mask: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
    """Key-padding (B, S) True = pad and attention (L, S) masks as one
    additive f32 bias broadcastable to (B, H, L, S)."""
    bias = None
    if key_padding_mask is not None:
        bias = torch.zeros(key_padding_mask.shape, dtype=torch.float32,
                           device=key_padding_mask.device)
        bias = bias.masked_fill(key_padding_mask, NEG_INF)[:, None, None, :]
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            add = torch.zeros(attn_mask.shape, dtype=torch.float32, device=attn_mask.device)
            add = add.masked_fill(attn_mask, NEG_INF)
        else:
            add = attn_mask.float()
        add = add[None, None]
        bias = add if bias is None else bias + add
    return bias


def causal_bias(length: int, device=None) -> torch.Tensor:
    """Additive (L, L) causal mask: finfo.min above the diagonal."""
    row = torch.arange(length, device=device)[:, None]
    col = torch.arange(length, device=device)[None, :]
    zero = torch.zeros((length, length), dtype=torch.float32, device=device)
    return zero.masked_fill(col > row, NEG_INF)


def sdpa_plain(
    q: torch.Tensor,  # (B, H, L, Dh)
    k: torch.Tensor,  # (B, H, S, Dh)
    v: torch.Tensor,  # (B, H, S, Dh)
    bias: Optional[torch.Tensor] = None,  # additive, broadcastable to (B,H,L,S)
    return_weights: bool = False,
    dropout_rate: float = 0.0,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    split: Optional[Tuple[int, int, int]] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The port of ``sdpa_xla`` with its rounding points. bf16 without
    weights: ``q * bf16(scale)``, logits accumulated in f32 and rounded to
    bf16, bias and softmax in f32, weights rounded to bf16, P V accumulated
    in f32. Otherwise: f32 logits scaled after the product, f32 softmax,
    weights cast to v's dtype for P V (and returned in f32). In train mode
    the weights take dropout before P V (and are returned dropped, as
    torch's); ``split``: the heads are a model-axis part of the layer's
    (``ops.basic.rand_rows``)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    if not return_weights and q.dtype == torch.bfloat16:
        qs = q * torch.full((), scale, dtype=torch.bfloat16, device=q.device)
        x = matmul_f32(qs, k.transpose(-1, -2)).to(torch.bfloat16).float()
        if bias is not None:
            x = x + bias.float()
        w16 = torch.softmax(x, dim=-1).to(torch.bfloat16)
        w16 = dropout(w16, dropout_rate, train, generator, split)
        return matmul_f32(w16, v).to(v.dtype), None
    logits = matmul_f32(q, k.transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()
    weights = dropout(torch.softmax(logits, dim=-1), dropout_rate, train, generator, split)
    out = matmul_f32(weights.to(v.dtype), v).to(v.dtype)
    return out, (weights if return_weights else None)


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def multi_head_attention(
    params: Params,
    query: torch.Tensor,  # (B, L, D)
    key: torch.Tensor,  # (B, S, D)
    value: torch.Tensor,  # (B, S, D)
    num_heads: int,
    key_padding_mask: Optional[torch.Tensor] = None,  # (B, S) True = pad
    attn_mask: Optional[torch.Tensor] = None,  # (L, S) additive f32 or bool
    key_valid_lens: Optional[torch.Tensor] = None,  # (B,) structured mask
    causal: bool = False,
    dropout_rate: float = 0.0,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    need_weights: bool = False,
    average_attn_weights: bool = True,
    plain: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """torch-parity MHA forward -> (output (B, L, D), weights): weights
    (B, L, S) if averaged over heads, else (B, H, L, S), or None. In train
    mode at ``dropout_rate > 0`` the weights take dropout (drawn from
    ``generator``) and no kernel route is taken. ``plain=True`` runs the
    plain version of whichever route is taken."""
    in_w, in_b = params["in_proj"]["w"], params["in_proj"]["b"]
    self_attention = query is key and key is value
    b, l, d = query.shape
    mesh = tp.mesh_of(in_w)  # the model axis, where in_proj is sharded by heads
    if mesh is not None and (not self_attention or need_weights):
        raise NotImplementedError("a head-sharded attention runs self-attention without "
                                  "returning its weights")
    heads = num_heads // mesh.model_size if mesh is not None else num_heads
    width = in_w.shape[1] // 3  # D, or this rank's D / M
    route = attention_route(
        b, l, key.shape[1], width, heads, query.element_size(),
        self_attention=self_attention and tp.live_mesh() is None,
        structured=not need_weights and not (train and dropout_rate > 0)
        and _structured_masks(attn_mask, key_padding_mask, key_valid_lens),
        causal=causal,
    )

    if route == "mha_block":
        ow, ob = params["out_proj"]["w"], params["out_proj"]["b"]
        bi = in_b if in_b is not None else torch.zeros(3 * d, device=query.device)
        bo = ob if ob is not None else torch.zeros(d, device=query.device)
        block = mha_layer_block_plain if plain else mha_layer_block
        out = block(query, in_w, bi, ow, bo, None, None, key_valid_lens,
                    num_heads, "none", 0.0)
        return out, None

    if self_attention:  # one fused (D, 3D) projection instead of three
        x = query if mesh is None else collectives.copy_to_model(query, mesh, "attention input")
        q, k, v = linear(params["in_proj"], x).split(width, dim=-1)
    else:
        wq, wk, wv = in_w.split(d, dim=1)
        bq, bk, bv = (None,) * 3 if in_b is None else in_b.split(d)
        q = linear({"w": wq, "b": bq}, query)
        k = linear({"w": wk, "b": bk}, key)
        v = linear({"w": wv, "b": bv}, value)
    q, k, v = (_split_heads(z, heads) for z in (q, k, v))

    def out_proj(o):
        merged = _merge_heads(o)
        if mesh is not None:
            merged = collectives.gather_from_model(merged, mesh, "heads")
        return linear(params["out_proj"], merged)

    if route in ("attention_vmem", "flash_attention"):
        kernel = attention_vmem if route == "attention_vmem" else flash_attention
        out = kernel(q, k, v, key_valid_lens, causal, plain=plain)
        return out_proj(out), None

    if key_padding_mask is None and key_valid_lens is not None:
        key_padding_mask = _key_padding_mask(key_valid_lens, key.shape[1])
    if causal and attn_mask is None:
        attn_mask = causal_bias(key.shape[1], query.device)[: l]
    split = None if mesh is None else (1, mesh.model_rank, mesh.model_size)
    out, weights = sdpa_plain(q, k, v, padding_bias(key_padding_mask, attn_mask), need_weights,
                              dropout_rate, train, generator, split)
    out = out_proj(out)
    if not need_weights:
        return out, None
    return out, (weights.mean(dim=1) if average_attn_weights else weights)
