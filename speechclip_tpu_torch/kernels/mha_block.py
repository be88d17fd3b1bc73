"""Fused self-attention half-layer (port of speechclip_tpu/kernels/mha_block.py
``mha_layer_block``).

``ln_mode`` picks the layer form:
- "post": LN(x + MHA(x))  (HuBERT-base, torch post-norm encoder layers)
- "pre":  x + MHA(LN(x))  (HuBERT-large)
- "none": MHA(x)

MHA is torch ``nn.MultiheadAttention`` self-attention: fused QKV projection,
per-head scaled dot product with a key-length mask, out-projection.

The call is the custom op ``speechclip::mha_layer_block`` (``_ops``). On a
CUDA bf16 tensor it runs as three or four launches of the hand-written
kernels in ``csrc/``: [row LN for "pre"] -> QKV GEMM + f32 bias ->
attention core -> out-proj GEMM with bias + residual epilogue [-> row LN for
"post"]. The GEMMs are ``csrc/gemm_epilogue.cu`` (wgmma fed by TMA). The
attention core is the whole-row kernel of ``csrc/attention_vmem.cu`` with
this block's rounding points at every T: it streams K and V, so it takes
rows of any length. On a CPU tensor it runs ``mha_layer_block_plain``,
which keeps the TPU kernel's rounding points: f32 accumulation, f32 bias
added before rounding qkv to the activation dtype, f32 masked softmax, f32
residual and LayerNorm.

Where an input requires grad, the call goes through ``MhaLayerBlockFn``
(the JAX ``custom_vjp``'s counterpart, ``_plain_grad``): the forward as
above, the gradient from a recompute through ``mha_layer_block_plain``.
The weight matrices are cast to the activation dtype before it, inside the
graph, so their gradients land on the caller's (f32) leaves.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build, _ops
from . import attention_vmem as rowwise
from ._plain_grad import needs_grad, plain_grad_function
from ._attention_common import MAX_HEAD_DIM, MAX_ROWS
from ._sdpa_ref import masked_sdpa
from ..ops.basic import matmul_f32

# Epilogue ids of scl_gemm_bf16 (csrc/gemm_epilogue.cu).
EPI_BIAS, EPI_BIAS_GELU, EPI_BIAS_RESID_F32, EPI_BIAS_RESID = 0, 1, 2, 3
LN_MODES = ("post", "pre", "none")
# Tile constants of csrc/gemm_epilogue.cu: rows of a tile, K per stage,
# stages of the TMA ring, columns of one B box, padding of a residual row;
# and TMA's limits.
GEMM_BM, GEMM_BK, GEMM_STAGES, GEMM_CHUNK, GEMM_RESID_PAD = 128, 64, 4, 64, 8
GEMM_BLOCK_NS = (128, 256)
TMA_SWIZZLE_BYTES, TMA_MAX_BOX = 128, 256
# The TPU kernel's VMEM cap (bytes). Kept as it is: the gate decides which
# computation, with which rounding points, produces the layer's output, and
# the port is held to the reference; retuning it for the H100 is later work
# that needs measurements of its own.
VMEM_BUDGET = 16 * 1024 * 1024


def block_eligible(b: int, t: int, d: int, heads: int, itemsize: int = 2) -> bool:
    """The JAX gate (kernels/mha_block.py ``block_eligible``), number for
    number: Dh a multiple of 8 up to 128, ``T*T >= 128^2``, and the weights
    plus one batch element's buffers within VMEM_BUDGET (T <= 782 at D = 768
    in bf16). ``b`` is unused, as in the reference."""
    if d % heads != 0:
        return False
    dh = d // heads
    if dh % 8 != 0 or dh > 128:
        return False
    if t * t < 128 * 128:
        return False
    weights = 3 * d * d * itemsize + d * d * itemsize
    per_cell = (
        2 * 2 * t * d * itemsize  # x + out, double buffered
        + 3 * t * d * itemsize  # qkv
        + t * t * 4  # one head's scores f32
        + t * d * itemsize  # assembled outputs
    )
    return weights + per_cell <= VMEM_BUDGET


def ln_rows(y32: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float):
    """Row LayerNorm in f32 (the TPU kernels' ``_ln_rows``)."""
    mean = y32.mean(dim=-1, keepdim=True)
    var = (y32 - mean).square().mean(dim=-1, keepdim=True)
    return (y32 - mean) * torch.rsqrt(var + eps) * g.float() + b.float()


def mha_layer_block_plain(x, w_in, b_in, w_out, b_out, ln_g, ln_b, lens,
                          heads: int, ln_mode: str, eps: float) -> torch.Tensor:
    """The plain PyTorch version: (B, T, D) -> (B, T, D) in ``x.dtype``."""
    dt = x.dtype
    bsz, t, d = x.shape
    dh = d // heads
    h_in = ln_rows(x.float(), ln_g, ln_b, eps).to(dt) if ln_mode == "pre" else x
    qkv = (matmul_f32(h_in, w_in.to(dt)) + b_in.float()).to(dt)
    split = lambda z: z.reshape(bsz, t, heads, dh).transpose(1, 2)
    q, k, v = qkv.split(d, dim=-1)
    att = masked_sdpa(split(q), split(k), split(v), lens)
    att = att.transpose(1, 2).reshape(bsz, t, d)
    out32 = matmul_f32(att, w_out.to(dt)) + b_out.float()
    if ln_mode == "post":
        out32 = ln_rows(out32 + x.float(), ln_g, ln_b, eps)
    elif ln_mode == "pre":
        out32 = out32 + x.float()
    return out32.to(dt)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def check_cuda_operands(x: torch.Tensor, *params: Optional[torch.Tensor]):
    """What the CUDA kernels accept; anything else raises (never a silent
    detour to the plain version)."""
    if x.device.type != "cuda":
        raise ValueError(f"kernel path needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"kernel path runs bf16 activations, got {x.dtype}")
    for p in params:
        if p is not None and p.device != x.device:
            raise ValueError(f"operand on {p.device}, activations on {x.device}")


def gemm_plan(n: int, epilogue: int, block_n: int = 0) -> dict:
    """The tile plan of ``scl_gemm_bf16`` for N output columns: the tile's
    columns (``block_n``, or by default 128 when N <= 128, else 256); the
    ring's stages (one fewer beside a 256-wide residual tile); the shared
    memory of one block (the ring, the tile's f32 bias, then the residual
    tile with padded rows for the residual epilogues, which also stages
    their output, or else a 16 x (64 + 8) bf16 staging area per consumer
    warp; and 1 KB to align the ring to the 1024-byte swizzle atom); and
    the TMA boxes as (inner elements, rows): A (128 x 64, K-major) and B
    (64 x 64 per chunk of 64 columns)."""
    bn = block_n or (128 if n <= 128 else 256)
    if bn not in GEMM_BLOCK_NS:
        raise ValueError(f"GEMM tile columns must be one of {GEMM_BLOCK_NS}, got {bn}")
    resid = epilogue in (EPI_BIAS_RESID_F32, EPI_BIAS_RESID)
    stages = GEMM_STAGES - 1 if resid and bn == 256 else GEMM_STAGES
    epi_bytes = GEMM_BM * (bn + GEMM_RESID_PAD) * 2 if resid else 8 * 16 * 72 * 2
    smem = stages * (GEMM_BM + bn) * GEMM_BK * 2 + bn * 4 + epi_bytes + 1024
    return dict(block_n=bn, stages=stages, smem_bytes=smem,
                boxes=[(GEMM_BK, GEMM_BM), (GEMM_CHUNK, GEMM_BK)],
                b_boxes_per_stage=bn // GEMM_CHUNK)


def gemm(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, epilogue: int,
         resid: Optional[torch.Tensor] = None, block_n: int = 0) -> torch.Tensor:
    """(M, K) bf16 @ (K, N) bf16 + f32 bias, with the chosen epilogue, on
    the tile plan of ``gemm_plan``; ``block_n`` overrides its tile columns
    (for measurements)."""
    m, k = a.shape
    n = w.shape[1]
    if k % 8 or n % 8 or w.shape[0] != k or bias.shape != (n,):
        raise ValueError(
            f"GEMM needs (M, K) @ (K, N) + (N,) with K % 8 == 0 and N % 8 == 0, "
            f"got {tuple(a.shape)} @ {tuple(w.shape)} + {tuple(bias.shape)}"
        )
    w = w.to(torch.bfloat16).contiguous()
    bias = bias.float().contiguous()
    operands = [a, w, bias] + ([] if resid is None else [resid])
    if resid is not None and (resid.shape != (m, n) or resid.dtype != torch.bfloat16):
        raise ValueError(f"residual must be ({m}, {n}) bf16, got {tuple(resid.shape)} {resid.dtype}")
    if a.dtype != torch.bfloat16 or any(
        not t.is_contiguous() or t.data_ptr() % 16 for t in operands
    ):
        raise ValueError("GEMM operands must be bf16 activations, contiguous and 16-byte aligned")
    if block_n and block_n not in GEMM_BLOCK_NS:
        raise ValueError(f"GEMM tile columns must be one of {GEMM_BLOCK_NS}, got {block_n}")
    out_dtype = torch.float32 if epilogue == EPI_BIAS_RESID_F32 else torch.bfloat16
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    lib = _build.load()
    args = (a.data_ptr(), w.data_ptr(), bias.data_ptr(), _ptr(resid), out.data_ptr(),
            m, n, k, epilogue)
    stream = _build.stream(a.device)
    _build.check(
        lib.scl_gemm_bf16_tiled(*args, block_n, stream) if block_n
        else lib.scl_gemm_bf16(*args, stream),
        "scl_gemm_bf16",
    )
    return out


def layer_norm_rows(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """Row LN of (M, D) f32 or bf16 -> bf16 (csrc/gemm_epilogue.cu; 16-byte
    loads, so D % 8 == 0 and 16-byte-aligned rows)."""
    rows, d = x.shape
    g, b = g.float().contiguous(), b.float().contiguous()
    if d % 8 or any(t.data_ptr() % 16 for t in (x, g, b)) or not x.is_contiguous():
        raise ValueError(f"row LayerNorm needs D % 8 == 0 and contiguous, 16-byte aligned "
                         f"operands, got D = {d}")
    out = torch.empty((rows, d), dtype=torch.bfloat16, device=x.device)
    lib = _build.load()
    _build.check(
        lib.scl_layer_norm(
            x.data_ptr(), int(x.dtype == torch.float32), g.data_ptr(),
            b.data_ptr(), out.data_ptr(), rows, d, float(eps),
            _build.stream(x.device),
        ),
        "scl_layer_norm",
    )
    return out


def attention_core_max_t(dh: int) -> int:
    """The longest T the attention core of ``mha_layer_block`` takes at head
    dim ``dh`` (0 if it takes no T there). The core is the whole-row kernel,
    whose shared memory does not depend on T, so only the head dim limits it
    (and the launchers' int row counts)."""
    if dh % 8 or dh > MAX_HEAD_DIM:
        return 0
    return MAX_ROWS


def check_core_shape(t: int, d: int, heads: int) -> None:
    """The rows and heads the attention core takes; anything else raises."""
    dh = d // heads
    if d % heads or d % 8 or t > attention_core_max_t(dh):
        raise ValueError(
            f"attention core does not take T={t}, Dh={dh} (needs Dh % 8 == 0, "
            f"Dh <= {MAX_HEAD_DIM} and T <= {attention_core_max_t(dh)})"
        )


def attention_core(qkv: torch.Tensor, lens: Optional[torch.Tensor], bsz: int,
                   t: int, d: int, heads: int) -> torch.Tensor:
    """(B*T, 3D) bf16 qkv -> (B*T, D) bf16 head outputs: the whole-row kernel
    of csrc/attention_vmem.cu with masked_sdpa's rounding points, reading q,
    k, v straight out of qkv and writing the heads in place."""
    check_core_shape(t, d, heads)
    dh = d // heads
    out = torch.empty((bsz * t, d), dtype=torch.bfloat16, device=qkv.device)
    heads_of = lambda z: z.view(bsz, t, heads, dh).permute(0, 2, 1, 3)
    q, k, v = (heads_of(z) for z in qkv.view(bsz, t, 3 * d).split(d, dim=-1))
    rowwise.rowwise_attention(q, k, v, lens, heads_of(out), causal=False,
                              vmem_rounding=False)
    return out


def check_block_operands(x: torch.Tensor, params, heads: int) -> None:
    """What ``mha_layer_block``'s kernels take (``check_cuda_operands`` and
    the attention core's head and row limits); anything else raises. The
    op's fake implementation runs it too, so an export at a shape the
    kernels refuse fails at export time."""
    check_cuda_operands(x, *params)
    check_core_shape(x.shape[1], x.shape[2], heads)


def mha_layer_block(x, w_in, b_in, w_out, b_out, ln_g, ln_b, lens,
                    heads: int, ln_mode: str, eps: float) -> torch.Tensor:
    """(B, T, D) -> (B, T, D) through the op ``speechclip::mha_layer_block``.
    CPU tensor: the plain version. CUDA tensor: the hand-written kernels, or
    an exception. Differentiable: where an input requires grad, through
    ``MhaLayerBlockFn``."""
    if ln_mode not in LN_MODES:
        raise ValueError(f"ln_mode {ln_mode!r} not in {LN_MODES}")
    _ops.check_device(x, "mha_layer_block")
    args = (x, w_in, b_in, w_out, b_out, ln_g, ln_b)
    if needs_grad(*args):
        return MhaLayerBlockFn.apply(x, w_in.to(x.dtype), b_in, w_out.to(x.dtype), b_out,
                                     ln_g, ln_b, lens, int(heads), ln_mode, float(eps))
    return _ops.mha_layer_block(*args, lens, int(heads), ln_mode, float(eps))


def mha_layer_block_cuda(x, w_in, b_in, w_out, b_out, ln_g, ln_b, lens,
                         heads: int, ln_mode: str, eps: float) -> torch.Tensor:
    """The op's CUDA implementation: the kernels, counted in
    ``mha_layer_block.launches``; zero rows return the empty output
    without a launch."""
    check_block_operands(x, (w_in, b_in, w_out, b_out, ln_g, ln_b), heads)
    bsz, t, d = x.shape
    if x.numel() == 0:
        return x.new_empty(x.shape)
    x2 = x.contiguous().view(bsz * t, d)
    h_in = layer_norm_rows(x2, ln_g, ln_b, eps) if ln_mode == "pre" else x2
    qkv = gemm(h_in, w_in, b_in, EPI_BIAS)
    att = attention_core(qkv, lens, bsz, t, d, heads)
    if ln_mode == "post":
        out = layer_norm_rows(
            gemm(att, w_out, b_out, EPI_BIAS_RESID_F32, resid=x2), ln_g, ln_b, eps
        )
    elif ln_mode == "pre":
        out = gemm(att, w_out, b_out, EPI_BIAS_RESID, resid=x2)
    else:
        out = gemm(att, w_out, b_out, EPI_BIAS)
    mha_layer_block.launches += 1
    return out.view(bsz, t, d)


mha_layer_block.launches = 0
mha_layer_block.recomputes = 0
MhaLayerBlockFn = plain_grad_function("MhaLayerBlockFn", _ops.mha_layer_block,
                                      mha_layer_block_plain, mha_layer_block)
