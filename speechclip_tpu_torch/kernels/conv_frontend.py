"""HuBERT's stride-2 conv chain with an exact-erf GELU after each layer (port
of speechclip_tpu/kernels/conv_frontend.py ``fused_conv_chain``).

What it computes, on x (B, T, C) in the JAX NWC layout (the output of
conv0 + GroupNorm + GELU) and per-layer weights (k, C_in, C_out) in the
JAX WIO layout, every layer stride 2 and VALID: the sums in f32, GELU with
the exact erf on the f32 sum, one rounding to x's dtype per layer. It is
not HuBERT's own bf16 chain, which rounds each conv before a tanh GELU
(``models/hubert.py``); like the JAX kernel, it lies on no model path.

The call is the custom op ``speechclip::fused_conv_chain`` (``_ops``). On a
CUDA bf16 tensor it launches ``csrc/conv_chain.cu`` once per layer:
one wgmma GEMM whose A operand is the TPU kernel's stride-2 fold of the
input, read by TMA with no copy, as ``fold_segments`` describes it; on a CPU
tensor, or with ``plain=True``, it runs ``fused_conv_chain_plain``.
Anything else raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import _build, _ops
from ._attention_common import SMEM_LIMIT
from ._plain_grad import needs_grad

# Agreement of the kernel with its plain version. The products are exact
# and the sums f32 on both sides, so one layer's outputs differ only where
# another summation order flips a bf16 rounding: about 0.02 % of elements
# (CPU, f32 against a float64 re-summation at C = 512). GELU computed
# another way (tanh instead of erf, ~3e-4 apart) flips about 3 %. So each
# layer, fed the same input on both sides, may differ in at most
# MAX_LAYER_MISMATCH of its elements; the whole chain, where flips
# propagate, is held to the layer-output limits of the other kernels.
MAX_LAYER_MISMATCH = 0.005

# The kernel's plan (csrc/conv_chain.cu): a consumer warpgroup's tile
# (rows, columns) by tile id; the K step; the staging rows of the
# epilogue.
CONV_TILES = ((64, 256), (128, 128))
CONV_BK = 64
CONV_STAGING_BYTES = 8 * 16 * 72 * 2
# The kernel sizes the fold takes (the TPU kernel raises on others too).
KERNEL_SIZES = (2, 3)


@dataclasses.dataclass(frozen=True)
class FoldSegment:
    """One segment of a layer's K loop as the kernel reads it: x viewed as
    (B, rows, cols) with element strides (batch_stride, row_stride, 1), one
    TMA map; output row t reads view row t + row_offset (rows past ``rows``
    read as zeros), against weight rows [w_row, w_row + cols)."""

    rows: int
    cols: int
    row_stride: int
    batch_stride: int
    row_offset: int
    w_row: int


def fold_segments(t_in: int, c_in: int, k: int) -> Tuple[FoldSegment, ...]:
    """The A operand of one layer: the TPU kernel's fold x (T, C) -> x2
    (T/2, 2C). k = 2: x2's floor(T/2) full rows, 2C wide. k = 3 adds the
    first C columns of x2 from row 1 on, against W[2C:]; that view has
    ceil(T/2) rows, so an odd T's last frame x(T-1), half a row of x2, is
    read, and no view reaches past its own batch element."""
    if k not in KERNEL_SIZES:
        raise ValueError(f"fused_conv_chain: the kernel takes kernel sizes {KERNEL_SIZES}, got {k}")
    segments = [FoldSegment(t_in // 2, 2 * c_in, 2 * c_in, t_in * c_in, 0, 0)]
    if k == 3:
        segments.append(FoldSegment((t_in + 1) // 2, c_in, 2 * c_in, t_in * c_in, 1, 2 * c_in))
    return tuple(segments)


def conv_plan(tile: int) -> dict:
    """The kernel's plan for a tile id: the warpgroup tile, the ring's
    stages (as many as fit beside the staging area and the barriers) and
    one block's dynamic shared memory (with 1 KB to align the ring to the
    swizzle atom)."""
    rows, cols = CONV_TILES[tile]
    stage = (rows + cols) * CONV_BK * 2
    stages = (SMEM_LIMIT - 1024 - 256 - CONV_STAGING_BYTES) // stage
    return dict(rows=rows, cols=cols, stages=stages,
                smem_bytes=stages * stage + CONV_STAGING_BYTES + 1024)


def conv_tile(t_out: int, c_out: int) -> int:
    """The tile id for a layer of t_out rows a batch element and C_out
    columns: the one with fewer tiles (each tile is the same work, so fewer
    tiles is less padding and fewer waves), 128 x 128 on a tie. On HuBERT's
    chain: 128 x 128 up to layer 5, 64 x 256 for layer 6 (319 rows: 5 x 2
    tiles a batch element against 3 x 4; the faster there in
    ``chip_smoke.py --profile``)."""
    counts = [-(-t_out // rows) * -(-c_out // cols) for rows, cols in CONV_TILES]
    return 0 if counts[0] < counts[1] else 1


def conv_layer(x: torch.Tensor, w: torch.Tensor, k: int,
               tile: Optional[int] = None) -> torch.Tensor:
    """One layer on the kernel: x (B, T, C_in) bf16 contiguous on the card,
    w (k, C_in, C_out) -> (B, T_out, C_out) bf16; ``tile`` overrides the
    tile id (for measurements). Launch counts are per chain, in
    ``fused_conv_chain``."""
    if x.device.type != "cuda" or x.dtype != torch.bfloat16:
        raise ValueError(f"fused_conv_chain: the kernel takes bf16 CUDA tensors, got "
                         f"{x.dtype} on {x.device}")
    b, t, c = x.shape
    segments = fold_segments(t, c, k)
    if w.shape[:2] != (k, c) or w.shape[2] % 8 or c % 8:
        raise ValueError(
            f"fused_conv_chain: weight {tuple(w.shape)} for a (k={k}, C_in={c}) "
            "layer; channels must be multiples of 8"
        )
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("fused_conv_chain: x must be contiguous and 16-byte aligned")
    n = w.shape[2]
    t_out = layer_out_len(t, k)
    tile = conv_tile(t_out, n) if tile is None else tile
    w2 = w.to(device=x.device, dtype=torch.bfloat16).reshape(k * c, n).contiguous()
    out = torch.empty((b, t_out, n), dtype=torch.bfloat16, device=x.device)
    seg = (ctypes.c_longlong * (6 * len(segments)))(
        *[v for s in segments for v in dataclasses.astuple(s)])
    _build.check(
        _build.load().scl_conv_chain_layer(
            x.data_ptr(), w2.data_ptr(), out.data_ptr(), b, t_out, k * c, n,
            len(segments), seg, tile, _build.stream(x.device)),
        "scl_conv_chain_layer",
    )
    return out


def layer_out_len(t_in: int, k: int) -> int:
    return (t_in - k) // 2 + 1


def chain_out_len(t: int, kernels: Sequence[int]) -> int:
    for k in kernels:
        t = layer_out_len(t, k)
    return t


def window_for(out_block: int, kernels: Sequence[int]) -> int:
    """Input rows needed to produce ``out_block`` output rows through the
    chain (stride 2 each layer), rounded up to even: the TPU kernel's
    per-block VMEM window (4112 rows for 64 frames of HuBERT's chain)."""
    need = out_block
    for k in reversed(kernels):
        need = (need - 1) * 2 + k
    return need + (need % 2)


def fused_conv_chain_plain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                           kernels: Sequence[int]) -> torch.Tensor:
    """The plain PyTorch version: each layer an f32 ``conv1d`` of the
    upcast operands (exact products, f32 sums; TF32 off), erf GELU in f32,
    one rounding to x's dtype."""
    dtype = x.dtype
    cudnn = torch.backends.cudnn
    for w, k in zip(weights, kernels):
        if w.shape[0] != k:
            raise ValueError(f"weight of shape {tuple(w.shape)} for kernel size {k}")
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            y = F.conv1d(x.float().transpose(1, 2), w.float().permute(2, 1, 0), stride=2)
        x = F.gelu(y).transpose(1, 2).to(dtype)
    return x


def fused_conv_chain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                     kernels: Sequence[int], plain: bool = False) -> torch.Tensor:
    """x (B, T, C) -> (B, T_out, C_out), T_out by VALID conv arithmetic,
    through the op ``speechclip::fused_conv_chain``. CPU tensor or
    ``plain``: the plain version. CUDA tensor: the kernel, or an exception;
    forward-only, as in JAX: an input that requires grad raises there (on
    a CPU tensor the plain version's own autograd takes it)."""
    kernels = tuple(kernels)
    if len(weights) != len(kernels):
        raise ValueError(f"{len(weights)} weights for {len(kernels)} kernel sizes")
    if plain:
        return fused_conv_chain_plain(x, weights, kernels)
    _ops.check_device(x, "fused_conv_chain")
    if needs_grad(x, *weights):
        if x.device.type == "cpu":
            return fused_conv_chain_plain(x, weights, kernels)
        raise RuntimeError("fused_conv_chain: kernel path is forward-only: an input requires grad")
    return _ops.fused_conv_chain(x, list(weights), [int(k) for k in kernels])


def check_chain_operands(x: torch.Tensor, weights: Sequence[torch.Tensor],
                         kernels: Sequence[int]) -> None:
    """What the kernel takes (bf16 on the card, a T the chain's window fits,
    kernel sizes 2 and 3, (k, C_in, C_out) weights with channels a multiple
    of 8); anything else raises."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_chain: kernel path needs CUDA tensors, got {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"fused_conv_chain: kernel path runs bf16, got {x.dtype}")
    if chain_out_len(x.shape[1], kernels) < 1:
        raise ValueError(f"fused_conv_chain: T = {x.shape[1]} is shorter than the chain's window")
    if any(k not in KERNEL_SIZES for k in kernels):
        raise ValueError(
            f"fused_conv_chain: the kernel takes kernel sizes {KERNEL_SIZES}, got {tuple(kernels)}")
    c = x.shape[2]
    for w, k in zip(weights, kernels):
        if tuple(w.shape[:2]) != (k, c) or w.shape[2] % 8 or c % 8:
            raise ValueError(
                f"fused_conv_chain: weight {tuple(w.shape)} for a (k={k}, C_in={c}) "
                "layer; channels must be multiples of 8"
            )
        c = w.shape[2]


def fused_conv_chain_cuda(x: torch.Tensor, weights: Sequence[torch.Tensor],
                          kernels: Sequence[int]) -> torch.Tensor:
    """The op's CUDA implementation: one kernel launch a layer, counted once
    a chain in ``fused_conv_chain.launches``; zero rows return the empty
    output without a launch."""
    check_chain_operands(x, weights, kernels)
    if x.shape[0] == 0:
        return x.new_empty((0, chain_out_len(x.shape[1], kernels), weights[-1].shape[2]))
    h = x.contiguous()
    for w, k in zip(weights, kernels):
        h = conv_layer(h, w, k)
    fused_conv_chain.launches += 1
    return h


fused_conv_chain.launches = 0


def conv_chain_agreement(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Max abs error, smallest row cosine, share of elements that differ."""
    g = got.float().reshape(-1, got.shape[-1])
    w = want.float().reshape(-1, want.shape[-1])
    diff = (g - w).abs()
    cos = F.cosine_similarity(g, w, dim=-1, eps=1e-30)
    cos = torch.where((g == w).all(dim=-1), torch.ones_like(cos), cos)
    return dict(max_abs_err=float(diff.max()), min_cosine=float(cos.min()),
                mismatch=float((diff > 0).float().mean()),
                finite=bool(torch.isfinite(g).all()))
