"""The yardstick's arithmetic: the H100's peaks, the model FLOPs of a step,
and each ``speechclip::*`` custom op's least time from its call shapes.

Model FLOPs count matrix products and convolutions at 2 FLOPs a
multiply-add, at the shapes the step computes (the bucket's padded length).
Frozen towers count their forward only; a trainable part its forward and
its backward (the input's gradient and the weights'), twice the forward.
Recomputes, elementwise work and normalizations are not counted.

An op's bound is max(FLOPs / peak FLOP/s, bytes / peak bytes/s): each input
byte read once and each output byte written once, and the work these
inputs need: attention counts every query row against the valid keys only
(``valid_keys``, the mean share of keys inside the batch's lengths).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

DTYPE_BYTES = {"c10::BFloat16": 2, "c10::Half": 2, "float": 4, "int": 4, "long int": 8,
               "double": 8, "bool": 1, "unsigned char": 1, "short int": 2}


# ---------------------------------------------------------------- model FLOPs
def conv_out_len(length: int, layers: Sequence[Sequence[int]]) -> List[int]:
    out = []
    for _ch, k, s in layers:
        length = (length - k) // s + 1
        out.append(length)
    return out


def encoder_layer_flops(b: int, t: int, d: int, f: int) -> float:
    """One transformer layer's forward: QKV, out-projection, the two FFN
    products, and scores + weighted values over all T x T."""
    return 2.0 * b * t * (4 * d * d + 2 * d * f) + 4.0 * b * t * t * d


def hubert_flops(a: Dict, b: int, samples: int) -> float:
    lens = conv_out_len(samples, a["conv_layers"])
    total, in_ch = 0.0, 1
    for (ch, k, _s), n in zip(a["conv_layers"], lens):
        total += 2.0 * b * n * ch * in_ch * k
        in_ch = ch
    t, d, f = lens[-1], a["encoder_embed_dim"], a["encoder_ffn_dim"]
    total += 2.0 * b * t * in_ch * d  # post_extract_proj
    total += 2.0 * b * t * d * (d // a["pos_conv_groups"]) * a["pos_conv_kernel"]
    total += a["encoder_layers"] * encoder_layer_flops(b, t, d, f)
    return total


def branch_flops(br: Dict, out_dim: int, b: int, frames: int) -> float:
    t, d, f = frames + 1, br["d_model"], br["dim_feedforward"]
    return br["n_layers"] * encoder_layer_flops(b, t, d, f) + 2.0 * b * d * out_dim


def train_step_flops(sizes: Dict, b: int, samples: int) -> float:
    """Frozen HuBERT forward; the branch and the loss forward and backward."""
    a, br, e = sizes["audio"], sizes["parallel_branch"], sizes["vision"]["output_dim"]
    frames = conv_out_len(samples, a["conv_layers"])[-1]
    loss = 2.0 * b * b * e
    return hubert_flops(a, b, samples) + 3.0 * (branch_flops(br, e, b, frames) + loss)


def encode_flops(sizes: Dict, b: int, samples: int, gallery: int) -> float:
    """HuBERT and the branch forward, then the scores against the gallery."""
    a, br, e = sizes["audio"], sizes["parallel_branch"], sizes["vision"]["output_dim"]
    frames = conv_out_len(samples, a["conv_layers"])[-1]
    return hubert_flops(a, b, samples) + branch_flops(br, e, b, frames) + 2.0 * b * gallery * e


# ---------------------------------------------------------------- op bounds
def _numel(shape: Sequence[int]) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _bytes(shapes, dtypes) -> float:
    total = 0.0
    for shape, dtype in zip(shapes, dtypes):
        if shape:
            total += _numel(shape) * DTYPE_BYTES.get(dtype, 4)
    return total


def op_cost(name: str, shapes: Sequence[Sequence[int]], dtypes: Sequence[str],
            valid_keys: float) -> Optional[Dict[str, float]]:
    """{"flops", "bytes"} of one call of ``speechclip::<name>`` with these
    input shapes and dtypes (the profiler's record, positional), or None
    for an op this file does not know. The output has the shape and dtype
    of the first input."""
    if not shapes or not shapes[0]:
        return None
    x = [int(s) for s in shapes[0]]
    out_bytes = _numel(x) * DTYPE_BYTES.get(dtypes[0], 4)
    in_bytes = _bytes(shapes, dtypes)
    if name == "mha_layer_block":
        b, t, d = x
        has_lens = len(shapes) > 7 and bool(shapes[7])
        keys = t * (valid_keys if has_lens else 1.0)
        flops = 2.0 * b * t * 4 * d * d + 4.0 * b * t * keys * d
    elif name == "ffn_block":
        b, t, d = x
        f = int(shapes[1][1])
        flops = 4.0 * b * t * d * f
    elif name in ("attention_vmem", "flash_attention"):
        b, h, t, dh = x
        s = int(shapes[1][2])
        has_lens = len(shapes) > 3 and bool(shapes[3])
        keys = s * (valid_keys if has_lens else 1.0)
        flops = 4.0 * b * h * t * keys * dh
        out_bytes = _numel(x) * DTYPE_BYTES.get(dtypes[0], 4)
    else:
        return None
    return {"flops": flops, "bytes": in_bytes + out_bytes}


def bound_seconds(cost: Dict[str, float], f32: bool = False) -> float:
    peak = PEAK_F32_FLOPS if f32 else PEAK_BF16_FLOPS
    return max(cost["flops"] / peak, cost["bytes"] / PEAK_HBM_BYTES)
