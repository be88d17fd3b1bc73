"""The port's kernels as ``torch.library`` custom ops, namespace ``speechclip``.

One op per JAX kernel function, so a graph exported with ``torch.export``
holds one node per kernel call, as the JAX package's StableHLO holds one
custom call per ``pallas_call``:

- ``speechclip::mha_layer_block`` (``kernels/mha_block.py``);
- ``speechclip::ffn_block`` (``kernels/ffn_block.py``);
- ``speechclip::attention_vmem`` (``kernels/attention_vmem.py``);
- ``speechclip::flash_attention`` (``kernels/flash_attention.py``; the
  operands' dtype picks the bf16 form or the f32 form);
- ``speechclip::fused_conv_chain`` (``kernels/conv_frontend.py``);

and one op of the port's own, which no JAX kernel function corresponds to:

- ``speechclip::pos_conv`` (``kernels/pos_conv.py``): HuBERT's grouped
  k = 128 positional conv with its bias, GELU and residual, in place of
  cuDNN's grouped conv (JAX leaves that conv to XLA).

Each op has three implementations:

- CPU: the kernel's plain PyTorch version;
- CUDA: the hand-written kernel (the kernel module's ``*_cuda`` function,
  which counts its launches; at zero output rows it returns the empty
  output without a launch), or an exception for operands it does not take;
- fake (tracing, ``torch.export``): an empty tensor of the output's shape,
  dtype, device and layout, after the operand checks the CUDA
  implementation runs before a launch when the operands lie on the card, so
  a shape the kernel refuses fails at export time and not in a served
  request.

No other device has an implementation: the op raises there. The attention
ops return (B, H, L, Dh) laid out as (B, L, H, Dh) on every device, so the
ops do not tie a traced graph to its device (``export.to_device`` says
what does). The ops carry no autograd:
the wrappers put their ``torch.autograd.Function`` (``_plain_grad``) around
them, whose forward runs the op with grad mode off.

Importing this module registers the ops and nothing else: the kernel
modules are imported at an op's first call, so a loaded artifact needs
neither the model code nor a build before it runs.
"""

from typing import List, Optional

import torch
from torch import Tensor

NAMESPACE = "speechclip"


def _op(name: str):
    return torch.library.custom_op(f"{NAMESPACE}::{name}", mutates_args=(), device_types="cpu")


def op_name(node_target) -> Optional[str]:
    """The kernel an exported graph node calls (``mha_layer_block``, ...),
    or None."""
    name = getattr(node_target, "name", None)
    name = name() if callable(name) else name
    if not isinstance(name, str) or not name.startswith(f"{NAMESPACE}::"):
        return None
    return name.split("::", 1)[1].split(".", 1)[0]


def check_device(t: Tensor, what: str) -> None:
    """The ops run on CPU tensors (the plain versions) and CUDA tensors (the
    kernels); a tensor elsewhere raises before the call."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: kernel path needs a CUDA tensor, got {t.device}")


# --------------------------------------------------------------- mha_layer_block
@_op("mha_layer_block")
def mha_layer_block(x: Tensor, w_in: Tensor, b_in: Tensor, w_out: Tensor, b_out: Tensor,
                    ln_g: Optional[Tensor], ln_b: Optional[Tensor], lens: Optional[Tensor],
                    heads: int, ln_mode: str, eps: float) -> Tensor:
    from .mha_block import mha_layer_block_plain

    return mha_layer_block_plain(x, w_in, b_in, w_out, b_out, ln_g, ln_b, lens, heads,
                                 ln_mode, eps)


@mha_layer_block.register_kernel("cuda")
def _(x, w_in, b_in, w_out, b_out, ln_g, ln_b, lens, heads, ln_mode, eps):
    from .mha_block import mha_layer_block_cuda

    return mha_layer_block_cuda(x, w_in, b_in, w_out, b_out, ln_g, ln_b, lens, heads,
                                ln_mode, eps)


@mha_layer_block.register_fake
def _(x, w_in, b_in, w_out, b_out, ln_g, ln_b, lens, heads, ln_mode, eps):
    if x.device.type == "cuda":
        from .mha_block import check_block_operands

        check_block_operands(x, (w_in, b_in, w_out, b_out, ln_g, ln_b), heads)
    return x.new_empty(x.shape)


# --------------------------------------------------------------------- ffn_block
@_op("ffn_block")
def ffn_block(x: Tensor, w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor,
              ln_g: Optional[Tensor], ln_b: Optional[Tensor], ln_mode: str,
              eps: float) -> Tensor:
    from .ffn_block import ffn_block_plain

    return ffn_block_plain(x, w1, b1, w2, b2, ln_g, ln_b, ln_mode, eps)


@ffn_block.register_kernel("cuda")
def _(x, w1, b1, w2, b2, ln_g, ln_b, ln_mode, eps):
    from .ffn_block import ffn_block_cuda

    return ffn_block_cuda(x, w1, b1, w2, b2, ln_g, ln_b, ln_mode, eps)


@ffn_block.register_fake
def _(x, w1, b1, w2, b2, ln_g, ln_b, ln_mode, eps):
    if x.device.type == "cuda":
        from .mha_block import check_cuda_operands

        check_cuda_operands(x, w1, b1, w2, b2, ln_g, ln_b)
    return x.new_empty(x.shape)


# --------------------------------------------------------------- attention_vmem
@_op("attention_vmem")
def attention_vmem(q: Tensor, k: Tensor, v: Tensor, lens: Optional[Tensor],
                   causal: bool) -> Tensor:
    from ._attention_common import heads_layout
    from .attention_vmem import attention_vmem_plain

    return heads_layout(attention_vmem_plain(q, k, v, lens, causal))


@attention_vmem.register_kernel("cuda")
def _(q, k, v, lens, causal):
    from .attention_vmem import attention_vmem_cuda

    return attention_vmem_cuda(q, k, v, lens, causal)


@attention_vmem.register_fake
def _(q, k, v, lens, causal):
    from ._attention_common import check_attention_operands, empty_heads_out

    if q.device.type == "cuda":
        check_attention_operands(q, k, v, lens, "attention_vmem")
    return empty_heads_out(*q.shape, q.device, q.dtype)


# -------------------------------------------------------------- flash_attention
@_op("flash_attention")
def flash_attention(q: Tensor, k: Tensor, v: Tensor, lens: Optional[Tensor],
                    causal: bool) -> Tensor:
    from ._attention_common import heads_layout
    from .flash_attention import flash_attention_plain

    return heads_layout(flash_attention_plain(q, k, v, lens, causal))


@flash_attention.register_kernel("cuda")
def _(q, k, v, lens, causal):
    from .flash_attention import flash_attention_cuda

    return flash_attention_cuda(q, k, v, lens, causal)


@flash_attention.register_fake
def _(q, k, v, lens, causal):
    from ._attention_common import empty_heads_out
    from .flash_attention import check_flash_operands

    if q.device.type == "cuda":
        check_flash_operands(q, k, v, lens)
    return empty_heads_out(*q.shape, q.device, q.dtype)


# ------------------------------------------------------------- fused_conv_chain
@_op("fused_conv_chain")
def fused_conv_chain(x: Tensor, weights: List[Tensor], kernels: List[int]) -> Tensor:
    from .conv_frontend import fused_conv_chain_plain

    return fused_conv_chain_plain(x, weights, kernels).contiguous()


@fused_conv_chain.register_kernel("cuda")
def _(x, weights, kernels):
    from .conv_frontend import fused_conv_chain_cuda

    return fused_conv_chain_cuda(x, weights, kernels)


@fused_conv_chain.register_fake
def _(x, weights, kernels):
    from .conv_frontend import chain_out_len, check_chain_operands

    if x.device.type == "cuda":
        check_chain_operands(x, weights, kernels)
    return x.new_empty((x.shape[0], chain_out_len(x.shape[1], kernels), weights[-1].shape[2]))


# --------------------------------------------------------------------- pos_conv
@_op("pos_conv")
def pos_conv(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    from .pos_conv import pos_conv_plain

    return pos_conv_plain(x, w, b).contiguous()


@pos_conv.register_kernel("cuda")
def _(x, w, b):
    from .pos_conv import pos_conv_cuda

    return pos_conv_cuda(x, w, b)


@pos_conv.register_fake
def _(x, w, b):
    if x.device.type == "cuda":
        from .pos_conv import check_operands

        check_operands(x, w, b)
    return x.new_empty(x.shape)
