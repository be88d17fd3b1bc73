"""PyTorch/CUDA port of speechclip_tpu for one NVIDIA H100.

The JAX package ``speechclip_tpu`` is the reference; module paths here mirror
it (``ops/basic.py`` <-> ``ops/basic.py`` ...). It runs SpeechCLIP-base and
-large inference: waveform -> HuBERT-base or -large -> weighted sum -> the
parallel branch and/or the cascaded branch (keywords -> kw-BN -> VQ over the
CLIP subword vocabulary -> the CLIP text tower) -> L2-normalized features ->
top-k against an image-embedding gallery, at any utterance length; and the
gallery side: uint8 images -> on-device resize and normalize -> the CLIP
image tower (ViT or ModifiedResNet) -> the image projection, the CLIP text
tower over token ids, and the validation epoch's two-way retrieval eval
(``training/evaluation.py``); and the training step of the base and large
flagships (``training/train_step.py``: both branches over the frozen HuBERT
and CLIP towers, the contrastive loss, clip, Adam and the LR schedule; with
``wsum_remat`` the frozen HuBERT's weighted sum recomputes the encoder in
the backward instead of keeping its hidden states), whose kernels take
their gradients from a recompute through their plain versions,
as the JAX package's ``custom_vjp``s do; and the trainer
(``python -m speechclip_tpu_torch.run_task``: the YAML config tree read by
``config.load_config``, the bucketed Flickr8k / SpokenCOCO loaders of
``data/``, ``training/trainer.py``'s fit and validation, the checkpoints of
``training/checkpoint.py``). The encoder
layers take the JAX package's length-dependent routes (``ops/attention.py``,
``kernels/fused_layer.py``) through hand-written Hopper kernels (``csrc/``:
the two fused half-layers, whole-row attention, streaming flash attention
at any head width, and the stride-2 conv chain) on CUDA tensors, and
through their plain PyTorch versions on CPU tensors. Entry points run on
the card unless the caller passes ``device="cpu"``.

The package imports torch, numpy and the standard library (PIL and scipy
inside the functions that need them): never jax, yaml, regex or
speechclip_tpu.
"""

from .config import (
    SpeechCLIPConfig,
    base_cascaded_config,
    base_config,
    bench_variant_config,
    flagship_config,
    flagship_large_config,
    shipped_cascaded_config,
    tiny_config,
    tiny_flagship_config,
)
from .models.speechclip import SpeechCLIPModel
from .ops.retrieval import recall_at_k, retrieve

__all__ = [
    "SpeechCLIPConfig",
    "SpeechCLIPModel",
    "base_cascaded_config",
    "base_config",
    "bench_variant_config",
    "flagship_config",
    "flagship_large_config",
    "recall_at_k",
    "retrieve",
    "shipped_cascaded_config",
    "tiny_config",
    "tiny_flagship_config",
]
