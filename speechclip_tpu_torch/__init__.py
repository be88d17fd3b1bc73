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
``training/checkpoint.py``; with the CLIP tokenizer of
``models/tokenizer.py``, the keyword diagnostics); the s3prl upstreams APC
and CPC (``models/upstream.py``) in HuBERT's place; and ``ClipWrapper``
(``models/clip_api.py``), the pooling heads and the text metrics. The encoder
layers take the JAX package's length-dependent routes (``ops/attention.py``,
``kernels/fused_layer.py``) through hand-written Hopper kernels (``csrc/``:
the two fused half-layers, whole-row attention, streaming flash attention
at any head width, and the stride-2 conv chain) on CUDA tensors, and
through their plain PyTorch versions on CPU tensors. Entry points run on
the card unless the caller passes ``device="cpu"``.

The package imports torch, numpy and the standard library (PIL, regex and
scipy inside the functions that need them): never jax, yaml or
speechclip_tpu.
"""

import importlib

# The public names, each imported at first use (PEP 562): a loaded export
# artifact imports ``speechclip_tpu_torch.kernels._ops`` alone, and the
# package's own import pulls in neither the config nor the model code.
_EXPORTS = {
    "SpeechCLIPConfig": "config",
    "base_cascaded_config": "config",
    "base_config": "config",
    "bench_variant_config": "config",
    "flagship_config": "config",
    "flagship_large_config": "config",
    "shipped_cascaded_config": "config",
    "tiny_config": "config",
    "tiny_flagship_config": "config",
    "SpeechCLIPModel": "models.speechclip",
    "recall_at_k": "ops.retrieval",
    "retrieve": "ops.retrieval",
}
__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
