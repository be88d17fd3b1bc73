"""PyTorch/CUDA port of speechclip_tpu for one NVIDIA H100.

The JAX package ``speechclip_tpu`` is the reference; module paths here mirror
it (``ops/basic.py`` <-> ``ops/basic.py`` ...). This first slice runs the
SpeechCLIP-base parallel-branch inference path: waveform -> HuBERT-base ->
weighted sum -> parallel branch -> L2-normalized features -> top-k against
an image-embedding gallery. The two transformer half-layers of every encoder
layer run as hand-written Hopper kernels (``csrc/``) on CUDA tensors and as
their plain PyTorch versions on CPU tensors.

The package imports torch and numpy only: never jax, yaml or speechclip_tpu.
"""

from .config import SpeechCLIPConfig, base_config, tiny_config
from .models.speechclip import SpeechCLIPModel
from .ops.retrieval import recall_at_k, retrieve

__all__ = [
    "SpeechCLIPConfig",
    "SpeechCLIPModel",
    "base_config",
    "recall_at_k",
    "retrieve",
    "tiny_config",
]
