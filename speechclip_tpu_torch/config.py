"""Model presets of the port: plain dataclasses, no YAML.

``base_config()`` is SpeechCLIP base with the parallel branch only, the
flagship inference path (HuBERT-base, a 1-layer 8-head branch transformer,
a 768 -> 512 projection into the ViT-B/32 image-embedding space, bf16).
``tiny_config()`` keeps that topology at tiny widths for the CPU tests.
Both mirror the JAX package's ``flagship_config()`` /
``flagship_tiny_config()`` with the cascaded objective weight set to 0.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

from .models.hubert import HUBERT_BASE, HubertConfig


@dataclasses.dataclass(frozen=True)
class BranchConfig:
    """``model_settings.parallel_branch`` (a TransformerEncoder), eval mode:
    no dropout rate."""

    n_layers: int = 1
    d_model: int = 768
    nhead: int = 8
    dim_feedforward: int = 3072
    activation: str = "gelu"
    layer_norm_eps: float = 1e-5
    norm_first: bool = False
    need_projection: bool = True


@dataclasses.dataclass(frozen=True)
class SpeechCLIPConfig:
    audio: HubertConfig = HUBERT_BASE
    audio_encoder_type: str = "FairseqHubert"
    feat_select_idx: Union[str, Tuple[int, ...]] = "weighted_sum"
    normalize_hiddenstates: bool = False
    normalize_type: Optional[str] = None  # "s3prl" | "method1" | "method2"
    wsum_remat: bool = False
    parallel_objective_weight: float = 1.0
    cascaded_objective_weight: float = 0.0
    parallel_branch: BranchConfig = BranchConfig()
    # model_settings.parallel_branch_projection.dimensions, when set
    parallel_branch_projection: Optional[Tuple[int, ...]] = None
    clip_embed_dim: int = 512  # ViT-B/32 image embedding width
    precision: Union[int, str] = 16  # 16 / "bf16" -> bf16, 32 -> f32


def base_config() -> SpeechCLIPConfig:
    return SpeechCLIPConfig()


def tiny_config() -> SpeechCLIPConfig:
    return SpeechCLIPConfig(
        audio=HubertConfig(
            conv_layers=((16, 10, 5), (16, 3, 2), (16, 3, 2)),
            encoder_embed_dim=32,
            encoder_layers=2,
            encoder_ffn_dim=64,
            encoder_heads=4,
            downsample_rate=20,
        ),
        parallel_branch=BranchConfig(d_model=32, nhead=4, dim_feedforward=64),
        clip_embed_dim=16,
    )
