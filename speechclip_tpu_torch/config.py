"""Model presets of the port: plain dataclasses, no YAML.

``base_config()`` is SpeechCLIP base with the parallel branch only, the
flagship inference path (HuBERT-base, a 1-layer 8-head branch transformer,
a 768 -> 512 projection into the ViT-B/32 image-embedding space, bf16).
``tiny_config()`` keeps that topology at tiny widths for the CPU tests.
Both mirror the JAX package's ``flagship_config()`` /
``flagship_tiny_config()`` with the cascaded objective weight set to 0.

The cascaded branch (K keyword CLS rows -> one 768-wide attention head ->
kw-BN -> VQ over the CLIP subword vocabulary -> the CLIP text tower):
``base_cascaded_config()`` is the JAX ``bench_variant_config("base_casc")``
(full 49408-row vocabulary); ``shipped_cascaded_config()`` is
``configs/base/spchclp_c.yaml`` (the reduced Flickr vocabulary, 8112 rows);
``tiny_flagship_config()`` is ``flagship_tiny_config()`` with both branches
live.

The CLIP towers (the named presets of speechclip_tpu/models/clip.py): the
image tower is a ViT (``CLIPVisionConfig``: ViT-B/32, the base configs';
ViT-B/16; ViT-L/14, the large configs') or a ModifiedResNet
(``CLIPResNetVisionConfig``: RN50 ... RN50x64), each with its text tower
(``NAMED_CLIP_CONFIGS``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

from .models.hubert import HUBERT_BASE, HubertConfig


@dataclasses.dataclass(frozen=True)
class BranchConfig:
    """``model_settings.parallel_branch`` (a TransformerEncoder); ``dropout``
    is its ``transformer_args.dropout`` (attention weights, the attention
    output, the FFN's middle and output, in train mode)."""

    n_layers: int = 1
    d_model: int = 768
    nhead: int = 8
    dim_feedforward: int = 3072
    activation: str = "gelu"
    layer_norm_eps: float = 1e-5
    norm_first: bool = False
    need_projection: bool = True
    dropout: float = 0.1


@dataclasses.dataclass(frozen=True)
class CascadedBranchConfig:
    """``model_settings.cascaded_branch``: the branch body
    (``transformer_type`` and its ``transformer_args``, ``dropout`` on the
    attention weights in train mode), the keywords (``keyword.number``,
    ``keyword.kw_projection.dimensions`` and ``.dropout``,
    ``keyword.batchnorms``, whose ``replica_groups`` splits the batch into
    groups with their own train-mode statistics) and the VQ's ``vq.args``."""

    transformer_type: str = "MultiheadAttentionAndNorm"
    n_layers: int = 1
    d_model: int = 768
    nhead: int = 1
    dim_feedforward: int = 3072
    activation: str = "gelu"
    layer_norm_eps: float = 1e-5
    norm_first: bool = False
    keyword_number: int = 8
    kw_projection: Optional[Tuple[int, ...]] = None
    kw_projection_dropout: float = 0.1
    batchnorm_type: Optional[str] = "eachKw"  # None: no kw-BN
    bn_std_scale: Union[float, Tuple[float, ...]] = 1.0
    bn_parallel: bool = True
    vq_temp: Union[str, float] = "fixed=0.1"
    use_gumbel: bool = False
    hard: bool = True
    ground_truth_perplexity: Optional[float] = None
    dropout: float = 0.1
    bn_replica_groups: int = 0


@dataclasses.dataclass(frozen=True)
class ContrastiveLossConfig:
    """``cl_loss``: ``type`` MaskedContrastiveLoss or SupConLoss and its
    ``args`` (SupCon reads ``temperature``, ``temperature_trainable``,
    ``contrast_mode`` and ``base_temperature``)."""

    type: str = "MaskedContrastiveLoss"
    temperature: float = 0.07
    temperature_trainable: bool = False
    margin: float = 0.0
    dcl: bool = False
    a2b: bool = True
    b2a: bool = True
    contrast_mode: str = "all"
    base_temperature: float = 0.07


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """``audio_encoder.optim``: Adam (L2 decay in the gradient) or AdamW."""

    name: str = "Adam"
    lr: float = 1e-4
    weight_decay: float = 1e-6
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """``audio_encoder.scheduler``: ``noam`` (reads ``warmup``) or
    ``linear_warmup_decay``."""

    name: str = "linear_warmup_decay"
    warmup: int = 5000
    max_step: int = 50000
    final_lr: float = 1e-8


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """The CLIP text tower (ViT-B/32's by default)."""

    vocab_size: int = 49408
    context_length: int = 77
    width: int = 512
    layers: int = 12
    heads: int = 8
    output_dim: int = 512


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """The CLIP vision transformer (ViT-B/32's by default)."""

    image_size: int = 224
    patch_size: int = 32
    width: int = 768
    layers: int = 12
    heads: int = 12
    output_dim: int = 512


@dataclasses.dataclass(frozen=True)
class CLIPResNetVisionConfig:
    """CLIP's ModifiedResNet image tower (RN50's by default): a 3-conv stem
    and 2x2 average pool, four stages of bottlenecks whose stride-2 step is
    a 2x2 average pool, and an AttentionPool2d over the final grid."""

    image_size: int = 224
    width: int = 64  # stem width; stage channels are width * (1, 2, 4, 8) * 4
    layers: Tuple[int, int, int, int] = (3, 4, 6, 3)
    heads: int = 32  # attnpool heads
    output_dim: int = 1024

    @property
    def embed_dim(self) -> int:
        """The attnpool's input channels (stage 4's output)."""
        return self.width * 32

    @property
    def feature_grid(self) -> int:
        """The grid's side after the 32x downsample."""
        return self.image_size // 32


VisionConfig = Union[CLIPVisionConfig, CLIPResNetVisionConfig]


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    """One named CLIP model: its image tower and its text tower."""

    vision: VisionConfig = CLIPVisionConfig()
    text: CLIPTextConfig = CLIPTextConfig()


def _rn(image_size, width, layers, heads, output_dim, text_width, text_heads) -> CLIPConfig:
    return CLIPConfig(
        vision=CLIPResNetVisionConfig(image_size=image_size, width=width, layers=layers,
                                      heads=heads, output_dim=output_dim),
        text=CLIPTextConfig(width=text_width, heads=text_heads, output_dim=output_dim),
    )


NAMED_CLIP_CONFIGS = {
    "RN50": _rn(224, 64, (3, 4, 6, 3), 32, 1024, 512, 8),
    "RN101": _rn(224, 64, (3, 4, 23, 3), 32, 512, 512, 8),
    "RN50x4": _rn(288, 80, (4, 6, 10, 6), 40, 640, 640, 10),
    "RN50x16": _rn(384, 96, (6, 8, 18, 8), 48, 768, 768, 12),
    "RN50x64": _rn(448, 128, (3, 15, 36, 10), 64, 1024, 1024, 16),
    "ViT-B/32": CLIPConfig(),
    "ViT-B/16": CLIPConfig(vision=CLIPVisionConfig(patch_size=16)),
    "ViT-L/14": CLIPConfig(
        vision=CLIPVisionConfig(patch_size=14, width=1024, layers=24, heads=16, output_dim=768),
        text=CLIPTextConfig(width=768, heads=12, output_dim=768),
    ),
}


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
    cascaded_branch: CascadedBranchConfig = CascadedBranchConfig()
    # model_settings.cascaded_branch_projection.dimensions, when set
    cascaded_branch_projection: Optional[Tuple[int, ...]] = None
    clip_text: CLIPTextConfig = CLIPTextConfig()
    clip_vision: VisionConfig = CLIPVisionConfig()
    # model_settings.image_encoder_projection.dimensions, when set
    image_encoder_projection: Optional[Tuple[int, ...]] = None
    # clip.reduce_subword_embbedding: a (V_red, 2) table of original ids and
    # counts; the text tower's token table is cut to those rows
    reduce_subword_embedding: Optional[str] = None
    clip_embed_dim: int = 512  # ViT-B/32 image embedding width
    precision: Union[int, str] = 16  # 16 / "bf16" -> bf16, 32 -> f32
    # model_settings.*_projection.dropout
    parallel_branch_projection_dropout: float = 0.1
    cascaded_branch_projection_dropout: float = 0.1
    image_encoder_projection_dropout: float = 0.1
    # which towers train: audio_encoder.trainable (with reinit_layers /
    # unfreeze_layers), clip.image_encoder_trainable, .text_encoder_trainable
    audio_trainable: bool = False
    reinit_layers: Tuple[int, ...] = ()
    unfreeze_layers: Tuple[int, ...] = ()
    image_encoder_trainable: bool = False
    text_encoder_trainable: bool = False
    cl_loss: ContrastiveLossConfig = ContrastiveLossConfig()
    optim: OptimizerConfig = OptimizerConfig()
    scheduler: SchedulerConfig = SchedulerConfig()
    gradient_clip_val: float = 4.0  # trainer.gradient_clip_val; 0: no clip
    accumulate_grad_batches: int = 1
    # retrieval.audio_feat_src: the branch whose features the eval step returns
    retrieval_audio_feat_src: Optional[str] = "parallel"


FLICKR_VOCAB = "assets/flickr_stat/text_clip_vocab_usage_byfreq.npy"


def base_config() -> SpeechCLIPConfig:
    """SpeechCLIP base, parallel branch only."""
    return SpeechCLIPConfig()


def flagship_config() -> SpeechCLIPConfig:
    """SpeechCLIP base with both branches live (the JAX ``flagship_config()``):
    full CLIP vocabulary, both objective weights 1.0."""
    return SpeechCLIPConfig(cascaded_objective_weight=1.0)


def base_cascaded_config() -> SpeechCLIPConfig:
    """SpeechCLIP base, cascaded branch only, full CLIP vocabulary."""
    return SpeechCLIPConfig(parallel_objective_weight=0.0, cascaded_objective_weight=1.0)


def shipped_cascaded_config() -> SpeechCLIPConfig:
    """``configs/base/spchclp_c.yaml``: the cascaded branch over the reduced
    Flickr subword vocabulary."""
    return dataclasses.replace(base_cascaded_config(), reduce_subword_embedding=FLICKR_VOCAB,
                               retrieval_audio_feat_src="cascaded")


def tiny_flagship_config() -> SpeechCLIPConfig:
    """Both branches live at tiny widths (``flagship_tiny_config()``)."""
    return SpeechCLIPConfig(
        audio=HubertConfig(
            conv_layers=((16, 10, 5), (16, 3, 2), (16, 3, 2)),
            encoder_embed_dim=32,
            encoder_layers=2,
            encoder_ffn_dim=64,
            encoder_heads=4,
            downsample_rate=20,
        ),
        cascaded_objective_weight=1.0,
        parallel_branch=BranchConfig(d_model=32, nhead=4, dim_feedforward=64),
        cascaded_branch=CascadedBranchConfig(d_model=32, dim_feedforward=64, keyword_number=4),
        clip_text=CLIPTextConfig(vocab_size=64, width=32, layers=2, heads=4, output_dim=16),
        clip_vision=CLIPVisionConfig(image_size=32, patch_size=8, width=32, layers=2, heads=4,
                                     output_dim=16),
        clip_embed_dim=16,
    )


def tiny_config() -> SpeechCLIPConfig:
    return dataclasses.replace(tiny_flagship_config(), cascaded_objective_weight=0.0)
