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

The large models (the reference's 4-GPU configs, ``configs/large_*``):
``flagship_large_config()`` is the JAX ``flagship_large_config()``
(HuBERT-large with the s3prl per-state LayerNorm, ViT-L/14, both branches
1024 wide, a trainable loss temperature), and ``bench_variant_config(v)``
the JAX switch ``{base,large}[_par|_casc]`` over the two flagships.

The CLIP towers (the named presets of speechclip_tpu/models/clip.py): the
image tower is a ViT (``CLIPVisionConfig``: ViT-B/32, the base configs';
ViT-B/16; ViT-L/14, the large configs') or a ModifiedResNet
(``CLIPResNetVisionConfig``: RN50 ... RN50x64), each with its text tower
(``NAMED_CLIP_CONFIGS``).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import re
from typing import Any, Iterable, Mapping, Optional, Tuple, Union

from .models.hubert import HUBERT_BASE, HUBERT_LARGE, HubertConfig
from .models.hubert import NAMED_CONFIGS as NAMED_HUBERT_CONFIGS
from .models.upstream import APCConfig, CPCConfig, Upstream, resolve_upstream

# the audio encoder: HuBERT, or an s3prl upstream's config (models/upstream.py)
AudioConfig = Union[HubertConfig, APCConfig, CPCConfig]


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
    # HuBERT for "FairseqHubert" or the hubert family under "s3prl_plus";
    # APCConfig / CPCConfig for the s3prl_plus upstreams apc / modified_cpc
    audio: AudioConfig = HUBERT_BASE
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
    # the frozen towers' weight files (SpeechCLIPModel.load_pretrained):
    # audio_encoder.pretrained_path when audio_encoder.pretrained is set,
    # clip.pretrained_path
    audio_pretrained_path: Optional[str] = None
    clip_pretrained_path: Optional[str] = None


FLICKR_VOCAB = "assets/flickr_stat/text_clip_vocab_usage_byfreq.npy"
HUBERT_BASE_WEIGHTS = "assets/hubert/hubert_base_ls960.pt"
CLIP_VIT_B32_WEIGHTS = "assets/clip/ViT-B-32.pt"


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
                               retrieval_audio_feat_src="cascaded",
                               audio_pretrained_path=HUBERT_BASE_WEIGHTS,
                               clip_pretrained_path=CLIP_VIT_B32_WEIGHTS)


def flagship_large_config() -> SpeechCLIPConfig:
    """The large preset (the JAX ``flagship_large_config()``): the flagship
    with HuBERT-large, the s3prl hidden-state normalization, CLIP ViT-L/14
    (768-wide embeddings), both branch transformers 1024 wide with a 4096
    FFN, and a trainable loss temperature."""
    vit_l14 = NAMED_CLIP_CONFIGS["ViT-L/14"]
    base = flagship_config()
    return dataclasses.replace(
        base, audio=HUBERT_LARGE, normalize_hiddenstates=True, normalize_type="s3prl",
        clip_text=vit_l14.text, clip_vision=vit_l14.vision, clip_embed_dim=vit_l14.text.output_dim,
        cl_loss=dataclasses.replace(base.cl_loss, temperature_trainable=True),
        parallel_branch=dataclasses.replace(base.parallel_branch, d_model=1024,
                                            dim_feedforward=4096),
        cascaded_branch=dataclasses.replace(base.cascaded_branch, d_model=1024,
                                            dim_feedforward=4096))


def _dead_branches_at_default(cfg: SpeechCLIPConfig) -> SpeechCLIPConfig:
    """``cfg`` with each dead branch (objective weight 0) at its dataclass
    default, as ``model_config_from_tree`` reads a config that names it."""
    return dataclasses.replace(
        cfg,
        parallel_branch=(cfg.parallel_branch if cfg.parallel_objective_weight > 0
                         else BranchConfig()),
        cascaded_branch=(cfg.cascaded_branch if cfg.cascaded_objective_weight > 0
                         else CascadedBranchConfig()))


def bench_variant_config(variant: str) -> SpeechCLIPConfig:
    """``{base,large}[_par|_casc]`` (the JAX ``bench_variant_config``): the
    flagship or the large flagship, with ``_par`` keeping the parallel
    branch alone and ``_casc`` the cascaded one."""
    prefix = variant.split("_")[0]
    if prefix == "base":
        cfg = flagship_config()
    elif prefix == "large":
        cfg = flagship_large_config()
    else:
        raise ValueError(f"unknown bench variant {variant!r}")
    if variant.endswith("_par"):
        cfg = dataclasses.replace(cfg, cascaded_objective_weight=0.0)
    elif variant.endswith("_casc"):
        cfg = dataclasses.replace(cfg, parallel_objective_weight=0.0)
    return _dead_branches_at_default(cfg)


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
    return _dead_branches_at_default(
        dataclasses.replace(tiny_flagship_config(), cascaded_objective_weight=0.0))


# ---------------------------------------------------------------------------
# The run configuration tree (port of speechclip_tpu/config.py's ConfigNode
# and load_config): the YAML files of configs/ plus ``key.path=value``
# overrides, read without PyYAML.
# ---------------------------------------------------------------------------


class ConfigTree(dict):
    """A dict with attribute access, recursive wrapping and deep merge."""

    def __init__(self, *sources: Any, **kwargs: Any):
        super().__init__()
        for src in sources:
            if src is not None:
                self.merge_(src)
        if kwargs:
            self.merge_(kwargs)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = _wrap(value)

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, _wrap(value))

    def update(self, *args, **kwargs) -> None:  # type: ignore[override]
        for src in args:
            for k, v in (src.items() if hasattr(src, "keys") else src):
                self[k] = v
        for k, v in kwargs.items():
            self[k] = v

    def setdefault(self, key: str, default: Any = None) -> Any:
        if key not in self:
            self[key] = default
        return self[key]

    def merge_(self, other: Any) -> "ConfigTree":
        """Deep-merge ``other`` into self, in place, later wins: mappings
        merge recursively, any other value (lists too) replaces."""
        if hasattr(other, "__dict__") and not isinstance(other, Mapping):
            other = vars(other)  # argparse.Namespace
        if not isinstance(other, Mapping):
            raise TypeError(f"cannot merge {type(other)!r} into ConfigTree")
        for k, v in other.items():
            if k in self and isinstance(self[k], ConfigTree) and isinstance(v, Mapping):
                self[k].merge_(v)
            else:
                self[k] = v
        return self

    def get_path(self, dotted: str, default: Any = None) -> Any:
        """``tree.get_path("model_settings.cascaded_branch.type")``."""
        node: Any = self
        for part in dotted.split("."):
            if isinstance(node, Mapping) and part in node:
                node = node[part]
            else:
                return default
        return node

    def set_path(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], ConfigTree):
                node[part] = ConfigTree()
            node = node[part]
        node[parts[-1]] = value

    def to_dict(self) -> dict:
        return {k: v.to_dict() if isinstance(v, ConfigTree) else copy.deepcopy(v)
                for k, v in self.items()}

    def to_yaml(self) -> str:
        """Block-style YAML that ``yaml.safe_load`` and ``load_config`` both
        read back to this tree."""
        return "".join(_emit(self.to_dict(), 0))

    def __deepcopy__(self, memo: dict) -> "ConfigTree":
        return ConfigTree({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def __reduce__(self):
        return (ConfigTree, (self.to_dict(),))


def _wrap(value: Any) -> Any:
    if isinstance(value, ConfigTree):
        return copy.deepcopy(value)  # a snapshot: no subtree is shared
    if isinstance(value, Mapping):
        node = ConfigTree()
        for k, v in value.items():
            node[k] = v
        return node
    if isinstance(value, (list, tuple)):
        return [_wrap(v) if isinstance(v, Mapping) else v for v in value]
    return value


# PyYAML's implicit resolvers (YAML 1.1, what ``yaml.safe_load`` applies to
# a plain scalar): so ``1e-4`` is a string and ``1.0e-05`` a float, ``010``
# is octal 8, ``yes``/``off`` are booleans.
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
# resolved by PyYAML to types the config tree does not hold: refused
_REFUSED = re.compile(r"^(?:<<|=|!|&|\*|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:[Tt ].*)?)$")
_TRUE = {"yes", "true", "on"}


class YamlSubsetError(ValueError):
    """A construct outside the YAML subset that ``load_config`` reads."""


def _sexagesimal(text: str, cast) -> Any:
    total = 0
    for part in text.split(":"):
        total = total * 60 + cast(part)
    return total


def resolve_scalar(text: str) -> Any:
    """A plain (unquoted) scalar as ``yaml.safe_load`` resolves it."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in _TRUE
    if _INT.match(text):
        s = text.replace("_", "")
        sign = -1 if s[0] == "-" else 1
        s = s.lstrip("+-")
        if s == "0":
            return 0
        if s.startswith("0b"):
            return sign * int(s[2:], 2)
        if s.startswith("0x"):
            return sign * int(s[2:], 16)
        if ":" in s:
            return sign * _sexagesimal(s, int)
        if s.startswith("0"):
            return sign * int(s, 8)
        return sign * int(s)
    if _FLOAT.match(text):
        s = text.replace("_", "").lower()
        sign = -1.0 if s[0] == "-" else 1.0
        s = s.lstrip("+-")
        if s == ".inf":
            return sign * float("inf")
        if s == ".nan":
            return float("nan")
        if ":" in s:
            return sign * _sexagesimal(s, float)
        return sign * float(s)
    if _REFUSED.match(text):
        raise YamlSubsetError(f"scalar {text!r} resolves to a type the config reader refuses")
    return text


_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\"}


def _quoted(text: str, line: int) -> Tuple[str, str]:
    """A quoted scalar at the start of ``text`` -> (its value, the rest)."""
    q = text[0]
    out, i = [], 1
    while i < len(text):
        c = text[i]
        if q == "'" and c == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1:]
        if q == '"' and c == '"':
            return "".join(out), text[i + 1:]
        if q == '"' and c == "\\":
            esc = text[i + 1:i + 2]
            if esc in _ESCAPES:
                out.append(_ESCAPES[esc])
                i += 2
                continue
            if esc in ("x", "u", "U"):
                n = {"x": 2, "u": 4, "U": 8}[esc]
                out.append(chr(int(text[i + 2:i + 2 + n], 16)))
                i += 2 + n
                continue
            raise YamlSubsetError(f"line {line}: escape \\{esc} in a double-quoted scalar")
        out.append(c)
        i += 1
    raise YamlSubsetError(f"line {line}: unterminated quoted scalar")


def _strip_comment(text: str) -> str:
    """``text`` without a trailing `` # comment`` (quotes respected)."""
    i, quote = 0, None
    while i < len(text):
        c = text[i]
        if quote:
            if c == "\\" and quote == '"':
                i += 1
            elif c == quote:
                quote = None
        elif c in "'\"" and (i == 0 or text[i - 1] in " [,:-"):
            quote = c
        elif c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    return text.rstrip()


def _flow(text: str, line: int) -> Tuple[Any, str]:
    """A flow sequence of scalars (nested sequences allowed), an empty flow
    mapping, or a scalar at the start of ``text`` -> (value, the rest)."""
    text = text.lstrip()
    if text.startswith("{"):
        if text[1:].lstrip().startswith("}"):
            return {}, text[1:].lstrip()[1:]
        raise YamlSubsetError(f"line {line}: flow mappings other than {{}} are not read")
    if text.startswith("["):
        items, rest = [], text[1:].lstrip()
        if rest.startswith("]"):
            return items, rest[1:]
        while True:
            value, rest = _flow(rest, line)
            items.append(value)
            rest = rest.lstrip()
            if rest.startswith(","):
                rest = rest[1:].lstrip()
            elif rest.startswith("]"):
                return items, rest[1:]
            else:
                raise YamlSubsetError(f"line {line}: malformed flow sequence")
    if text[:1] in ("'", '"'):
        return _quoted(text, line)
    end = len(text)
    for i, c in enumerate(text):
        if c in ",]}":
            end = i
            break
    return resolve_scalar(text[:end].strip()), text[end:]


def _scalar_text(text: str, line: int) -> Any:
    """A whole value written inline: a quoted or plain scalar, or a flow
    collection; nothing may follow it."""
    text = text.strip()
    if text[:1] in ("|", ">", "&", "*", "!", "%", "@", "`"):
        raise YamlSubsetError(f"line {line}: {text[:1]!r} (block scalars, anchors, aliases, "
                              "tags) is not read")
    try:
        if text[:1] in ("[", "{", "'", '"'):
            value, rest = _flow(text, line)
            if rest.strip():
                raise YamlSubsetError(f"line {line}: unexpected {rest.strip()!r}")
            return value
        return resolve_scalar(text)
    except YamlSubsetError as e:
        if str(e).startswith("line "):
            raise
        raise YamlSubsetError(f"line {line}: {e}") from None


def _split_key(text: str, line: int) -> Optional[Tuple[Any, str]]:
    """``key: value`` -> (key, the value's text); None when ``text`` is no
    mapping entry."""
    if text[:1] in ("'", '"'):
        key, rest = _quoted(text, line)
        if rest == ":" or rest.startswith(": "):
            return key, rest[1:].strip()
        return None
    for i, c in enumerate(text):
        if c == ":" and (i + 1 == len(text) or text[i + 1] == " "):
            key = text[:i].strip()
            if key.startswith(("? ", "[", "{")):
                raise YamlSubsetError(f"line {line}: complex mapping keys are not read")
            return resolve_scalar(key), text[i + 1:].strip()
    return None


class _Lines:
    """The document's significant lines as (line number, indent, text)."""

    def __init__(self, source: str):
        self.rows = []
        for n, raw in enumerate(source.splitlines(), 1):
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                raise YamlSubsetError(f"line {n}: tab in indentation")
            text = _strip_comment(raw.strip())
            if not text:
                continue
            if text in ("---", "...") or text.startswith("%"):
                if self.rows and text != "...":
                    raise YamlSubsetError(f"line {n}: more than one document")
                continue
            self.rows.append([n, len(raw) - len(raw.lstrip()), text])
        self.i = 0

    def peek(self):
        return self.rows[self.i] if self.i < len(self.rows) else None


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _continued(lines: _Lines, text: str, indent: int) -> str:
    """A plain or quoted scalar folded onto the lines indented deeper than
    ``indent`` (how ``yaml.safe_dump`` wraps a long string)."""
    parts = [text]
    while (row := lines.peek()) is not None and row[1] > indent:
        if _is_item(row[2]) or _split_key(row[2], row[0]) is not None:
            raise YamlSubsetError(f"line {row[0]}: unexpected indentation")
        parts.append(row[2])
        lines.i += 1
    return " ".join(parts)


def _block(lines: _Lines, indent: int) -> Any:
    row = lines.peek()
    if _is_item(row[2]):
        return _sequence(lines, indent)
    return _mapping(lines, indent)


def _value_after(lines: _Lines, text: str, indent: int, line: int, seq_parent: bool) -> Any:
    """The value of an entry at ``indent`` whose inline text is ``text``."""
    if text:
        if lines.peek() is not None and lines.peek()[1] > indent:
            text = _continued(lines, text, indent)
        return _scalar_text(text, line)
    row = lines.peek()
    if row is None:
        return None
    if row[1] > indent:
        return _block(lines, row[1])
    if row[1] == indent and _is_item(row[2]) and not seq_parent:
        return _sequence(lines, indent)  # `key:` then `- item` at the key's indent
    return None


def _mapping(lines: _Lines, indent: int) -> dict:
    out: dict = {}
    while (row := lines.peek()) is not None and row[1] == indent and not _is_item(row[2]):
        n, _, text = row
        entry = _split_key(text, n)
        if entry is None:
            raise YamlSubsetError(f"line {n}: expected `key: value`, got {text!r}")
        key, rest = entry
        if key in out:
            raise YamlSubsetError(f"line {n}: duplicate key {key!r}")
        lines.i += 1
        out[key] = _value_after(lines, rest, indent, n, seq_parent=False)
    row = lines.peek()
    if row is not None and row[1] > indent:
        raise YamlSubsetError(f"line {row[0]}: unexpected indentation")
    return out


def _sequence(lines: _Lines, indent: int) -> list:
    out: list = []
    while (row := lines.peek()) is not None and row[1] == indent and _is_item(row[2]):
        n, _, text = row
        rest = text[1:].strip()
        if not rest:
            lines.i += 1
            out.append(_value_after(lines, "", indent, n, seq_parent=True))
            continue
        inner = indent + (len(text) - len(text[1:].lstrip()))
        if _is_item(rest) or _split_key(rest, n) is not None:
            row[1], row[2] = inner, rest  # `- - x` / `- key: v`: a block at the text's column
            out.append(_block(lines, inner))
            continue
        lines.i += 1
        out.append(_value_after(lines, rest, indent, n, seq_parent=True))
    row = lines.peek()
    if row is not None and row[1] > indent:
        raise YamlSubsetError(f"line {row[0]}: unexpected indentation")
    return out


def parse_yaml(source: str) -> Any:
    """The YAML subset the repository's config files use: block mappings,
    block sequences (``- - x`` and ``- key: v`` included), flow sequences of
    scalars, ``{}``, comments, and plain, quoted and folded scalars resolved
    as ``yaml.safe_load`` resolves them. Anything else raises
    ``YamlSubsetError`` with its line number."""
    lines = _Lines(source)
    if lines.peek() is None:
        return None
    n, indent, text = lines.peek()
    if _is_item(text) or _split_key(text, n) is not None:
        value = _block(lines, indent)
    else:  # a document that is one scalar or flow sequence
        lines.i += 1
        value = _scalar_text(_continued(lines, text, -1), n)
    if lines.peek() is not None:
        raise YamlSubsetError(f"line {lines.peek()[0]}: unexpected content")
    return value


def parse_override_value(text: str) -> Any:
    """A CLI override's value with YAML scalar semantics (``[3]``, ``6``,
    ``false``, ``1.0e-05``); text that is no such value stays text."""
    try:
        return parse_yaml(text)
    except YamlSubsetError:
        return text


_PLAIN_SAFE = re.compile(r"^[A-Za-z0-9_./=+~$()^%@-][^:#\n\r\t'\"]*$")


def _emit_scalar(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if value != value:
            return ".nan"
        if value in (float("inf"), float("-inf")):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if not isinstance(value, str):
        raise TypeError(f"cannot write {type(value).__name__} {value!r} as YAML")
    plain = (_PLAIN_SAFE.match(value) and value == value.strip() and not value.startswith("- ")
             and not value.endswith(":") and ": " not in value and " #" not in value)
    if plain:
        try:
            if resolve_scalar(value) == value:
                return value
        except YamlSubsetError:
            pass
    if value.isprintable():
        return "'" + value.replace("'", "''") + "'"
    return json.dumps(value)  # double-quoted with YAML-compatible escapes


def _emit_flow(value: Any) -> str:
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_emit_flow(v) for v in value) + "]"
    return _emit_scalar(value)


def _is_flat(value: Any) -> bool:
    if isinstance(value, (list, tuple)):
        return all(_is_flat(v) for v in value)
    return not isinstance(value, Mapping)


def _emit(value: Any, indent: int):
    pad = " " * indent
    if isinstance(value, Mapping):
        if not value:
            yield pad + "{}\n"
        for k, v in value.items():
            key = _emit_scalar(k)
            if isinstance(v, Mapping) and v:
                yield f"{pad}{key}:\n"
                yield from _emit(v, indent + 2)
            elif isinstance(v, (list, tuple)) and not _is_flat(v):
                yield f"{pad}{key}:\n"
                yield from _emit(v, indent + 2)
            else:
                yield f"{pad}{key}: {'{}' if isinstance(v, Mapping) else _emit_flow(v)}\n"
    elif isinstance(value, (list, tuple)) and not _is_flat(value):
        for v in value:
            if isinstance(v, Mapping) and v:
                yield f"{pad}-\n"
                yield from _emit(v, indent + 2)
            else:
                yield f"{pad}- {'{}' if isinstance(v, Mapping) else _emit_flow(v)}\n"
    else:
        yield pad + _emit_flow(value) + "\n"


def load_config(path: Optional[str] = None, overrides: Iterable[str] = (),
                base: Optional[Mapping] = None) -> ConfigTree:
    """A YAML file (the subset ``parse_yaml`` reads) plus ``a.b.c=value``
    overrides -> a ``ConfigTree``."""
    cfg = ConfigTree(base) if base is not None else ConfigTree()
    if path is not None:
        with open(path) as f:
            source = f.read()
        try:
            loaded = parse_yaml(source)
        except YamlSubsetError as e:
            raise YamlSubsetError(f"{path}: {e}") from None
        if loaded is not None and not isinstance(loaded, Mapping):
            raise YamlSubsetError(f"{path}: the document is not a mapping")
        cfg.merge_(loaded or {})
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override {item!r} must look like key.path=value")
        key, _, value = item.partition("=")
        cfg.set_path(key.strip(), parse_override_value(value.strip()))
    return cfg


# ---------------------------------------------------------------------------
# ConfigTree -> SpeechCLIPConfig
# ---------------------------------------------------------------------------

DDP_ITEM = "the ROADMAP item 'DDP' (Queue 1 item 7)"


def _dims(node) -> Optional[Tuple[int, ...]]:
    return None if node is None else tuple(node.dimensions)


def _proj_dropout(node) -> float:
    return 0.1 if node is None else node.get("dropout", 0.1)


def resolve_audio_upstream(ae) -> Optional[Upstream]:
    """The upstream handle of an ``audio_encoder`` node whose type is
    ``s3prl_plus`` with a registered non-HuBERT name (``upstream_args``
    over its config's defaults, lists as tuples); None for
    ``FairseqHubert`` and for the hubert family (JAX's
    ``resolve_audio_upstream``). An unregistered name raises."""
    if ae.type != "s3prl_plus":
        return None
    args = ae.get("upstream_args")
    overrides = None if args is None else {
        k: tuple(v) if isinstance(v, list) else v for k, v in args.to_dict().items()}
    return resolve_upstream(ae.name, overrides)


def _audio_config(ae) -> AudioConfig:
    """The upstream's config (``resolve_audio_upstream``), else HuBERT's:
    ``custom`` widths or the named preset, with ``conv_batch_chunk`` and
    ``remat``."""
    upstream = resolve_audio_upstream(ae)
    if upstream is not None:
        return upstream.cfg
    custom = ae.get("custom")
    if custom is not None:
        kwargs = dict(custom.to_dict())
        if "conv_layers" in kwargs:
            kwargs["conv_layers"] = tuple(tuple(layer) for layer in kwargs["conv_layers"])
        audio = HubertConfig(**kwargs)
    elif ae.name in NAMED_HUBERT_CONFIGS:
        audio = NAMED_HUBERT_CONFIGS[ae.name]
    else:
        raise KeyError(f"audio_encoder.name {ae.name!r}: not one of {sorted(NAMED_HUBERT_CONFIGS)}")
    chunk = ae.get("conv_batch_chunk")
    if chunk is not None:
        audio = dataclasses.replace(audio, conv_batch_chunk=int(chunk))
    remat = ae.get("remat")
    if remat is not None:
        audio = dataclasses.replace(audio, remat=bool(remat))
    return audio


def _clip_config(clip) -> CLIPConfig:
    custom = clip.get("custom")
    if custom is None:
        return NAMED_CLIP_CONFIGS[clip.name]
    vision = dict(custom.vision.to_dict())
    arch = vision.pop("arch", None)
    if arch == "resnet" or isinstance(vision.get("layers"), (list, tuple)):
        if "layers" in vision:
            vision["layers"] = tuple(vision["layers"])
        vision_cfg: VisionConfig = CLIPResNetVisionConfig(**vision)
    else:
        vision_cfg = CLIPVisionConfig(**vision)
    return CLIPConfig(vision=vision_cfg, text=CLIPTextConfig(**custom.text.to_dict()))


def _cascaded_branch_config(cb) -> CascadedBranchConfig:
    ta, kw, vq = cb.transformer_args, cb.keyword, cb.vq.args
    bn = kw.get("batchnorms")
    std = None if bn is None else bn.get("std_scale", 1.0)
    return CascadedBranchConfig(
        transformer_type=cb.transformer_type,
        n_layers=ta.get("n_layers", 1),
        d_model=ta.d_model,
        nhead=ta.nhead,
        dim_feedforward=ta.get("dim_feedforward", 3072),
        activation=ta.get("activation", "gelu"),
        layer_norm_eps=ta.get("layer_norm_eps", 1e-5),
        norm_first=ta.get("norm_first", False),
        keyword_number=kw.number,
        kw_projection=_dims(kw.get("kw_projection")),
        batchnorm_type=None if bn is None else bn.type,
        bn_std_scale=1.0 if std is None else (tuple(std) if isinstance(std, list) else std),
        bn_parallel=False if bn is None else bn.get("parallel", False),
        vq_temp=vq.temp,
        use_gumbel=vq.get("use_gumbel", False),
        hard=vq.get("hard", True),
        ground_truth_perplexity=vq.get("groundTruthPerplexity"),
        kw_projection_dropout=(kw.get("kw_projection") or {}).get("dropout", 0.1),
        dropout=ta.get("dropout", 0.0),
        bn_replica_groups=0 if bn is None else bn.get("replica_groups", 0),
    )


def _loss_config(cl) -> ContrastiveLossConfig:
    args = cl.get("args") or ConfigTree()
    trainable = args.get("temperature_trainable", False)
    if cl.type == "SupConLoss":
        trainable = args.get("learnable_temperature", trainable)
    return ContrastiveLossConfig(
        type=cl.type, temperature=args.get("temperature", 0.07),
        temperature_trainable=trainable, margin=args.get("margin", 0.0),
        dcl=args.get("dcl", False), a2b=args.get("a2b", True), b2a=args.get("b2a", True),
        contrast_mode=args.get("contrast_mode", "all"),
        base_temperature=args.get("base_temperature", 0.07))


def _parallel_branch_config(pb) -> BranchConfig:
    ta = pb.transformer_args
    return BranchConfig(
        n_layers=ta.n_layers, d_model=ta.d_model, nhead=ta.nhead,
        dim_feedforward=ta.dim_feedforward, activation=ta.activation,
        layer_norm_eps=ta.layer_norm_eps, norm_first=ta.norm_first,
        need_projection=pb.get("need_projection", True), dropout=ta.get("dropout", 0.0))


def model_config_from_tree(tree: ConfigTree) -> SpeechCLIPConfig:
    """The port's ``SpeechCLIPConfig`` for a run's config tree, read as the
    JAX ``SpeechCLIPModel`` and ``build_optimizer`` read it: a missing
    objective weight is 0.0, and a branch's section is read only when the
    branch is live (weight > 0); a dead branch keeps the dataclass default,
    which nothing reads. An s3prl upstream outside the registry raises
    ``NotImplementedError``, as in JAX."""
    ae, ms, clip = tree.audio_encoder, tree.model_settings, tree.clip
    clip_cfg = _clip_config(clip)
    select = ae.feat_select_idx
    # an inference config (a reference checkpoint's) may carry no optimizer
    # or scheduler: the model does not read them, and the defaults stand in
    opt, sched = ae.get("optim"), ae.get("scheduler") or {}
    p_weight = ms.get("parallel_objective_weight", 0.0)
    c_weight = ms.get("cascaded_objective_weight", 0.0)
    return SpeechCLIPConfig(
        audio=_audio_config(ae),
        audio_encoder_type=ae.type,
        feat_select_idx=tuple(select) if isinstance(select, (list, tuple)) else select,
        normalize_hiddenstates=bool(ae.get("normalize_hiddenstates", False)),
        normalize_type=ae.get("normalize_type"),
        wsum_remat=bool(ae.get("wsum_remat", False)),
        parallel_objective_weight=p_weight,
        cascaded_objective_weight=c_weight,
        parallel_branch=(_parallel_branch_config(ms.parallel_branch) if p_weight > 0
                         else BranchConfig()),
        parallel_branch_projection=_dims(ms.get("parallel_branch_projection")),
        cascaded_branch=(_cascaded_branch_config(ms.cascaded_branch) if c_weight > 0
                         else CascadedBranchConfig()),
        cascaded_branch_projection=_dims(ms.get("cascaded_branch_projection")),
        clip_text=clip_cfg.text,
        clip_vision=clip_cfg.vision,
        image_encoder_projection=_dims(ms.get("image_encoder_projection")),
        reduce_subword_embedding=clip.get("reduce_subword_embbedding"),
        clip_embed_dim=clip_cfg.text.output_dim,
        precision=tree.get_path("trainer.precision", 32),
        parallel_branch_projection_dropout=_proj_dropout(ms.get("parallel_branch_projection")),
        cascaded_branch_projection_dropout=_proj_dropout(ms.get("cascaded_branch_projection")),
        image_encoder_projection_dropout=_proj_dropout(ms.get("image_encoder_projection")),
        audio_trainable=bool(ae.get("trainable", False)),
        reinit_layers=tuple(ae.get("reinit_layers", []) or []),
        unfreeze_layers=tuple(ae.get("unfreeze_layers", []) or []),
        image_encoder_trainable=bool(clip.get("image_encoder_trainable", False)),
        text_encoder_trainable=bool(clip.get("text_encoder_trainable", False)),
        cl_loss=_loss_config(tree.cl_loss),
        optim=OptimizerConfig() if opt is None else OptimizerConfig(
            name=opt.name, lr=float(opt.args.lr),
            weight_decay=float(opt.args.get("weight_decay", 0.0)),
            betas=tuple(opt.args.get("betas", [0.9, 0.999])),
            eps=float(opt.args.get("eps", 1e-8))),
        scheduler=SchedulerConfig(**{
            k: sched[k] for k in ("name", "warmup", "max_step", "final_lr") if k in sched}),
        gradient_clip_val=float(tree.get_path("trainer.gradient_clip_val", 0) or 0),
        accumulate_grad_batches=int(tree.get_path("trainer.accumulate_grad_batches", 1) or 1),
        retrieval_audio_feat_src=tree.get_path("retrieval.audio_feat_src"),
        audio_pretrained_path=(ae.get("pretrained_path") if ae.get("pretrained", False)
                               else None),
        clip_pretrained_path=clip.get("pretrained_path"),
    )
