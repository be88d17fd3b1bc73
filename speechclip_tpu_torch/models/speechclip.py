"""The SpeechCLIP model (port of speechclip_tpu/models/speechclip.py:
``init``, ``forward_audio``, ``encode_speech``, ``extract_hidden_states``,
``get_attention_weights`` and ``get_attention_map`` on the speech side,
with the parallel branch, the cascaded branch or both;
``encode_image_tower``, ``project_image_feat``, ``forward_image`` and
``forward_text`` on the gallery side; and for training ``forward`` (the
features of both sides, eval or train mode), ``compute_loss`` and
``trainable_mask``; ``load_pretrained`` for the configured tower weight
files). A gallery feature is ``l2_normalize(forward_image(...)
.float())``, as the JAX model's ``forward`` makes it.

HuBERT and the CLIP towers are frozen unless the config trains them
(``audio_trainable``, with ``reinit_layers`` / ``unfreeze_layers`` for a
partial fine-tune; ``image_encoder_trainable``; ``text_encoder_trainable``).
A frozen encoder or image tower runs under ``torch.no_grad()`` (the port's
form of JAX's ``stop_gradient`` on the frozen outputs), so it takes the
kernels' forward-only launches and keeps no graph. A trainable one keeps
its graph: the kernels' autograd.Functions carry its gradient, and a
trainable encoder runs in train mode (its dropout, layerdrop and
``remat``) when the model does. Under a partial fine-tune only the
selected layers' leaves require grad, so the layers below them record no
graph. The cascaded branch's pass through the text tower carries a
gradient to the keywords, and to the tower's weights where it trains. The
RN image towers refuse ``image_encoder_trainable`` (their BatchNorm runs on
running statistics), as in JAX.

Parameters are a plain nested dict with the JAX package's keys
(``audio_encoder``, ``weighted_sum``, ``parallel_branch``,
``p_branch_proj``, ``cascaded_branch``, ``c_branch_proj``,
``img_enc_proj``, and ``clip`` with the image tower ``visual``, the text
tower ``text`` and ``logit_scale``); the state dict holds the kw-BN
running statistics (``cascaded_branch.bn``).
``cast_params`` moves either to a device once: matrices (and conv kernels,
the cls rows) to the compute dtype, vectors (biases, LayerNorm scale and
bias, weighted-sum logits, kw-BN) kept in f32, as the TPU kernels read
them. The CLIP text tower stays f32 whole: the JAX model keeps its params
f32 and runs ``forward_text`` in the f32 token table's dtype; the VQ scores
keywords against that table in f32, where a near-tie argmax can flip on a
bf16-rounded table; and the cascaded branch's bf16 pass through the tower
casts each weight where it is used (``linear``), as JAX does.

With ``wsum_remat`` (the large configs' memory switch) and a frozen
encoder, ``forward_audio`` takes the weighted sum through
``hubert.hubert_frozen_weighted_sum``: no stack of hidden states is kept,
and the logits' gradient recomputes the encoder in the backward. With a
trainable encoder it does not engage, and the model warns once, as JAX's.

With ``audio_encoder_type`` "s3prl_plus" and an ``APCConfig`` or
``CPCConfig`` as ``audio`` (``models/upstream.py``), that upstream takes
HuBERT's place in ``init`` and ``forward_audio`` (no kernel: log-mel or
convs, and GRUs); its states feed the weighted sum or the named / indexed
selection, ``wsum_remat`` does not engage, ``reinit_layers`` /
``unfreeze_layers`` raise, and a configured weight file is refused with a
warning (no s3prl weights offline), as in JAX.

The model and ``cast_params`` run on the card unless the caller asks for
the CPU (``device="cpu"``); without a card they raise.
"""

from __future__ import annotations

import contextlib
import logging
import math
import os
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from ..config import CLIPResNetVisionConfig, SpeechCLIPConfig
from ..data.image import device_clip_preprocess
from ..ops.basic import Params, l2_normalize
from ..ops import retrieval
from ..ops.losses import (
    contrastive_temp_init,
    contrastive_temperature,
    masked_contrastive_loss_sharded,
    supcon_loss,
)
from ..parallel.collectives import all_gather_rows
from ..utils import tracing
from ..ops.mlp import mlp_apply, mlp_init
from ..ops.transformer import TRANSFORMER_TYPES
from ..ops.weighted_sum import weighted_sum_apply, weighted_sum_init
from . import branches, clip as clip_mod, hubert
from .upstream import upstream_for_config, upstream_name

WEIGHTED_SUM_MODE = "weighted_sum"
LOSS_TYPES = ("MaskedContrastiveLoss", "SupConLoss")
REPO_ROOT = Path(__file__).resolve().parents[2]
logger = logging.getLogger(__name__)


def compute_dtype(precision) -> torch.dtype:
    """``trainer.precision``: 16 / "bf16" run bf16, anything else f32."""
    if str(precision) in ("16", "bf16", "bfloat16"):
        return torch.bfloat16
    return torch.float32


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card raises
    (nothing quietly runs on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the port on the CPU")
    return dev


F32_SUBTREES = ("text",)  # subtrees (the CLIP text tower) cast_params keeps in f32


def cast_params(params, dtype: torch.dtype, device="cuda"):
    """Tensors of rank >= 2 -> ``dtype`` (those under a key in F32_SUBTREES
    -> f32); rank <= 1 -> f32; all on ``device`` (the card unless asked
    otherwise). Lists, dicts and None are kept as they are."""
    dev = resolve_device(device)

    def cast(t, keep32=False):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: cast(v, keep32 or k in F32_SUBTREES) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(cast(v, keep32) for v in t)
        keep = keep32 or t.dim() < 2
        return t.to(device=dev, dtype=torch.float32 if keep else dtype)

    return cast(params)


def resolve_asset_path(path: str) -> str:
    """A config's asset path as given where it exists, else relative to the
    repository root (the shipped vocabulary tables live under ``assets/``),
    else, for a reference-layout table (``.../{flickr,coco}_stat/<name>.npy``,
    the path a released checkpoint's pickled config carries), the vendored
    copy ``assets/<corpus>_stat/<name>.npy``; a path none of these finds
    comes back as given."""
    import re

    if os.path.exists(path):
        return path
    if not os.path.isabs(path) and (REPO_ROOT / path).exists():
        return str(REPO_ROOT / path)
    m = re.search(r"(flickr|coco)_stat/([\w.]+\.npy)$", path)
    if m:
        vendored = REPO_ROOT / "assets" / f"{m.group(1)}_stat" / m.group(2)
        if vendored.exists():
            return str(vendored)
    return path


def _warn_wsum_remat_blockers(config: SpeechCLIPConfig, upstream) -> None:
    """The JAX model's one warning when ``wsum_remat`` is set but the config
    rules the recompute out: the stack of hidden states stays live."""
    blockers = []
    if config.feat_select_idx != WEIGHTED_SUM_MODE:
        blockers.append(f"feat_select_idx={config.feat_select_idx!r} (needs 'weighted_sum')")
    if upstream is not None:
        blockers.append("a custom s3prl upstream is configured")
    if config.audio_trainable:
        blockers.append("audio_encoder.trainable=true (the backward recompute assumes a "
                        "frozen, deterministic encoder)")
    logger.warning(
        "audio_encoder.wsum_remat is set but will NOT engage: %s — the N-hidden-state stack "
        "stays live and large batches may run out of memory (see models/hubert.py "
        "hubert_frozen_weighted_sum)", "; ".join(blockers))


def _grad_unless(frozen: bool):
    """``torch.no_grad()`` for a frozen tower, else no change."""
    return torch.no_grad() if frozen else contextlib.nullcontext()


def _same(tree, value):
    """A tree of ``value`` over the leaves of ``tree`` (None leaves kept)."""
    if isinstance(tree, dict):
        return {k: _same(v, value) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_same(v, value) for v in tree]
    return None if tree is None else value


def _swap_in(old, new, new_cast):
    """``old`` with ``new``'s values: a trainable leaf of ``old`` (an f32
    master the optimizer holds, ``requires_grad``) takes ``new``'s f32
    values in place; any other leaf is replaced by ``new_cast``'s. Keys keep
    ``old``'s order (the optimizer's leaf order)."""
    if isinstance(new, dict):
        old = old or {}
        keys = [k for k in old if k in new] + [k for k in new if k not in old]
        return {k: _swap_in(old.get(k), new[k], new_cast[k]) for k in keys}
    if isinstance(new, (list, tuple)):
        olds = old if old is not None else [None] * len(new)
        return type(new)(_swap_in(o, n, c) for o, n, c in zip(olds, new, new_cast))
    if torch.is_tensor(old) and old.requires_grad and new is not None:
        with torch.no_grad():
            old.copy_(new)
        return old
    return new_cast


class SpeechCLIPModel:
    """Host-side description of the model; the math lives in the package's
    functions over the params dict."""

    def __init__(self, config: SpeechCLIPConfig, device="cuda"):
        if config.audio_encoder_type not in ("FairseqHubert", "s3prl_plus"):
            raise NotImplementedError(f"audio encoder type {config.audio_encoder_type}")
        # an s3prl upstream (models/upstream.py); None: HuBERT
        name = upstream_name(config.audio)
        if name is not None and config.audio_encoder_type != "s3prl_plus":
            raise ValueError(f"the {name} upstream's config needs audio_encoder_type s3prl_plus")
        self.upstream = None if name is None else upstream_for_config(name, config.audio)
        # forward_audio takes hubert_frozen_weighted_sum (JAX's conditions)
        self.wsum_remat_engaged = (config.wsum_remat and not config.audio_trainable
                                   and config.feat_select_idx == WEIGHTED_SUM_MODE
                                   and self.upstream is None)
        if config.wsum_remat and not self.wsum_remat_engaged:
            _warn_wsum_remat_blockers(config, self.upstream)
        if (config.reinit_layers or config.unfreeze_layers) and not config.audio_trainable:
            raise ValueError(
                "reinit_layers/unfreeze_layers require audio_trainable: otherwise the "
                "selected layers would stay frozen"
            )
        if isinstance(config.clip_vision, CLIPResNetVisionConfig) and config.image_encoder_trainable:
            raise NotImplementedError(
                "image_encoder_trainable is not supported for the RN* CLIP towers "
                "(inference-mode BatchNorm); use a ViT tower or freeze the image encoder")
        if config.cl_loss.type not in LOSS_TYPES:
            raise NotImplementedError(f"cl_loss type {config.cl_loss.type}")
        self.use_parallel = config.parallel_objective_weight > 0
        self.use_cascaded = config.cascaded_objective_weight > 0
        if not (self.use_parallel or self.use_cascaded):
            raise ValueError("both objective weights are 0: no branch to run")
        if config.cascaded_branch.transformer_type not in TRANSFORMER_TYPES:
            raise NotImplementedError(config.cascaded_branch.transformer_type)
        self.device = resolve_device(device)
        self.config = config
        self.audio_cfg = config.audio
        self.clip_cfg = config.clip_text
        self.vision_cfg = config.clip_vision
        self.compute_dtype = compute_dtype(config.precision)
        self.hidden_norm_type = (
            (config.normalize_type or "s3prl") if config.normalize_hiddenstates else None
        )
        self.keyword_num = config.cascaded_branch.keyword_number
        self.reduced_vocab = None
        if config.reduce_subword_embedding:
            self.reduced_vocab = clip_mod.load_reduced_vocab(
                resolve_asset_path(config.reduce_subword_embedding)
            )
        # CLIP vocabulary convention: SOT and EOT are the last two ids
        full_sot, full_eot = self.clip_cfg.vocab_size - 2, self.clip_cfg.vocab_size - 1
        if self.reduced_vocab is not None:
            self.sot_id = self.reduced_vocab.original_to_reduced[full_sot]
            self.eot_id = self.reduced_vocab.original_to_reduced[full_eot]
        else:
            self.sot_id, self.eot_id = full_sot, full_eot

    def init(self, seed: int = 0) -> Tuple[Params, Params]:
        """Random f32 (params, state) on the model's device from a generator
        seeded with ``seed`` (cast them with ``cast_params`` before
        running). The CLIP towers are built whatever the branches, as in the
        JAX model; those the speech side does not read (the image tower, the
        text tower without the cascaded branch) and the image projection
        draw after every speech-side draw, so a seed's speech-side params do
        not depend on them."""
        cfg = self.config
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params: Params = {"audio_encoder": (hubert.hubert_init(gen, self.audio_cfg)
                                            if self.upstream is None else self.upstream.init(gen))}
        cl = cfg.cl_loss
        if cl.type == "MaskedContrastiveLoss":
            criterion = contrastive_temp_init(cl.temperature, cl.temperature_trainable,
                                              self.device)
        else:  # SupConLoss: the temperature itself
            criterion = ({"temp": torch.tensor(cl.temperature, dtype=torch.float32,
                                               device=self.device)}
                         if cl.temperature_trainable else {})
        if criterion:
            params["criterion"] = criterion
        state: Params = {}
        if cfg.feat_select_idx == WEIGHTED_SUM_MODE:
            params["weighted_sum"] = weighted_sum_init(self.audio_cfg.num_hidden_states, self.device)
        if self.use_cascaded:
            clip_params = {"text": clip_mod.text_init(gen, self.clip_cfg)}
            if self.reduced_vocab is not None:
                clip_params = clip_mod.reduce_token_embedding(clip_params, self.reduced_vocab)
            params["clip"] = clip_params
            params["cascaded_branch"], c_state = branches.cascaded_branch_init(
                gen, cfg.cascaded_branch, self.audio_cfg.encoder_embed_dim,
                self.clip_cfg.width, clip_params["text"]["token_embedding"],
            )
            if c_state:
                state["cascaded_branch"] = c_state
        if self.use_parallel:
            params["parallel_branch"] = branches.parallel_branch_init(
                gen, cfg.parallel_branch, self.audio_cfg.encoder_embed_dim, cfg.clip_embed_dim,
            )
        if cfg.parallel_branch_projection is not None:
            params["p_branch_proj"] = mlp_init(gen, cfg.parallel_branch_projection)
        if cfg.cascaded_branch_projection is not None:
            params["c_branch_proj"] = mlp_init(gen, cfg.cascaded_branch_projection)
        if "clip" not in params:
            params["clip"] = {"text": clip_mod.text_init(gen, self.clip_cfg)}
            if self.reduced_vocab is not None:
                params["clip"] = clip_mod.reduce_token_embedding(params["clip"], self.reduced_vocab)
        params["clip"]["visual"] = clip_mod.vision_init(gen, self.vision_cfg)
        params["clip"]["logit_scale"] = torch.tensor(
            math.log(1 / 0.07), dtype=torch.float32, device=self.device)
        if cfg.image_encoder_projection is not None:
            params["img_enc_proj"] = mlp_init(gen, cfg.image_encoder_projection)
        return params, state

    def load_pretrained(self, params: Params) -> Params:
        """``params`` with the towers swapped for the configured weight
        files (``audio_pretrained_path``: a fairseq or HF HuBERT;
        ``clip_pretrained_path``: an OpenAI or HF CLIP, cut to the reduced
        vocabulary where one is configured), converted by
        ``convert.from_torch`` and cast as ``cast_params`` casts, on the
        model's device; then ``reinit_layers`` re-initialized (JAX's
        ``load_pretrained``: the layers of a fresh seed-0 HuBERT init, here
        the port's own). A configured file that is missing logs a warning
        and leaves the random tower, as the JAX model does. A trainable
        leaf (an f32 master the optimizer holds) takes the new values in
        place; the other leaves the optimizer holds are kept as they are."""
        params = dict(params)

        def swap(key, new):
            params[key] = _swap_in(params.get(key), new,
                                   cast_params(new, self.compute_dtype, self.device))

        ae_path = self.config.audio_pretrained_path
        if ae_path and self.upstream is not None:
            logger.warning(
                "pretrained weights for generic s3prl upstream %s are not available offline; "
                "keeping random init (the reference supports pretrained=False the same way, "
                "speech_encoder_plus.py:151-152)", self.upstream.name)
            ae_path = None
        if ae_path:
            if os.path.exists(ae_path):
                from ..convert.from_torch import load_hubert_checkpoint

                swap("audio_encoder", load_hubert_checkpoint(ae_path, self.audio_cfg))
                logger.info("loaded HuBERT weights from %s", ae_path)
            else:
                logger.warning("HuBERT checkpoint %s not found; random init", ae_path)
        reinit = self.config.reinit_layers
        if reinit and self.upstream is not None:
            raise NotImplementedError(
                "reinit_layers is a hubert-family feature (the reference gates it on "
                "name.startswith('hubert') too, speech_encoder_plus.py:157-183)")
        if reinit:
            fresh = hubert.hubert_init(torch.Generator(device=self.device).manual_seed(0),
                                       self.audio_cfg)["encoder"]["layers"]
            ae = dict(params["audio_encoder"])
            ae["encoder"] = dict(ae["encoder"])
            layers = list(ae["encoder"]["layers"])
            for i in reinit:
                layers[i] = _swap_in(layers[i], fresh[i],
                                     cast_params(fresh[i], self.compute_dtype, self.device))
            ae["encoder"]["layers"] = layers
            params["audio_encoder"] = ae
            logger.info("reinitialized HuBERT encoder layers %s", list(reinit))
        clip_path = self.config.clip_pretrained_path
        if clip_path:
            if os.path.exists(clip_path):
                from ..config import CLIPConfig
                from ..convert.from_torch import load_clip_checkpoint

                clip_params = load_clip_checkpoint(
                    clip_path, CLIPConfig(vision=self.vision_cfg, text=self.clip_cfg))
                if self.reduced_vocab is not None:
                    clip_params = clip_mod.reduce_token_embedding(clip_params, self.reduced_vocab)
                swap("clip", clip_params)
                logger.info("loaded CLIP weights from %s", clip_path)
            else:
                logger.warning("CLIP checkpoint %s not found; random init", clip_path)
        return params

    def forward_audio(
        self,
        params: Params,
        wav: torch.Tensor,  # (B, L) float or int16 PCM, zero-padded
        wav_len: torch.Tensor,  # (B,) int
        plain: bool = False,
        return_hidden_states: bool = False,
        generator: Optional[torch.Generator] = None,
        train: bool = False,
    ):
        """-> (audio features, feature lengths[, hidden states]) on the
        model's device. int16 PCM is rescaled by 1/32768 in f32 first
        (exact), then cast to the compute dtype. With ``wsum_remat``, the
        weighted sum and no hidden states asked for, the frozen encoder's
        feature comes from ``hubert.hubert_frozen_weighted_sum`` (JAX's
        conditions). A frozen encoder runs under ``torch.no_grad()``; a
        trainable one keeps its graph and, with ``train``, runs in train
        mode, drawing its dropout from ``generator``."""
        wav, wav_len = wav.to(self.device), wav_len.to(self.device)
        if wav.dtype == torch.int16:
            wav = wav.float() * (1.0 / 32768.0)
        wav = wav.to(self.compute_dtype)
        if self.wsum_remat_engaged and not return_hidden_states:
            with tracing.span("speechclip.hubert.wsum", device=True):
                return hubert.hubert_frozen_weighted_sum(
                    params["weighted_sum"], params["audio_encoder"], self.audio_cfg, wav,
                    wav_len, norm_type=self.hidden_norm_type, plain=plain)
        trainable = self.config.audio_trainable
        with _grad_unless(frozen=not trainable):
            if self.upstream is not None:
                hidden_states, feat_len = self.upstream.apply(
                    params["audio_encoder"], wav, wav_len, generator=generator,
                    train=train and trainable)
            else:
                hidden_states, feat_len = hubert.hubert_apply(
                    params["audio_encoder"], self.audio_cfg, wav, wav_len, plain=plain,
                    train=train and trainable, generator=generator,
                )
        select = self.config.feat_select_idx
        if select == WEIGHTED_SUM_MODE:
            with tracing.span("speechclip.hubert.wsum", device=True):
                hidden_states = self._normalized(hidden_states)
                feat = weighted_sum_apply(
                    params["weighted_sum"],
                    hidden_states,
                    normalize_features=self.hidden_norm_type == "s3prl",
                )
        else:
            hidden_states = self._normalized(hidden_states)
            if select == "last_hidden_state":
                feat = hidden_states[-1]
            elif select in ("hidden_states", "all"):
                feat = hidden_states
            elif isinstance(select, (list, tuple)):
                feat = [hidden_states[i] for i in select]
            else:
                raise KeyError(select)
        if return_hidden_states:
            return feat, feat_len, hidden_states
        return feat, feat_len

    def _normalized(self, hidden_states):
        """The states after the method1 / method2 normalization (the s3prl
        mode's per-state LayerNorm is ``weighted_sum_apply``'s)."""
        if self.hidden_norm_type in ("method1", "method2"):
            return hubert.normalize_hidden_states(hidden_states, self.hidden_norm_type)
        return hidden_states

    def encode_speech(
        self,
        params: Params,
        state: Params,
        wav: torch.Tensor,
        wav_len: torch.Tensor,
        plain: bool = False,
    ) -> Dict[str, Any]:
        """-> {"cascaded_audio_feat", "vq_results", "keywords"} for the
        cascaded branch and {"parallel_audio_feat"} for the parallel one
        (features (B, E) f32, L2-normalized). ``plain=True`` runs every
        kernel route through the plain PyTorch versions, on any device."""
        with tracing.span("speechclip.encode_speech", device=True):
            return self._encode_speech(params, state, wav, wav_len, plain)

    def _encode_speech(self, params, state, wav, wav_len, plain) -> Dict[str, Any]:
        audio_feat, audio_len = self.forward_audio(params, wav, wav_len, plain=plain)
        out: Dict[str, Any] = {}
        if self.use_cascaded:
            with tracing.span("speechclip.branch.cascaded", device=True):
                feat, vq_results, keywords, _ = branches.cascaded_branch_apply(
                    params["cascaded_branch"], state.get("cascaded_branch", {}),
                    self.config.cascaded_branch, params["clip"], self.clip_cfg,
                    self.sot_id, self.eot_id, audio_feat, audio_len, plain=plain,
                )
                if "c_branch_proj" in params:
                    feat = mlp_apply(params["c_branch_proj"], feat)
            out["cascaded_audio_feat"] = l2_normalize(feat.float())
            out["vq_results"] = vq_results
            out["keywords"] = keywords
        if self.use_parallel:
            with tracing.span("speechclip.branch.parallel", device=True):
                feat = branches.parallel_branch_apply(
                    params["parallel_branch"], self.config.parallel_branch,
                    audio_feat, audio_len, plain=plain,
                )
                if "p_branch_proj" in params:
                    feat = mlp_apply(params["p_branch_proj"], feat)
            out["parallel_audio_feat"] = l2_normalize(feat.float())
        return out

    def encode_image_tower(self, params: Params, images: torch.Tensor,
                           plain: bool = False) -> torch.Tensor:
        """The CLIP image tower alone, on the model's device, under
        ``torch.no_grad()`` unless it is trainable: (B, H, W, 3) uint8
        images take ``device_clip_preprocess`` first; then the compute dtype
        and ``clip.encode_image`` -> (B, output_dim). The trainer's
        image-feature cache (``forward``'s ``image_feat_frozen``) holds the
        frozen tower's output."""
        images = images.to(self.device)
        with torch.no_grad():
            if images.dtype == torch.uint8:
                images = device_clip_preprocess(images, self.vision_cfg.image_size)
            images = images.to(self.compute_dtype)
        with _grad_unless(frozen=not self.config.image_encoder_trainable):
            return clip_mod.encode_image(params["clip"], self.vision_cfg, images, plain)

    def project_image_feat(self, params: Params, feat: torch.Tensor,
                           generator: Optional[torch.Generator] = None,
                           train: bool = False) -> torch.Tensor:
        """The image projection MLP (``img_enc_proj``) where configured, the
        trainable tail of the image side."""
        if "img_enc_proj" in params:
            feat = mlp_apply(params["img_enc_proj"], feat,
                             self.config.image_encoder_projection_dropout, generator, train)
        return feat

    def forward_image(self, params: Params, images: torch.Tensor, plain: bool = False,
                      generator: Optional[torch.Generator] = None,
                      train: bool = False) -> torch.Tensor:
        """Image tower, then the projection: (B, E) in the compute dtype."""
        return self.project_image_feat(params, self.encode_image_tower(params, images, plain),
                                       generator, train)

    def forward_text(self, params: Params, text: torch.Tensor,
                     eot_positions: Optional[torch.Tensor] = None,
                     plain: bool = False) -> torch.Tensor:
        """(B, 77) token ids -> (B, output_dim) through the CLIP text tower,
        pooled at ``eot_positions`` (else ``text.argmax(-1)``). The tower runs
        in the token table's dtype, as in the JAX model: f32 whatever the
        precision, since ``cast_params`` keeps the text tower f32; under
        "pallas" its causal layers take ``flash_attention``'s f32 form."""
        if eot_positions is not None:
            eot_positions = eot_positions.to(self.device)
        return clip_mod.encode_text(params["clip"], self.clip_cfg, text.to(self.device),
                                    eot_positions, plain)

    def forward(
        self,
        params: Params,
        state: Params,
        batch: Dict[str, torch.Tensor],
        generator: Optional[torch.Generator] = None,
        train: bool = False,
        num_updates: Optional[torch.Tensor] = None,
        plain: bool = False,
        mesh=None,
    ) -> Tuple[Dict, Dict, Dict, Params]:
        """-> (loss_feats, log_metrics, others, new_state), as the JAX
        model's ``forward``. ``batch``: ``wav``, ``wav_len``, ``id`` and
        either ``image`` or ``image_feat_frozen`` (the image tower's output,
        cached by the trainer: only the projection runs). In train mode the
        dropout and the Gumbel noise are drawn from ``generator``, kw-BN
        normalizes with batch statistics and returns its running statistics
        updated, and ``num_updates`` drives a scheduled VQ temperature.
        Features come out L2-normalized in f32. ``mesh`` (a ``DataMesh``):
        the batch is this rank's shard; kw-BN's statistics and the VQ's
        diagnostics are the global batch's (``compute_loss`` gathers the
        features)."""
        audio_feat, audio_len = self.forward_audio(params, batch["wav"], batch["wav_len"],
                                                   plain=plain, generator=generator, train=train)
        with tracing.span("speechclip.image.project", device=True):
            if "image_feat_frozen" in batch:
                frozen = batch["image_feat_frozen"].to(self.device, self.compute_dtype)
                image_feat = self.project_image_feat(params, frozen, generator, train)
            else:
                image_feat = self.forward_image(params, batch["image"], plain, generator, train)
        cfg = self.config
        cascaded_feat = parallel_feat = vq_results = keywords = None
        new_state = state
        if self.use_cascaded:
            with tracing.span("speechclip.branch.cascaded", device=True):
                cascaded_feat, vq_results, keywords, branch_state = (
                    branches.cascaded_branch_apply(
                        params["cascaded_branch"], state.get("cascaded_branch", {}),
                        cfg.cascaded_branch, params["clip"], self.clip_cfg, self.sot_id,
                        self.eot_id, audio_feat, audio_len, plain=plain, train=train,
                        generator=generator, num_updates=num_updates, mesh=mesh,
                    ))
                if branch_state:
                    new_state = {**state, "cascaded_branch": branch_state}
                if "c_branch_proj" in params:
                    cascaded_feat = mlp_apply(params["c_branch_proj"], cascaded_feat,
                                              cfg.cascaded_branch_projection_dropout, generator,
                                              train)
        if self.use_parallel:
            with tracing.span("speechclip.branch.parallel", device=True):
                parallel_feat = branches.parallel_branch_apply(
                    params["parallel_branch"], cfg.parallel_branch, audio_feat, audio_len,
                    plain=plain, train=train, generator=generator,
                )
                if "p_branch_proj" in params:
                    parallel_feat = mlp_apply(params["p_branch_proj"], parallel_feat,
                                              cfg.parallel_branch_projection_dropout, generator,
                                              train)
        ids = batch["id"].to(self.device)
        image_feat = l2_normalize(image_feat.float())
        loss_feats: Dict[str, Any] = {"id": ids, "image_feat": image_feat}
        log_metrics: Dict[str, Any] = {}
        if cascaded_feat is not None:
            cascaded_feat = l2_normalize(cascaded_feat.float())
            loss_feats["cascaded_audio_feat"] = cascaded_feat
            log_metrics["softmax_temp"] = vq_results["temp"]
        if parallel_feat is not None:
            parallel_feat = l2_normalize(parallel_feat.float())
            loss_feats["parallel_audio_feat"] = parallel_feat
        log_metrics["cl_temp"] = self._current_cl_temperature(params)
        others = {
            "cascaded_audio_feat": cascaded_feat, "parallel_audio_feat": parallel_feat,
            "image_feat": image_feat, "id": ids, "vq_results": vq_results,
            "keywords": keywords,
        }
        return loss_feats, log_metrics, others, new_state

    def _current_cl_temperature(self, params: Params) -> torch.Tensor:
        """The contrastive loss's temperature t (not 1 / t)."""
        cl = self.config.cl_loss
        if cl.type == "MaskedContrastiveLoss":
            return 1.0 / contrastive_temperature(params.get("criterion", {}), cl.temperature,
                                                 cl.temperature_trainable)
        if cl.temperature_trainable:
            return params["criterion"]["temp"]
        return torch.tensor(cl.temperature, dtype=torch.float32)

    def _pair_loss(self, params: Params, audio_feat: torch.Tensor, image_feat: torch.Tensor,
                   ids: torch.Tensor, mesh=None) -> torch.Tensor:
        cl = self.config.cl_loss
        if cl.type == "MaskedContrastiveLoss":
            return masked_contrastive_loss_sharded(
                params.get("criterion", {}), audio_feat, image_feat, ids, mesh,
                temperature=cl.temperature, temperature_trainable=cl.temperature_trainable,
                margin=cl.margin, dcl=cl.dcl, a2b=cl.a2b, b2a=cl.b2a,
            )
        # SupConLoss: (audio, image) as two views, pair ids as the labels
        views = torch.stack([all_gather_rows(audio_feat, mesh), all_gather_rows(image_feat, mesh)],
                            dim=1)
        return supcon_loss(views, temperature=self._current_cl_temperature(params),
                           labels=all_gather_rows(ids, mesh, "ids"),
                           contrast_mode=cl.contrast_mode,
                           base_temperature=cl.base_temperature)

    def compute_loss(self, params: Params, loss_feats: Dict, mesh=None) -> Dict[str, torch.Tensor]:
        """-> {"loss", "c_cl_loss" (cascaded), "p_cl_loss" (parallel)}: each
        branch's pair loss against the image features, summed with the
        objective weights. ``mesh``: the features are this rank's rows,
        gathered over the ranks for the global batch's loss."""
        cfg = self.config
        ids = loss_feats["id"]
        image_feat = loss_feats["image_feat"].float()
        losses = {"loss": torch.zeros((), dtype=torch.float32, device=image_feat.device)}
        if self.use_cascaded:
            losses["c_cl_loss"] = self._pair_loss(
                params, loss_feats["cascaded_audio_feat"].float(), image_feat, ids, mesh)
            losses["loss"] = losses["loss"] + cfg.cascaded_objective_weight * losses["c_cl_loss"]
        if self.use_parallel:
            losses["p_cl_loss"] = self._pair_loss(
                params, loss_feats["parallel_audio_feat"].float(), image_feat, ids, mesh)
            losses["loss"] = losses["loss"] + cfg.parallel_objective_weight * losses["p_cl_loss"]
        return losses

    def attention_heads(self) -> Dict[str, int]:
        """{params path prefix: head count} of every ``in_proj`` the model
        holds: the model axis shards an ``in_proj`` by heads
        (``parallel.tensor.param_partition_specs``)."""
        heads = {"clip/text": self.clip_cfg.heads,
                 "parallel_branch": self.config.parallel_branch.nhead,
                 "cascaded_branch": self.config.cascaded_branch.nhead}
        if not isinstance(self.vision_cfg, CLIPResNetVisionConfig):
            heads["clip/visual"] = self.vision_cfg.heads
        if self.upstream is None:
            heads["audio_encoder"] = self.audio_cfg.encoder_heads
        return heads

    def trainable_mask(self, params: Params) -> Params:
        """A tree of bools over ``params``, True where a leaf trains (the
        JAX model's ``trainable_mask``): the branches, the projections, the
        weighted sum and a trainable criterion temperature; the encoder
        where ``audio_trainable`` (under ``reinit_layers`` /
        ``unfreeze_layers`` only the selected layers, and the top
        ``encoder.layer_norm`` of a post-norm model under reinit); the image
        and text towers by their flags; never CLIP's ``logit_scale``.
        Selected layers without a trainable encoder, or both lists at once,
        raise."""
        cfg = self.config
        if cfg.reinit_layers and cfg.unfreeze_layers:
            raise ValueError("reinit_layers and unfreeze_layers are exclusive")
        selected = cfg.reinit_layers or cfg.unfreeze_layers
        if selected and not cfg.audio_trainable:
            raise ValueError("reinit_layers/unfreeze_layers require audio_trainable")

        if selected and self.upstream is not None:
            raise NotImplementedError("reinit/unfreeze_layers are hubert-family features "
                                      "(reference speech_encoder_plus.py:157-198)")

        mask: Params = {}
        for key, sub in params.items():
            if key == "audio_encoder" and self.upstream is not None:
                mask[key] = _same(sub, cfg.audio_trainable)
            elif key == "audio_encoder":
                mask[key] = _same(sub, cfg.audio_trainable and not selected)
                encoder = mask[key]["encoder"]
                for i in selected:
                    encoder["layers"][i] = _same(sub["encoder"]["layers"][i], True)
                if cfg.reinit_layers and not self.audio_cfg.layer_norm_first:
                    encoder["layer_norm"] = _same(sub["encoder"]["layer_norm"], True)
            elif key == "clip":  # in the subtree's own key order, as the leaves are walked
                trains = {"visual": cfg.image_encoder_trainable,
                          "text": cfg.text_encoder_trainable, "logit_scale": False}
                mask[key] = {k: _same(v, trains[k]) for k, v in sub.items()}
            elif key == "criterion":
                mask[key] = _same(sub, cfg.cl_loss.temperature_trainable)
            else:
                mask[key] = _same(sub, True)
        return mask

    def extract_hidden_states(self, params: Params, wav: torch.Tensor,
                              wav_len: torch.Tensor, plain: bool = False):
        """-> (last hidden state, every hidden state): HuBERT's, then each
        live branch's (CLS rows stripped, the branch input dropped)."""
        audio_feat, audio_len, hidden_states = self.forward_audio(
            params, wav, wav_len, plain=plain, return_hidden_states=True
        )
        hidden_states = tuple(hidden_states)
        if self.use_cascaded:
            extra = branches.cascaded_branch_hidden_states(
                params["cascaded_branch"], self.config.cascaded_branch,
                audio_feat, audio_len, plain,
            )
            hidden_states = hidden_states + tuple(extra[1:])
        if self.use_parallel:
            extra = branches.parallel_branch_hidden_states(
                params["parallel_branch"], self.config.parallel_branch,
                audio_feat, audio_len, plain,
            )
            hidden_states = hidden_states + tuple(extra[1:])
        return hidden_states[-1], hidden_states

    def get_attention_weights(self, params: Params, wav: torch.Tensor,
                              wav_len: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """The cascaded branch's per-head CLS attention weights (B, H, K, K+T)."""
        audio_feat, audio_len = self.forward_audio(params, wav, wav_len, plain=plain)
        return branches.cascaded_branch_attention_map(
            params["cascaded_branch"], self.config.cascaded_branch, audio_feat, audio_len, plain,
        )

    def get_attention_map(self, params: Params, state: Params, wav: torch.Tensor,
                          wav_len: torch.Tensor, tokenizer=None, top_k: int = 10,
                          plain: bool = False):
        """-> (per utterance the CLS weights (H, K, K + len_i), per
        utterance and keyword the top-k nearest subwords). Without a
        tokenizer the subwords are original token ids. The special tokens
        (SOT, EOT and original id 0) are suppressed by identity, wherever
        they sit in a reduced table."""
        audio_feat, audio_len = self.forward_audio(params, wav, wav_len, plain=plain)
        branch_cfg = self.config.cascaded_branch
        weights = branches.cascaded_branch_attention_map(
            params["cascaded_branch"], branch_cfg, audio_feat, audio_len, plain,
        )
        keywords = branches.project_keywords_for_visualization(
            params["cascaded_branch"], state.get("cascaded_branch", {}), branch_cfg,
            audio_feat, audio_len, plain,
        )
        scores = branches.cosine_scores(keywords, params["clip"]["text"]["token_embedding"])
        suppress = {self.sot_id, self.eot_id}
        if self.reduced_vocab is not None:
            row0 = self.reduced_vocab.original_to_reduced.get(0)
            if row0 is not None:
                suppress.add(row0)
        else:
            suppress.add(0)
        for tok in sorted(suppress):
            scores[..., tok] -= 100.0
        top_ids = retrieval.top_k(scores, top_k)[1].cpu().numpy()
        weights_np = weights.cpu().numpy()
        lens = audio_len.cpu().numpy()
        cls_weights = [weights_np[i, :, :, : int(lens[i]) + self.keyword_num]
                       for i in range(weights_np.shape[0])]
        topk_kw = []
        for per_utt in top_ids:
            rows = []
            for per_kw in per_utt:
                ids = [self.reduced_vocab.reduced_to_original[int(i)] if self.reduced_vocab
                       is not None else int(i) for i in per_kw]
                rows.append([tokenizer.decoder[o].replace("</w>", "") for o in ids]
                            if tokenizer is not None else ids)
            topk_kw.append(rows)
        return cls_weights, topk_kw
