"""SpeechCLIP's two branch heads (port of speechclip_tpu/models/branches.py),
in eval mode or in train mode (dropout and the VQ's train forms drawn from
one ``torch.Generator``; kw-BN on batch statistics, returning its new
running statistics).

- parallel branch (:308-367): a learnable CLS row prepended to the audio
  features, a TransformerEncoder over (CLS + frames), the CLS output
  projected to the image-embedding width.
- cascaded branch (:37-302): K learnable keyword CLS rows attend over the
  audio features (one MultiheadAttentionAndNorm in SpeechCLIP base),
  project into the CLIP text-embedding space, pass kw-BN, are scored by
  cosine against the token-embedding table, vector-quantized to subwords,
  multiplied back through the table, and the K pseudo-subwords go through
  the CLIP text tower.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.basic import Params, linear, linear_init, normal
from ..ops.kw_bn import kw_bn_apply, kw_bn_init
from ..ops.masking import key_padding_mask
from ..ops.mlp import mlp_apply, mlp_init
from ..ops.transformer import (
    branch_transformer_apply,
    branch_transformer_hidden_states,
    branch_transformer_init,
    mha_and_norm_apply,
)
from ..ops.vq import vq_apply, vq_init
from ..utils import tracing
from . import clip as clip_mod


def _prepend_cls(params: Params, audio_feat: torch.Tensor) -> torch.Tensor:
    """(B, T, D) -> (B, K + T, D) with the K learnable cls rows first."""
    cls = params["cls"].to(audio_feat.dtype)
    cls = cls.expand(audio_feat.shape[0], *cls.shape[1:])
    return torch.cat([cls, audio_feat], dim=1)


def _src_and_mask(params: Params, audio_feat: torch.Tensor, audio_len: torch.Tensor):
    """-> (src (B, K+T, D), key-padding mask (B, K+T), key lengths (B,))."""
    kw_num = params["cls"].shape[1]
    lens = audio_len + kw_num
    kpm = key_padding_mask(lens, audio_feat.shape[1] + kw_num)
    return _prepend_cls(params, audio_feat), kpm, lens


def cosine_scores(keywords: torch.Tensor, embedding: torch.Tensor,
                  eps: float = 1e-8) -> torch.Tensor:
    """(B, K, D) x (V, D) -> (B, K, V) f32 cosine similarities,
    ``dot / max(|a| |b|, eps)`` (torch ``F.cosine_similarity``)."""
    kw, emb = keywords.float(), embedding.float()
    dots = kw @ emb.T
    kn = torch.linalg.vector_norm(kw, dim=-1)[:, :, None]
    en = torch.linalg.vector_norm(emb, dim=-1)[None, None, :]
    return dots / torch.clamp(kn * en, min=eps)


# ---------------------------------------------------------------------------
# cascaded branch
# ---------------------------------------------------------------------------
def cascaded_branch_init(
    generator: torch.Generator,
    branch_cfg,  # config.CascadedBranchConfig
    audio_dim: int,
    text_dim: int,
    token_embedding: torch.Tensor,  # (V, text_dim), for the kw-BN init
) -> Tuple[Params, Params]:
    """-> (params, state); the state holds the kw-BN running statistics."""
    d_model, kw_num = branch_cfg.d_model, branch_cfg.keyword_number
    params: Params = {
        "cls": normal((1, kw_num, d_model), 1.0, generator),
        "transformer": branch_transformer_init(generator, branch_cfg.transformer_type, branch_cfg),
    }
    dims = branch_cfg.kw_projection
    if dims is None:
        params["proj"] = {"linear": linear_init(generator, d_model, text_dim), "mlp": None}
    else:
        if dims[0] != d_model or dims[-1] != text_dim:
            raise ValueError(f"kw_projection {dims} must run {d_model} -> {text_dim}")
        params["proj"] = {"linear": None, "mlp": mlp_init(generator, dims)}
    params["vq"] = vq_init(branch_cfg.vq_temp, generator.device)
    state: Params = {}
    if branch_cfg.batchnorm_type is not None:
        emb32 = token_embedding.float()
        params["bn"], state["bn"] = kw_bn_init(
            kw_num, text_dim, branch_cfg.batchnorm_type, emb32.mean(dim=0), emb32.std(dim=0),
            std_scale=branch_cfg.bn_std_scale, parallel=branch_cfg.bn_parallel,
        )
    return params, state


def _project_keywords(params: Params, branch_cfg, keywords: torch.Tensor, train: bool = False,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    if params["proj"].get("mlp") is not None:
        return mlp_apply(params["proj"]["mlp"], keywords, branch_cfg.kw_projection_dropout,
                         generator, train)
    return linear(params["proj"]["linear"], keywords)


def _pre_vq_keywords(params: Params, state: Params, branch_cfg, audio_feat: torch.Tensor,
                     audio_len: torch.Tensor, plain: bool, train: bool,
                     generator: Optional[torch.Generator], mesh=None) -> Tuple[torch.Tensor, Params]:
    """Branch body -> K keyword rows -> projection -> kw-BN (over the global
    batch of ``mesh``): (keywords (B, K, text_dim), the new state)."""
    src, kpm, lens = _src_and_mask(params, audio_feat, audio_len)
    out = branch_transformer_apply(params["transformer"], branch_cfg.transformer_type,
                                   branch_cfg, src, kpm, key_valid_lens=lens, plain=plain,
                                   train=train, generator=generator)
    keywords = _project_keywords(params, branch_cfg, out[:, : branch_cfg.keyword_number],
                                 train, generator)
    if "bn" not in params:
        return keywords, state
    keywords, bn_state = kw_bn_apply(params["bn"], state["bn"], keywords,
                                     batchnorm_type=branch_cfg.batchnorm_type,
                                     parallel=branch_cfg.bn_parallel, train=train,
                                     replica_groups=branch_cfg.bn_replica_groups, mesh=mesh)
    return keywords, {**state, "bn": bn_state}


def project_keywords_for_visualization(params: Params, state: Params, branch_cfg,
                                       audio_feat: torch.Tensor, audio_len: torch.Tensor,
                                       plain: bool = False) -> torch.Tensor:
    """The keywords before VQ at eval, (B, K, text_dim), which the attention
    map also scores against the token table."""
    return _pre_vq_keywords(params, state, branch_cfg, audio_feat, audio_len, plain,
                            False, None)[0]


def cascaded_branch_apply(
    params: Params,
    state: Params,
    branch_cfg,
    clip_params: Params,
    clip_cfg,  # config.CLIPTextConfig
    sot_id: int,
    eot_id: int,
    audio_feat: torch.Tensor,  # (B, T, D)
    audio_len: torch.Tensor,  # (B,)
    plain: bool = False,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
    num_updates: Optional[torch.Tensor] = None,
    mesh=None,
):
    """-> (text-tower features (B, output_dim), vq_results, keywords
    (B, K, text_dim) after VQ, in the activation dtype, the new state). At
    eval the kw-BN state is read and returned as it is; in train mode it
    moves with the batch statistics. ``num_updates`` drives a scheduled VQ
    temperature. ``mesh``: the rows are this rank's shard; kw-BN's
    statistics and the VQ's diagnostics are the global batch's."""
    with tracing.span("speechclip.cascaded.head", device=True):
        keywords, new_state = _pre_vq_keywords(params, state, branch_cfg, audio_feat, audio_len,
                                               plain, train, generator, mesh)
    table = clip_params["text"]["token_embedding"]
    with tracing.span("speechclip.cascaded.vq", device=True):
        vq_results = vq_apply(
            params["vq"], cosine_scores(keywords, table), temp_spec=branch_cfg.vq_temp,
            use_gumbel=branch_cfg.use_gumbel, hard=branch_cfg.hard, train=train,
            generator=generator, num_updates=num_updates,
            ground_truth_perplexity=branch_cfg.ground_truth_perplexity, mesh=mesh,
        )
        keywords = (vq_results["subword_prob"] @ table.float()).to(audio_feat.dtype)
    with tracing.span("speechclip.cascaded.text", device=True):
        feat = clip_mod.encode_keywords(clip_params, clip_cfg, keywords, sot_id, eot_id, plain)
    return feat, vq_results, keywords, new_state


def cascaded_branch_hidden_states(params: Params, branch_cfg, audio_feat: torch.Tensor,
                                  audio_len: torch.Tensor, plain: bool = False):
    """Per-layer hidden states with the K CLS rows stripped."""
    src, kpm, _ = _src_and_mask(params, audio_feat, audio_len)
    hiddens = branch_transformer_hidden_states(params["transformer"], branch_cfg.transformer_type,
                                               branch_cfg, src, kpm, plain)
    return tuple(h[:, branch_cfg.keyword_number:] for h in hiddens)


def cascaded_branch_attention_map(params: Params, branch_cfg, audio_feat: torch.Tensor,
                                  audio_len: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """Per-head attention weights of the K CLS rows, (B, H, K, K + T) f32.
    Defined for the MultiheadAttentionAndNorm body only."""
    if branch_cfg.transformer_type != "MultiheadAttentionAndNorm":
        raise ValueError("the attention map needs the MultiheadAttentionAndNorm body")
    src, kpm, _ = _src_and_mask(params, audio_feat, audio_len)
    _, weights = mha_and_norm_apply(params["transformer"], src, nhead=branch_cfg.nhead,
                                    key_padding_mask=kpm, need_weights=True, plain=plain)
    return weights[:, :, : branch_cfg.keyword_number, :]


# ---------------------------------------------------------------------------
# parallel branch
# ---------------------------------------------------------------------------
def parallel_branch_init(
    generator: torch.Generator, branch_cfg, audio_dim: int, out_dim: int
) -> Params:
    d_model = branch_cfg.d_model
    params: Params = {
        "cls": normal((1, 1, d_model), 1.0, generator),
        "transformer": branch_transformer_init(generator, "TransformerEncoder", branch_cfg),
    }
    if branch_cfg.need_projection:
        params["proj"] = linear_init(generator, audio_dim, out_dim)
    return params


def parallel_branch_apply(
    params: Params,
    branch_cfg,
    audio_feat: torch.Tensor,  # (B, T, D)
    audio_len: torch.Tensor,  # (B,) feature lengths
    plain: bool = False,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """-> (B, out_dim). Keys are masked with ``audio_len + 1`` (the CLS); in
    train mode the body's dropout is drawn from ``generator``."""
    src = _prepend_cls(params, audio_feat)
    out = branch_transformer_apply(
        params["transformer"], "TransformerEncoder", branch_cfg, src, None,
        key_valid_lens=audio_len + params["cls"].shape[1], plain=plain,
        train=train, generator=generator,
    )
    out = out[:, 0]
    if "proj" in params:
        out = linear(params["proj"], out)
    return out


def parallel_branch_hidden_states(params: Params, branch_cfg, audio_feat: torch.Tensor,
                                  audio_len: torch.Tensor, plain: bool = False):
    """Per-layer hidden states with the CLS row stripped."""
    src, kpm, _ = _src_and_mask(params, audio_feat, audio_len)
    hiddens = branch_transformer_hidden_states(params["transformer"], "TransformerEncoder",
                                               branch_cfg, src, kpm, plain)
    return tuple(h[:, 1:] for h in hiddens)
