"""SpeechCLIP speech side, parallel branch, eval mode (port of the parallel
subset of speechclip_tpu/models/speechclip.py: ``init``, ``forward_audio``
and ``encode_speech``).

Parameters are a plain nested dict with the JAX package's keys
(``audio_encoder``, ``weighted_sum``, ``parallel_branch``, optional
``p_branch_proj``). ``cast_params`` moves them to a device once: matrices
(and conv kernels, and the cls rows) to the compute dtype, vectors (biases,
LayerNorm scale and bias, weighted-sum logits) kept in f32, as the TPU
kernels read them.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..config import SpeechCLIPConfig
from ..ops.basic import Params, l2_normalize
from ..ops.mlp import mlp_apply, mlp_init
from ..ops.weighted_sum import weighted_sum_apply, weighted_sum_init
from . import branches, hubert

WEIGHTED_SUM_MODE = "weighted_sum"


def compute_dtype(precision) -> torch.dtype:
    """``trainer.precision``: 16 / "bf16" run bf16, anything else f32."""
    if str(precision) in ("16", "bf16", "bfloat16"):
        return torch.bfloat16
    return torch.float32


def cast_params(params, dtype: torch.dtype, device=None):
    """Tensors of rank >= 2 -> ``dtype``; rank <= 1 -> f32; all on
    ``device``. Lists, dicts and None are kept as they are."""
    if params is None:
        return None
    if isinstance(params, dict):
        return {k: cast_params(v, dtype, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(cast_params(v, dtype, device) for v in params)
    return params.to(device=device, dtype=dtype if params.dim() >= 2 else torch.float32)


class SpeechCLIPModel:
    """Host-side description of the model; the math lives in the package's
    functions over the params dict."""

    def __init__(self, config: SpeechCLIPConfig):
        if config.audio_encoder_type != "FairseqHubert":
            raise NotImplementedError(
                f"audio encoder {config.audio_encoder_type!r}: custom upstreams "
                "wait for the ROADMAP item 'Variants' (models/upstream.py)"
            )
        if config.cascaded_objective_weight > 0:
            raise NotImplementedError(
                "the cascaded branch waits for the ROADMAP item 'Cascaded branch'"
            )
        if config.wsum_remat:
            raise NotImplementedError(
                "wsum_remat (the frozen weighted-sum custom VJP) waits for the "
                "ROADMAP item 'Training'"
            )
        if config.parallel_objective_weight <= 0:
            raise ValueError("this port runs the parallel branch; its weight is 0")
        self.config = config
        self.audio_cfg = config.audio
        self.compute_dtype = compute_dtype(config.precision)
        self.hidden_norm_type = (
            (config.normalize_type or "s3prl") if config.normalize_hiddenstates else None
        )

    def init(self, generator: torch.Generator) -> Params:
        """Random f32 params on ``generator.device`` (cast them with
        ``cast_params`` before running)."""
        cfg = self.config
        params: Params = {
            "audio_encoder": hubert.hubert_init(generator, self.audio_cfg),
            "parallel_branch": branches.parallel_branch_init(
                generator,
                cfg.parallel_branch,
                self.audio_cfg.encoder_embed_dim,
                cfg.clip_embed_dim,
            ),
        }
        if cfg.feat_select_idx == WEIGHTED_SUM_MODE:
            params["weighted_sum"] = weighted_sum_init(
                self.audio_cfg.num_hidden_states, generator.device
            )
        if cfg.parallel_branch_projection is not None:
            params["p_branch_proj"] = mlp_init(generator, cfg.parallel_branch_projection)
        return params

    def forward_audio(
        self,
        params: Params,
        wav: torch.Tensor,  # (B, L) float or int16 PCM, zero-padded
        wav_len: torch.Tensor,  # (B,) int
        plain: bool = False,
    ):
        """-> (audio features, feature lengths). int16 PCM is rescaled by
        1/32768 in f32 first (exact), then cast to the compute dtype."""
        if wav.dtype == torch.int16:
            wav = wav.float() * (1.0 / 32768.0)
        wav = wav.to(self.compute_dtype)
        hidden_states, feat_len = hubert.hubert_apply(
            params["audio_encoder"], self.audio_cfg, wav, wav_len, plain=plain
        )
        if self.hidden_norm_type in ("method1", "method2"):
            hidden_states = hubert.normalize_hidden_states(
                hidden_states, self.hidden_norm_type
            )
        select = self.config.feat_select_idx
        if select == WEIGHTED_SUM_MODE:
            feat = weighted_sum_apply(
                params["weighted_sum"],
                hidden_states,
                normalize_features=self.hidden_norm_type == "s3prl",
            )
        elif select == "last_hidden_state":
            feat = hidden_states[-1]
        elif select in ("hidden_states", "all"):
            feat = hidden_states
        elif isinstance(select, (list, tuple)):
            feat = [hidden_states[i] for i in select]
        else:
            raise KeyError(select)
        return feat, feat_len

    def encode_speech(
        self,
        params: Params,
        wav: torch.Tensor,
        wav_len: torch.Tensor,
        plain: bool = False,
    ) -> Dict[str, Any]:
        """-> {"parallel_audio_feat": (B, E) f32, L2-normalized}.
        ``plain=True`` runs every encoder layer through the plain PyTorch
        versions of the kernels, on any device."""
        audio_feat, audio_len = self.forward_audio(params, wav, wav_len, plain=plain)
        feat = branches.parallel_branch_apply(
            params["parallel_branch"],
            self.config.parallel_branch,
            audio_feat,
            audio_len,
            plain=plain,
        )
        if "p_branch_proj" in params:
            feat = mlp_apply(params["p_branch_proj"], feat)
        return {"parallel_audio_feat": l2_normalize(feat.float())}
