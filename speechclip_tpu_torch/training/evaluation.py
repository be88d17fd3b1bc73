"""The validation epoch's retrieval metrics and keyword diagnostics (port
of the eval side of speechclip_tpu/training/evaluation.py): per-batch
outputs are collected on the host, the image features deduplicated by
pair id (five captions share one image), the full audio x image score
matrix built in f32 with TF32 off on the device, and recall@k computed in
both directions; for the cascaded branch, each keyword's nearest subwords
(cosine or pseudo-inverse) and their hit rate against the gold captions,
dumped as JSON by ``run_keyword_diagnostics``.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.speechclip import resolve_device
from ..ops import retrieval

logger = logging.getLogger(__name__)


def _host(x) -> np.ndarray:
    """A batch's array on the host; a bf16 tensor comes back as f32 (numpy
    has no bf16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def collect_validation_outputs(outputs: List[Dict]) -> Dict[str, np.ndarray]:
    """Concatenate the per-batch eval outputs on the host."""
    out = {}
    for key in ("id", "audio_feat", "image_feat", "keywords"):
        if key in outputs[0]:
            out[key] = np.concatenate([_host(o[key]) for o in outputs], axis=0)
    if "gold_text" in outputs[0]:
        out["gold_text"] = [t for o in outputs for t in o["gold_text"]]
    return out


def retrieval_metrics(
    collected: Dict[str, np.ndarray], recall_at: Sequence[int], device="cuda"
) -> Tuple[Dict, Dict, Dict]:
    """First image per pair id -> f32 scores (TF32 off) on ``device`` (the
    card unless asked otherwise) -> recall@k audio -> image, image ->
    audio and their mean."""
    dev = resolve_device(device)
    all_ids = collected["id"]
    _, first_idx = np.unique(all_ids, return_index=True)
    first_idx = np.sort(first_idx)
    img_ids = all_ids[first_idx]
    logger.info("Total #%d images, #%d audio", len(first_idx), len(collected["audio_feat"]))
    to_dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    score_per_audio = retrieval.scores(to_dev(collected["audio_feat"]),
                                       to_dev(collected["image_feat"][first_idx]))
    return retrieval.mutual_retrieval(score_per_audio, score_per_audio.T, to_dev(all_ids),
                                      to_dev(img_ids), recall_at)


def detokenize_keywords(
    keywords: np.ndarray,  # (N, K, D)
    token_embedding: np.ndarray,  # (V, D) (the reduced table under a reduced vocabulary)
    gold_texts: List[str],
    tokenizer,
    reduced_vocab=None,
    k_neighbors: int = 10,
    retrieve_method: str = "cosine",
    batch_size: int = 256,
) -> Tuple[np.ndarray, List[Dict], List[List[int]]]:
    """-> (hit rate per keyword x100, per-sample neighbour records, hit
    token ids per keyword), on the host. Without a tokenizer the neighbours
    are original token ids and nothing hits."""
    if retrieve_method not in ("cosine", "pseudo_inverse"):
        raise ValueError(f"retrieve_method {retrieve_method!r}")
    n, kw_num, dim = keywords.shape
    emb = token_embedding.astype(np.float32)
    if retrieve_method == "pseudo_inverse":
        emb_pinv = np.linalg.pinv(emb.T)  # (V, D)

    def to_original(idx: int) -> int:
        if reduced_vocab is not None:
            return int(reduced_vocab.reduced_to_original[int(idx)])
        return int(idx)

    hit_rate = np.zeros(kw_num)
    kw_top_ret: List[List[int]] = [[] for _ in range(kw_num)]
    records: List[Dict] = []
    emb_norm = emb / np.maximum(np.linalg.norm(emb, axis=-1, keepdims=True), 1e-8)
    for start in range(0, n, batch_size):
        kw = keywords[start:start + batch_size].astype(np.float32)
        bsz = kw.shape[0]
        flat = kw.reshape(-1, dim)
        if retrieve_method == "pseudo_inverse":
            scores = flat @ emb_pinv.T
        else:
            fn = flat / np.maximum(np.linalg.norm(flat, axis=-1, keepdims=True), 1e-8)
            scores = fn @ emb_norm.T
        # partition, then sort the k kept (the reference's topk order)
        k = min(k_neighbors, scores.shape[-1])
        part = np.argpartition(-scores, k - 1, axis=-1)[:, :k]
        part_val = np.take_along_axis(scores, part, axis=-1)
        order = np.argsort(-part_val, axis=-1)
        top_idx = np.take_along_axis(part, order, axis=-1).reshape(bsz, kw_num, k_neighbors)
        top_val = np.take_along_axis(part_val, order, axis=-1).reshape(bsz, kw_num, k_neighbors)
        for x in range(bsz):
            gold = gold_texts[start + x]
            gold_toks = set(tokenizer.encode(gold)) if tokenizer else set()
            neighbors = {}
            for ki in range(kw_num):
                inter = {to_original(i) for i in top_idx[x, ki]} & gold_toks
                if inter:
                    hit_rate[ki] += 1
                    kw_top_ret[ki].append(int(next(iter(inter))))
                neighbors[f"keyword_{ki}"] = [
                    [tokenizer.decoder[to_original(i)] if tokenizer else to_original(i), float(v)]
                    for i, v in zip(top_idx[x, ki], top_val[x, ki])
                ]
            records.append({"gold": gold, "neighbors": neighbors})
    hit_rate = hit_rate / max(n, 1) * 100.0
    return hit_rate, records, kw_top_ret


def run_keyword_diagnostics(
    model,
    collected: Dict,
    token_embedding,  # (V, D) tensor or array
    tokenizer,
    output_dir: str,
    epoch: int,
    kw_cfg: Optional[Mapping] = None,
) -> Optional[Dict[str, float]]:
    """The keyword diagnostics of a validation (JAX's
    ``run_keyword_diagnostics``, the reference's kwClip.py:278-466):
    ``detokenize_keywords`` over the collected keywords and ``gold_text``
    with ``kw_cfg``'s ``detokenized_K_neighbors`` (10) and
    ``retrieve_method`` ("cosine"), ``kw_cfg`` being the run's
    ``model_settings.cascaded_branch.keyword`` node; writes
    ``kw_hit_ep{epoch}.json`` (each keyword's hit token ids) and
    ``keywords_ep{epoch}.json`` (the neighbour records) under
    ``output_dir``. -> {"kw_i": hit rate x100}, or None without keywords,
    gold text or a tokenizer."""
    if "keywords" not in collected or tokenizer is None:
        return None
    gold = collected.get("gold_text")
    if gold is None:
        return None
    os.makedirs(output_dir, exist_ok=True)
    kw_cfg = kw_cfg or {}
    hit_rate, records, kw_top_ret = detokenize_keywords(
        collected["keywords"], _host(token_embedding), gold, tokenizer,
        reduced_vocab=model.reduced_vocab,
        k_neighbors=kw_cfg.get("detokenized_K_neighbors", 10),
        retrieve_method=kw_cfg.get("retrieve_method", "cosine"),
    )
    with open(os.path.join(output_dir, f"kw_hit_ep{epoch}.json"), "w") as f:
        json.dump(kw_top_ret, f)
    with open(os.path.join(output_dir, f"keywords_ep{epoch}.json"), "w") as f:
        json.dump(records, f)
    return {f"kw_{i}": float(hit_rate[i]) for i in range(len(hit_rate))}
