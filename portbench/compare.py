"""The numbers that decide ``correct``: what the timed path produced, held
against the plain reference. Every number reads 0 when the two agree
exactly and grows with the gap; each cell's limits file holds its limits.

Training (the first steps of the fit):
- ``rows_mismatch``: rows of the fed batches whose pair id, length or
  samples differ from the reference's reading of the corpus (limit 0);
- ``loss_gap``: the largest |loss - reference| / |reference| over the steps;
- ``grad1_gap``: the first gradient as Adam's first moment holds it, by the
  worst leaf: | |g| - |g_ref| | / max(|g_ref|, the median leaf's |g_ref|);
- ``change_gap``: the trainable leaves' change over the steps, by the worst
  leaf, the same way; leaves whose reference gradient is under a
  thousandth of the median leaf's (a gradient of rounding alone, such as
  the attention key bias under softmax) are left out;
- ``grad1_median_gap``, ``change_median_gap``: the same gaps' median over
  the leaves, steady from seed to seed where the worst leaf (a bias, a
  norm's scale, the temperature) swings.

Training (one step inside the window, from the program's state before it):
- ``rows_mismatch`` counts its rows too;
- ``window_loss_gap``: |loss - reference| / |reference| at that step;
- ``window_change_gap``: the step's change of the trainable leaves, by the
  worst leaf, as ``change_gap`` (the same rule on the step's gradient);
  ``window_change_median_gap`` its median over the leaves.

Encode + retrieve (sampled batches of the window):
- ``feature_gap``: the largest 1 - cos(feature, reference feature);
- ``topk_gap``: over the returned top-k, the largest amount by which an
  item's reference score lies below the reference's k-th best score.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

SMALL_GRAD = 1e-3


def _norms(tree: Dict) -> Dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def _leaf_gaps(prog: Dict, ref: Dict, keep=None) -> Dict:
    """{leaf: | |prog| - |ref| | / max(|ref|, the median leaf's |ref|)}."""
    ref_n, prog_n = _norms(ref), _norms(prog)
    keys = [k for k in ref_n if keep is None or k in keep]
    if set(keys) - set(prog_n):
        raise ValueError(f"leaves missing from the program: {sorted(set(keys) - set(prog_n))[:4]}")
    med = float(np.median([ref_n[k] for k in keys]))
    return {k: abs(prog_n[k] - ref_n[k]) / max(ref_n[k], med, 1e-30) for k in keys}


def _worst_and_median(gaps: Dict, name: str) -> Dict[str, Dict]:
    worst = max(gaps, key=gaps.get)
    return {f"{name}_gap": {"value": gaps[worst], "where": _name(worst)},
            f"{name}_median_gap": {"value": float(np.median(list(gaps.values())))}}


def rows_mismatch(prog_batches: List[Dict], ref_batches: List[Dict]) -> int:
    bad = 0
    for p, r in zip(prog_batches, ref_batches):
        if p["wav"].shape != r["wav"].shape:
            bad += len(r["id"])
            continue
        same = ((p["id"] == r["id"]) & (p["wav_len"] == r["wav_len"])
                & (p["wav"] == r["wav"]).all(axis=1))
        bad += int((~same).sum())
    return bad + abs(len(prog_batches) - len(ref_batches)) * len(ref_batches[0]["id"])


def _change_gaps(prog_change: Dict, ref_change: Dict, ref_grads: Dict) -> Dict:
    """Leaf gaps of a change, leaving out leaves whose reference gradient
    is under ``SMALL_GRAD`` of the median leaf's."""
    g = _norms(ref_grads)
    med = float(np.median(list(g.values())))
    moving = {k for k, n in g.items() if n >= SMALL_GRAD * med}
    return _leaf_gaps({k: prog_change[k] for k in moving}, {k: ref_change[k] for k in moving})


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, Dict]:
    """-> {name: {"value", "where"}}. With ``prog["window"]`` (the
    program's snapshot around one window step) ``ref["window"]`` is the
    reference's ``window_step`` from it."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    grads = _leaf_gaps({k: v.float() for k, v in prog["first_grads"].items()},
                       ref["first_grads"])
    prog_change = {k: prog["params_after"][k].float() - ref["initial"][k] for k in ref["change"]}
    changes = _change_gaps(prog_change, ref["change"], ref["first_grads"])
    batches, ref_batches = list(prog["batches"]), list(ref["batches"])
    out = {}
    win = prog.get("window")
    if win is not None:
        rw = ref["window"]
        batches.append(win["batch"])
        ref_batches.append(rw["batch"])
        step_change = {k: win["after"][k].float() - win["params"][k].float() for k in rw["change"]}
        out.update({"window_loss_gap": {"value": abs(win["loss"] - rw["loss"]) / abs(rw["loss"])},
                    **_worst_and_median(_change_gaps(step_change, rw["change"], rw["grads"]),
                                        "window_change")})
    return {"rows_mismatch": {"value": rows_mismatch(batches, ref_batches)},
            "loss_gap": {"value": loss},
            **_worst_and_median(grads, "grad1"), **_worst_and_median(changes, "change"), **out}


def _name(path) -> str:
    return "/".join(str(p) for p in path) if path else ""


def encode_numbers(feats: torch.Tensor, topk_idx: torch.Tensor, ref_feats: torch.Tensor,
                   ref_scores: torch.Tensor) -> Dict[str, Dict]:
    """``feats`` (N, E) and ``topk_idx`` (N, k) from the program; the
    reference's features (N, E) and scores against the gallery (N, G)."""
    f, r = feats.double(), ref_feats.double()
    cos = (f * r).sum(-1) / (torch.linalg.vector_norm(f, dim=-1) * torch.linalg.vector_norm(r, dim=-1))
    k = topk_idx.shape[1]
    kth = torch.topk(ref_scores.double(), k, dim=-1).values[:, -1:]
    got = torch.gather(ref_scores.double(), 1, topk_idx.long())
    return {"feature_gap": {"value": float((1.0 - cos).max())},
            "topk_gap": {"value": float((kth - got).clamp(min=0).max())}}
