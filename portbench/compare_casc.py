"""The numbers that decide ``correct`` in a cascaded train cell: those of
``compare.train_numbers`` (the reference teacher-forced on the program's
keyword ids, so that they stay continuous), and four of the keyword
choice. Each reads 0 when the two agree exactly and grows with the gap:

- ``kw_score_gap``: the largest, over the compared steps (the first steps
  and the window's checked step), relative L2 gap of the program's
  (B, K, V) cosine scores to the reference's;
- ``kw_id_mismatch``: the share of the compared B * K keyword rows whose
  program id is not the reference's own argmax;
- ``kw_tie_margin``: over those rows, the largest margin, in the
  reference's scores, between its own choice and the program's (0 where
  none differ): a near-tie flips by rounding, a wrong id lies far below;
- ``bn_state_gap``: kw-BN's running mean and variance, each as its change
  over the first steps, |change - reference change| / |reference change|,
  the worse of the two (a state left unchanged reads 1).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from .compare import train_numbers


def keyword_numbers(prog_scores: List[torch.Tensor], prog_ids: List[torch.Tensor],
                    ref_scores: List[torch.Tensor], ref_ids: List[torch.Tensor]) -> Dict:
    """Per step the program's (B, K, V) scores and (B, K) ids, and the
    reference's."""
    gap, rows, bad, margin = 0.0, 0, 0, 0.0
    for ps, pi, rs, ri in zip(prog_scores, prog_ids, ref_scores, ref_ids):
        rs, ri = rs.double().cpu(), ri.long().cpu()
        ps, pi = ps.double().cpu(), pi.long().cpu()
        gap = max(gap, float(torch.linalg.vector_norm(ps - rs) / torch.linalg.vector_norm(rs)))
        differ = pi != ri
        rows += pi.numel()
        bad += int(differ.sum())
        if differ.any():
            own = torch.gather(rs, -1, ri[..., None])[..., 0]
            took = torch.gather(rs, -1, pi[..., None])[..., 0]
            margin = max(margin, float((own - took)[differ].max()))
    return {"kw_score_gap": {"value": gap}, "kw_id_mismatch": {"value": bad / max(rows, 1)},
            "kw_tie_margin": {"value": margin}}


def bn_state_gap(prog_change: Dict[str, torch.Tensor], ref_change: Dict[str, torch.Tensor]):
    worst, where = 0.0, ""
    for name, r in ref_change.items():
        r = r.double().cpu()
        g = float(torch.linalg.vector_norm(prog_change[name].double().cpu() - r)
                  / torch.linalg.vector_norm(r).clamp(min=1e-30))
        if g >= worst:
            worst, where = g, name
    return {"bn_state_gap": {"value": worst, "where": where}}


def casc_numbers(prog: Dict, ref: Dict) -> Dict[str, Dict]:
    """``compare.train_numbers``' numbers and the keyword choice's.
    ``prog``: as ``train_numbers`` takes it, with per first step
    ``scores`` and ``ids``, ``bn_change``, and in ``window`` its step's
    ``scores`` and ``ids``; ``ref``: ``train_ref_casc.run_reference``'s,
    teacher-forced on those ids, with its ``window_step`` in ``window``."""
    out = train_numbers(prog, ref)
    ps, pi = list(prog["scores"]), list(prog["ids"])
    rs, ri = list(ref["scores"]), list(ref["own"])
    win = prog.get("window")
    if win is not None:
        ps.append(win["scores"])
        pi.append(win["ids"])
        rs.append(ref["window"]["scores"])
        ri.append(ref["window"]["own"])
    out.update(keyword_numbers(ps, pi, rs, ri))
    out.update(bn_state_gap(prog["bn_change"], ref["bn_change"]))
    return out
