"""Text metrics: token / word / phone / char error rates and BLEU (the
port's own copy of speechclip_tpu/utils/metrics.py, the reference's
avssl/util/metric.py:7-77, on no SpeechCLIP path): edit-distance error
rates and corpus BLEU with the standard brevity penalty, in plain Python
(no ``editdistance`` or ``sacrebleu``).
"""

from __future__ import annotations

import math
from collections import Counter
from typing import List, Sequence


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance."""
    m, n = len(ref), len(hyp)
    if m == 0:
        return n
    if n == 0:
        return m
    prev = list(range(n + 1))
    for i in range(1, m + 1):
        cur = [i] + [0] * n
        for j in range(1, n + 1):
            cost = 0 if ref[i - 1] == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[n]


def _error_rate(refs: List[Sequence], hyps: List[Sequence]) -> float:
    assert len(refs) == len(hyps)
    total_err = sum(edit_distance(r, h) for r, h in zip(refs, hyps))
    total_len = sum(len(r) for r in refs)
    return total_err / max(total_len, 1)


def ter(refs: List[List[int]], hyps: List[List[int]]) -> float:
    """Token error rate (id sequences)."""
    return _error_rate(refs, hyps)


def wer(refs: List[str], hyps: List[str]) -> float:
    return _error_rate([r.split() for r in refs], [h.split() for h in hyps])


def per(refs: List[str], hyps: List[str]) -> float:
    """Phone error rate (space-separated phones)."""
    return wer(refs, hyps)


def cer(refs: List[str], hyps: List[str]) -> float:
    return _error_rate([list(r) for r in refs], [list(h) for h in hyps])


def _ngrams(tokens: Sequence, n: int) -> Counter:
    return Counter(
        tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1)
    )


def corpus_bleu(
    refs: List[str], hyps: List[str], max_n: int = 4
) -> float:
    """Corpus-level BLEU-N with uniform weights + brevity penalty, x100."""
    assert len(refs) == len(hyps)
    clipped = [0] * max_n
    totals = [0] * max_n
    ref_len = hyp_len = 0
    for ref, hyp in zip(refs, hyps):
        r, h = ref.split(), hyp.split()
        ref_len += len(r)
        hyp_len += len(h)
        for n in range(1, max_n + 1):
            rn, hn = _ngrams(r, n), _ngrams(h, n)
            totals[n - 1] += max(sum(hn.values()), 0)
            clipped[n - 1] += sum(
                min(c, rn.get(g, 0)) for g, c in hn.items()
            )
    if min(totals) == 0 or min(clipped) == 0:
        return 0.0
    log_p = sum(
        math.log(c / t) for c, t in zip(clipped, totals)
    ) / max_n
    bp = 1.0 if hyp_len > ref_len else math.exp(1 - ref_len / max(hyp_len, 1))
    return bp * math.exp(log_p) * 100.0


def report_bleu(refs: List[str], hyps: List[str]) -> dict:
    return {f"bleu@{n}": corpus_bleu(refs, hyps, n) for n in (1, 2, 3, 4)}
