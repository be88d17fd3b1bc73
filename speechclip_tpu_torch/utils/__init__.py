"""Utilities (port of speechclip_tpu/utils: the reference's avssl/util)."""

from .metrics import cer, corpus_bleu, edit_distance, per, report_bleu, ter, wer
from .penalty_scheduler import PenaltyScheduler

__all__ = [
    "cer",
    "corpus_bleu",
    "edit_distance",
    "per",
    "report_bleu",
    "ter",
    "wer",
    "PenaltyScheduler",
]
