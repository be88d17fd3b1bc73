"""LR schedules (port of speechclip_tpu/ops/schedules.py): each a
``step -> lr`` function of the optimizer's update count, as the reference
steps its schedulers once per optimization step. Computed in f32, as the
JAX package computes them; the decay is not clamped past ``max_step``."""

from __future__ import annotations

from typing import Callable

import numpy as np


def noam_schedule(base_lr: float, warmup: int = 4000) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        s = np.float32(step)
        factor = (s + 1) / np.float32(warmup) if s < warmup else np.sqrt(
            np.float32(warmup) / (s + 1))
        return float(np.float32(base_lr) * np.float32(factor))

    return schedule


def linear_warmup_decay_schedule(base_lr: float, warmup: int = 4000, max_step: int = 1_000_000,
                                 final_lr: float = 1e-8) -> Callable[[int], float]:
    slope = np.float32(1.0 - final_lr / base_lr)

    def schedule(step: int) -> float:
        s = np.float32(step)
        if s < warmup:
            factor = (s + 1) / np.float32(warmup)
        else:
            factor = np.float32(1.0) - slope * (s + 1 - np.float32(warmup)) / np.float32(
                max_step - warmup)
        return float(np.float32(base_lr) * np.float32(factor))

    return schedule


def get_schedule(name: str, base_lr: float, warmup: int = 4000, max_step: int = 1_000_000,
                 final_lr: float = 1e-8) -> Callable[[int], float]:
    """``name`` "noam" (which reads ``warmup`` alone) or
    "linear_warmup_decay"."""
    if name == "noam":
        return noam_schedule(base_lr, warmup)
    if name == "linear_warmup_decay":
        return linear_warmup_decay_schedule(base_lr, warmup, max_step, final_lr)
    raise NotImplementedError(f"Unknown lr scheduler {name}")
