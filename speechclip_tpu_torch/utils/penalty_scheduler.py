"""Piecewise-linear loss-weight schedule by global step (port of
speechclip_tpu/utils/penalty_scheduler.py, the reference's
avssl/util/penalty_scheduler.py:4-28): a weight interpolated linearly
between keypoints, constant before the first and after the last.
"""

from __future__ import annotations

from typing import Sequence

import torch


class PenaltyScheduler:
    def __init__(self, weights: Sequence[float], keypoints: Sequence[int]):
        if len(weights) != len(keypoints):
            raise ValueError(f"{len(weights)} weights for {len(keypoints)} keypoints")
        if list(keypoints) != sorted(keypoints):
            raise ValueError(f"keypoints {list(keypoints)} are not ascending")
        self.weights = [float(w) for w in weights]
        self.keypoints = [int(k) for k in keypoints]
        self.value = self.weights[0]

    def update(self, global_step: int) -> float:
        self.value = self.get_value(global_step)
        return self.value

    def get_value(self, global_step: int) -> float:
        ks, ws = self.keypoints, self.weights
        if global_step <= ks[0]:
            return ws[0]
        if global_step >= ks[-1]:
            return ws[-1]
        for (k0, w0), (k1, w1) in zip(zip(ks[:-1], ws[:-1]), zip(ks[1:], ws[1:])):
            if k0 <= global_step <= k1:
                frac = (global_step - k0) / max(k1 - k0, 1)
                return w0 + (w1 - w0) * frac
        return ws[-1]

    def get_value_traced(self, global_step) -> torch.Tensor:
        """The weight at a tensor step, as an f32 tensor on its device, with
        no host read (JAX's jit-friendly form)."""
        step = torch.as_tensor(global_step).to(torch.float32)
        value = torch.full_like(step, self.weights[0])
        for (k0, w0), (k1, w1) in zip(zip(self.keypoints[:-1], self.weights[:-1]),
                                      zip(self.keypoints[1:], self.weights[1:])):
            frac = ((step - k0) / max(k1 - k0, 1)).clamp(0.0, 1.0)
            value = torch.where(step >= k0, w0 + (w1 - w0) * frac, value)
        return value
