"""MLP projection stack, eval mode (port of speechclip_tpu/ops/mlp.py):
Linear + ReLU per hidden layer, bare Linear last."""

from __future__ import annotations

from typing import Sequence

import torch

from .basic import Params, linear, linear_init


def mlp_init(generator: torch.Generator, units: Sequence[int]) -> Params:
    return {
        "layers": [
            linear_init(generator, u0, u1) for u0, u1 in zip(units[:-1], units[1:])
        ]
    }


def mlp_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    n = len(params["layers"])
    for i, layer in enumerate(params["layers"]):
        x = linear(layer, x)
        if i < n - 1:  # the reference drops the trailing ReLU + Dropout
            x = torch.relu(x)
    return x
