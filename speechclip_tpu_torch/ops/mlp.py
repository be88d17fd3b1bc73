"""MLP projection stack (port of speechclip_tpu/ops/mlp.py): Linear + ReLU
+ Dropout per hidden layer, bare Linear last."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .basic import Params, dropout, linear, linear_init


def mlp_init(generator: torch.Generator, units: Sequence[int]) -> Params:
    return {
        "layers": [
            linear_init(generator, u0, u1) for u0, u1 in zip(units[:-1], units[1:])
        ]
    }


def mlp_apply(params: Params, x: torch.Tensor, dropout_rate: float = 0.1,
              generator: Optional[torch.Generator] = None, train: bool = False) -> torch.Tensor:
    n = len(params["layers"])
    for i, layer in enumerate(params["layers"]):
        x = linear(layer, x)
        if i < n - 1:  # the reference drops the trailing ReLU + Dropout
            x = dropout(torch.relu(x), dropout_rate, train, generator)
    return x
