"""Carry the JAX package's params into the port.

The input is the JAX params pytree with every leaf already a numpy array
(``jax.tree.map(np.asarray, params)``), so this module never sees jax. Both
packages keep linear weights as (in, out) for ``y = x @ w + b``, so those
copy straight across. Convolution kernels change layout: JAX's WIO
``(k, in / groups, out)`` becomes torch's ``(out, in / groups, k)``.
Subtrees the port does not run (the CLIP image tower, the loss
temperature) are dropped; the CLIP text tower (``clip.text``) is carried
with the cascaded branch, which runs it. The state tree (the cascaded
branch's kw-BN running statistics) comes across with
``speechclip_state_from_jax``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

PORT_KEYS = ("audio_encoder", "weighted_sum", "parallel_branch", "p_branch_proj",
             "cascaded_branch", "c_branch_proj")


def _tensors(tree: Any) -> Any:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v) for v in tree]
    return torch.from_numpy(np.array(tree, dtype=np.float32))


def _wio_to_oik(w: torch.Tensor) -> torch.Tensor:
    return w.permute(2, 1, 0).contiguous()


def speechclip_params_from_jax(tree: dict) -> dict:
    """JAX ``SpeechCLIPModel.init`` params (numpy leaves) -> the port's f32
    params dict on the CPU (cast with ``models.speechclip.cast_params``)."""
    params = {k: _tensors(tree[k]) for k in PORT_KEYS if tree.get(k) is not None}
    if "cascaded_branch" in params:
        params["clip"] = {"text": _tensors(tree["clip"]["text"])}
    ae = params.get("audio_encoder")
    if ae is not None:
        for layer in ae["feature_extractor"]:
            layer["w"] = _wio_to_oik(layer["w"])
        pos = ae["encoder"]["pos_conv"]
        pos["w"] = _wio_to_oik(pos["w"])
    return params


def speechclip_state_from_jax(state: dict) -> dict:
    """JAX ``SpeechCLIPModel.init`` state (numpy leaves; the kw-BN running
    mean and var under ``cascaded_branch.bn``) -> the port's f32 state."""
    return {k: _tensors(v) for k, v in state.items()}
