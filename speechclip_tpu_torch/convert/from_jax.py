"""Carry the JAX package's params into the port.

The input is the JAX params pytree with every leaf already a numpy array
(``jax.tree.map(np.asarray, params)``), so this module never sees jax. Both
packages keep linear weights as (in, out) for ``y = x @ w + b``, so those
copy straight across. Convolution kernels change layout: JAX's WIO
``(k, in / groups, out)`` becomes torch's ``(out, in / groups, k)``, and
HWIO ``(kh, kw, in, out)`` (the CLIP image towers' convs) becomes OIHW
``(out, in, kh, kw)``. An s3prl upstream's ``audio_encoder`` comes across
too: APC's ``prenet`` and GRU ``layers`` as they are (the GRU keeps JAX's
(in, 3H) layout), CPC's ``convs`` turned from WIO and its ``gru``. The CLIP towers (``clip``: ``visual``, ``text``,
``logit_scale``) and the image projection (``img_enc_proj``) come across
whatever the branches; so do a trainable loss temperature (``criterion``:
``log_inv_temp``, or SupCon's ``temp``; a fixed one is an empty subtree and
stays behind, as the port's ``init`` builds none) and a learnable VQ
temperature (``cascaded_branch.vq.curr_temp``). The state tree (the
cascaded branch's kw-BN running statistics) comes across with
``speechclip_state_from_jax``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

PORT_KEYS = ("audio_encoder", "weighted_sum", "parallel_branch", "p_branch_proj",
             "cascaded_branch", "c_branch_proj", "img_enc_proj", "clip", "criterion")


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


def _hwio_to_oihw(tree: Any) -> Any:
    """Every 4-D ``w`` under ``tree`` (the image towers' conv kernels)."""
    if isinstance(tree, dict):
        return {k: (v.permute(3, 2, 0, 1).contiguous()
                    if k == "w" and isinstance(v, torch.Tensor) and v.dim() == 4
                    else _hwio_to_oihw(v)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_hwio_to_oihw(v) for v in tree]
    return tree


def speechclip_params_from_jax(tree: dict) -> dict:
    """JAX ``SpeechCLIPModel.init`` params (numpy leaves) -> the port's f32
    params dict on the CPU (cast with ``models.speechclip.cast_params``)."""
    params = {k: _tensors(tree[k]) for k in PORT_KEYS if tree.get(k)}
    if "clip" in params:
        params["clip"]["visual"] = _hwio_to_oihw(params["clip"]["visual"])
    ae = params.get("audio_encoder")
    if ae is not None and "feature_extractor" in ae:  # HuBERT
        for layer in ae["feature_extractor"]:
            layer["w"] = _wio_to_oik(layer["w"])
        pos = ae["encoder"]["pos_conv"]
        pos["w"] = _wio_to_oik(pos["w"])
    elif ae is not None and "convs" in ae:  # the CPC upstream's conv encoder
        for conv in ae["convs"]:
            conv["w"] = _wio_to_oik(conv["w"])
    return params


def speechclip_state_from_jax(state: dict) -> dict:
    """JAX ``SpeechCLIPModel.init`` state (numpy leaves; the kw-BN running
    mean and var under ``cascaded_branch.bn``) -> the port's f32 state."""
    return {k: _tensors(v) for k, v in state.items()}
