"""A reference (PyTorch Lightning) SpeechCLIP checkpoint -> the port's params
(port of speechclip_tpu/convert/reference_ckpt.py).

The reference keeps everything in one Lightning ``.ckpt``: the full
``state_dict`` (the frozen HuBERT and CLIP towers too) and the pickled run
config under ``hyper_parameters``. This module maps its names onto the
port's params tree, with the port's own layouts (``convert/from_torch.py``:
linear weights ``(in, out)``, convolution kernels as torch keeps them,
``pos_conv``'s weight norm folded), and returns the config as a
``ConfigTree`` that ``config.model_config_from_tree`` reads.

State-dict prefixes (the reference's module tree):
  audio_encoder.encoder.*            fairseq HubertModel
  audio_encoder.weightedsum_layer.*  the weighted sum's logits
  clip.model.*                       OpenAI CLIP (token_embedding possibly
                                     already cut to the reduced vocabulary)
  criterion.temperature              a trainable log(1/t) scalar
  cascaded_branch.{cls,self_att,linear_proj,vector_quantizer,bn_layer}.*
  parallel_branch.{cls,self_att,linear_proj}.*
  {img_enc_proj_net,p_branch_proj_net,c_branch_proj_net}.sequential.*

Every leaf is f32 on the CPU; ``training.checkpoint.load_any_checkpoint``
places them for a model. A ``.ckpt`` is a pickle: load only files you trust.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

from ..config import CLIPConfig, ConfigTree, model_config_from_tree
from .from_torch import _lin, _ln, _mha_from_in_proj, _t, clip_from_openai, hubert_from_fairseq


def _sub_dict(sd: Mapping, prefix: str) -> Dict:
    plen = len(prefix)
    return {k[plen:]: v for k, v in sd.items() if k.startswith(prefix)}


# A released checkpoint's hyper_parameters pickle names classes of packages
# that are not dependencies here: pytorch_lightning's AttributeDict wraps the
# config, an avssl OrderedNamespace tree (its state is an ``_odict``
# OrderedDict in ``__dict__``). The tolerant unpickler resolves a class it
# cannot import to a generated dict subclass (pickle's reconstruction fills
# either its items or its ``__dict__``), and _as_plain_config flattens the
# result to nested plain dicts.
_STUB_CLASSES: Dict = {}


def _stub_class(module: str, name: str):
    key = (module, name)
    if key not in _STUB_CLASSES:
        _STUB_CLASSES[key] = type(name, (dict,), {"__module__": module, "_ckpt_stub": True})
    return _STUB_CLASSES[key]


def _tolerant_pickle_module():
    import pickle
    import types

    class TolerantUnpickler(pickle.Unpickler):
        def find_class(self, module, name):
            try:
                return super().find_class(module, name)
            except (ImportError, AttributeError):
                return _stub_class(module, name)

    # a real ModuleType: torch.load reads pickle_module.__name__
    mod = types.ModuleType("speechclip_tpu_torch_tolerant_pickle")
    mod.Unpickler = TolerantUnpickler
    mod.load = lambda f, **kw: TolerantUnpickler(f, **kw).load()
    mod.loads = pickle.loads
    mod.dumps = pickle.dumps
    mod.HIGHEST_PROTOCOL = pickle.HIGHEST_PROTOCOL
    return mod


def _as_plain_config(obj):
    """The unpickled reference config as nested plain dicts and lists:
    OrderedNamespace trees (stubs too; the data is ``__dict__['_odict']``,
    not the mapping surface), Lightning's AttributeDict (a dict subclass),
    argparse / SimpleNamespace objects."""
    state = getattr(obj, "__dict__", None)
    if isinstance(state, dict) and "_odict" in state:
        obj = state["_odict"]
    if isinstance(obj, Mapping):
        return {k: _as_plain_config(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_as_plain_config(v) for v in obj]
    if state and type(obj).__module__ in ("argparse", "types"):
        return {k: _as_plain_config(v) for k, v in vars(obj).items()}
    return obj


def _branch_transformer(sd: Mapping, transformer_type: str, n_layers: int) -> Dict:
    if transformer_type == "MultiheadAttentionAndNorm":
        return {"attn": _mha_from_in_proj(sd, "multihead_attn_layer"),
                "norm": _ln(sd, "attentionBlock_Norm")}
    if transformer_type == "TransformerEncoder":
        layers = [{
            "self_attn": _mha_from_in_proj(sd, f"model.layers.{i}.self_attn"),
            "linear1": _lin(sd, f"model.layers.{i}.linear1"),
            "linear2": _lin(sd, f"model.layers.{i}.linear2"),
            "norm1": _ln(sd, f"model.layers.{i}.norm1"),
            "norm2": _ln(sd, f"model.layers.{i}.norm2"),
        } for i in range(n_layers)]
        return {"layers": layers, "norm": _ln(sd, "model.norm")}
    raise NotImplementedError(transformer_type)


def _mlp(sd: Mapping, n_linears: int) -> Dict:
    """The reference's MLPLayers: Linears at sequential indices 0, 3, 6, ...
    (Linear, ReLU, Dropout triplets, the trailing pair stripped)."""
    return {"layers": [_lin(sd, f"sequential.{3 * i}") for i in range(n_linears)]}


def _cascaded_branch(c_sd: Mapping, bc) -> Tuple[Dict, Optional[Dict]]:
    """(the cascaded branch's params, its kw-BN running statistics or None)."""
    import torch

    branch: Dict = {
        "cls": _t(c_sd["cls"]),
        "transformer": _branch_transformer(_sub_dict(c_sd, "self_att."), bc.transformer_type,
                                           bc.transformer_args.get("n_layers", 1)),
    }
    if any(k.startswith("linear_proj.sequential") for k in c_sd):
        n_lin = len(bc.keyword.kw_projection.dimensions) - 1
        branch["proj"] = {"linear": None, "mlp": _mlp(_sub_dict(c_sd, "linear_proj."), n_lin)}
    else:
        branch["proj"] = {"linear": _lin(c_sd, "linear_proj"), "mlp": None}
    temp_spec = bc.vq.args.temp
    learnable = isinstance(temp_spec, str) and temp_spec.startswith("learnable")
    branch["vq"] = ({"curr_temp": _t(c_sd["vector_quantizer.curr_temp"])}
                    if learnable and "vector_quantizer.curr_temp" in c_sd else {})
    bn_state = None
    if any(k.startswith("bn_layer.") for k in c_sd):
        bn_sd = _sub_dict(c_sd, "bn_layer.")
        batchnorms = bc.keyword.batchnorms
        if batchnorms.type == "eachKw" and not batchnorms.get("parallel", False):
            # K separate BatchNorm1d modules -> (K, D)
            stack = lambda name: torch.stack(
                [_t(bn_sd[f"bn_layers.{i}.{name}"]) for i in range(bc.keyword.number)])
            branch["bn"] = {"scale": stack("weight"), "bias": stack("bias")}
            bn_state = {"mean": stack("running_mean"), "var": stack("running_var")}
        else:
            branch["bn"] = {"scale": _t(bn_sd["bn_layer.weight"]),
                            "bias": _t(bn_sd["bn_layer.bias"])}
            bn_state = {"mean": _t(bn_sd["bn_layer.running_mean"]),
                        "var": _t(bn_sd["bn_layer.running_var"])}
    return branch, bn_state


def convert_reference_checkpoint(checkpoint: Mapping, config: Optional[ConfigTree] = None
                                 ) -> Tuple[Dict, Dict, ConfigTree]:
    """-> (params, state, config) from the torch-loaded Lightning dict. The
    config is the pickled ``hyper_parameters`` one unless given; its
    reduced-vocabulary path is resolved (a released checkpoint names the
    reference repository's table, which maps to the copy under ``assets/``)."""
    from ..models.speechclip import resolve_asset_path

    sd = checkpoint["state_dict"]
    if config is None:
        hp = _as_plain_config(checkpoint.get("hyper_parameters", {}))
        cfg_obj = hp.get("config", hp) if isinstance(hp, Mapping) else hp
        if not isinstance(cfg_obj, Mapping):
            raise ValueError(
                "could not recover a config mapping from the checkpoint's hyper_parameters "
                f"(got {type(cfg_obj).__name__}); pass config= explicitly")
        config = ConfigTree(cfg_obj)
    reduce_path = config.clip.get("reduce_subword_embbedding")
    if reduce_path:
        config.clip.reduce_subword_embbedding = resolve_asset_path(str(reduce_path))
    model_cfg = model_config_from_tree(config)
    params: Dict = {
        "audio_encoder": hubert_from_fairseq(_sub_dict(sd, "audio_encoder.encoder."),
                                             model_cfg.audio),
        "clip": clip_from_openai(_sub_dict(sd, "clip.model."),
                                 CLIPConfig(vision=model_cfg.clip_vision,
                                            text=model_cfg.clip_text)),
    }
    state: Dict = {}
    if "audio_encoder.weightedsum_layer.weights" in sd:
        params["weighted_sum"] = {"weights": _t(sd["audio_encoder.weightedsum_layer.weights"])}
    if "criterion.temperature" in sd:
        temperature = _t(sd["criterion.temperature"])
        if temperature.dim() == 0:  # a trainable log(1/t)
            params["criterion"] = {"log_inv_temp": temperature}

    ms = config.model_settings
    if any(k.startswith("cascaded_branch.") for k in sd):
        branch, bn_state = _cascaded_branch(_sub_dict(sd, "cascaded_branch."),
                                            ms.cascaded_branch)
        params["cascaded_branch"] = branch
        if bn_state is not None:
            state["cascaded_branch"] = {"bn": bn_state}
    if any(k.startswith("parallel_branch.") for k in sd):
        bp = ms.parallel_branch
        p_sd = _sub_dict(sd, "parallel_branch.")
        branch = {"cls": _t(p_sd["cls"]),
                  "transformer": _branch_transformer(_sub_dict(p_sd, "self_att."),
                                                     bp.transformer_type,
                                                     bp.transformer_args.get("n_layers", 1))}
        if "linear_proj.weight" in p_sd:
            branch["proj"] = _lin(p_sd, "linear_proj")
        params["parallel_branch"] = branch
    for ours, ref, cfg_key in (("img_enc_proj", "img_enc_proj_net", "image_encoder_projection"),
                               ("p_branch_proj", "p_branch_proj_net", "parallel_branch_projection"),
                               ("c_branch_proj", "c_branch_proj_net",
                                "cascaded_branch_projection")):
        if any(k.startswith(ref + ".") for k in sd):
            n_lin = len(ms.get(cfg_key).dimensions) - 1
            params[ours] = _mlp(_sub_dict(sd, ref + "."), n_lin)
    return params, state, config


def load_reference_checkpoint(path: str, config: Optional[ConfigTree] = None):
    """``torch.load`` a Lightning ``.ckpt`` through the tolerant unpickler
    (its hyper_parameters name pytorch_lightning and avssl classes, neither
    installed here) and convert it: (params, state, config)."""
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_tolerant_pickle_module())
    return convert_reference_checkpoint(ckpt, config)
