"""Checkpoints with the JAX package's two-monitor policy (port of
speechclip_tpu/training/checkpoint.py).

The policy is the JAX ``CheckpointManager``'s: ``last`` after every
validation (``save_last``), ``step_{n}`` at each of ``save_at_steps``, and
per monitor (``val_loss``: min, top 1; ``val_recall_mean_10``: max, top 3)
the best checkpoints as ``{name}/{name}_step{step}_{value:.4f}``, with
``ckpt_index.json`` listing them and the stale ones deleted; the run's
config is written beside them as ``config.yaml``, so a restore needs no
other file.

The format is the port's own: each checkpoint directory holds
``state.pt`` (one ``torch.save`` of the params, the kw-BN running
statistics, the optimizer's and the LR scheduler's ``state_dict``, the
micro-batch count, the train state's generator state and an accumulation
in progress) and ``meta.json``. A save is written to a sibling
``<path>.tmp`` and renamed into place, so a save cut short leaves the
previous checkpoint at ``<path>`` whole.

Slim checkpoints (``trainer.checkpoint_frozen: false``) store the trainable
leaves only: frozen leaves are None. Restoring one takes the frozen towers
from the target, which ``SpeechCLIPModel.load_pretrained`` filled first.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from ..config import ConfigTree, load_config

DEFAULT_MONITORS = (
    {"name": "val_loss", "mode": "min", "top_k": 1},
    {"name": "val_recall_mean_10", "mode": "max", "top_k": 3},
)
STATE_FILE = "state.pt"


def _tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts and lists (None leaves kept)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, *items) for items in zip(tree, *rest)]
    if tree is None:
        return None
    return fn(tree, *rest)


def strip_frozen_params(params: Any, trainable_mask: Any) -> Any:
    """``params`` with every frozen leaf replaced by None."""
    return _tree_map(lambda m, p: p if m else None, trainable_mask, params)


def merge_restored_params(target: Any, restored: Any, trainable_mask: Any) -> Any:
    """Trainable leaves from ``restored``, frozen ones from ``target``."""
    return _tree_map(lambda m, t, r: r if m else t, trainable_mask, target, restored)


def _copy_into(target: Any, saved: Any) -> None:
    """Copy every saved leaf into the target's tensor in place (the
    optimizer holds the trainable leaves); a leaf that is the target's own
    (a slim checkpoint's frozen one, merged) stays as it is."""
    if isinstance(target, dict):
        for k in target:
            _copy_into(target[k], saved[k])
    elif isinstance(target, (list, tuple)):
        for t, s in zip(target, saved):
            _copy_into(t, s)
    elif target is not None and saved is not target:
        if saved is None:
            raise ValueError("the checkpoint holds no value for a leaf of the target")
        if saved.shape != target.shape or saved.dtype != target.dtype:
            raise ValueError(f"checkpoint leaf {tuple(saved.shape)} {saved.dtype} does not "
                             f"match the target's {tuple(target.shape)} {target.dtype}")
        with torch.no_grad():
            target.copy_(saved)


def _move(tree: Any, device) -> Any:
    return _tree_map(lambda t: t.to(device), tree)


class CheckpointManager:
    def __init__(self, root_dir: str, monitors: Sequence[Dict] = DEFAULT_MONITORS,
                 save_last: bool = True, save_at_steps: Sequence[int] = (),
                 slim_mask: Any = None):
        self.root_dir = os.path.abspath(root_dir)
        self.monitors = list(monitors)
        self.save_last = save_last
        self.save_at_steps = set(save_at_steps)
        self.slim_mask = slim_mask  # the params' trainable mask: frozen leaves left out
        self._index_path = os.path.join(self.root_dir, "ckpt_index.json")
        self._index: Dict[str, List[Dict]] = {m["name"]: [] for m in self.monitors}
        os.makedirs(self.root_dir, exist_ok=True)
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                self._index.update(json.load(f))

    # ------------------------------------------------------------------ save
    def _payload(self, state, optimizer, scheduler) -> Dict:
        params = state.params
        if self.slim_mask is not None:
            params = strip_frozen_params(params, self.slim_mask)
        return {
            "params": params,
            "model_state": state.model_state,
            "optimizer": None if optimizer is None else optimizer.state_dict(),
            "scheduler": None if scheduler is None else scheduler.state_dict(),
            "step": int(state.step),
            "generator": state.generator.get_state(),
            "acc_grads": state.acc_grads,
        }

    def _save_tree(self, path: str, payload: Dict, config: Optional[ConfigTree]) -> None:
        tmp, old = path + ".tmp", path + ".old"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, STATE_FILE))
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"slim": self.slim_mask is not None, "format": "torch"}, f)
        if os.path.exists(path):
            shutil.rmtree(old, ignore_errors=True)
            os.rename(path, old)
            os.rename(tmp, path)
            shutil.rmtree(old)
        else:
            os.rename(tmp, path)
        if config is not None:
            with open(os.path.join(self.root_dir, "config.yaml"), "w") as f:
                f.write(config.to_yaml())

    def save(self, state, step: int, metrics: Dict[str, float],
             config: Optional[ConfigTree] = None, optimizer=None, scheduler=None) -> List[str]:
        """Apply the monitor policy to ``state`` (a ``TrainState``) with its
        optimizer and scheduler; returns the paths written."""
        payload = self._payload(state, optimizer, scheduler)
        written = []
        if self.save_last:
            written.append(os.path.join(self.root_dir, "last"))
        if step in self.save_at_steps:
            written.append(os.path.join(self.root_dir, f"step_{step}"))
        for path in written:
            self._save_tree(path, payload, config)
        for mon in self.monitors:
            name, mode, top_k = mon["name"], mon["mode"], mon["top_k"]
            if name not in metrics:
                continue
            value = float(metrics[name])
            entries = self._index[name]
            better = sorted(entries + [{"step": step, "value": value}],
                            key=lambda e: e["value"], reverse=(mode == "max"))[:top_k]
            if {"step": step, "value": value} in better:
                path = os.path.join(self.root_dir, name, f"{name}_step{step}_{value:.4f}")
                self._save_tree(path, payload, config)
                written.append(path)
                for stale in entries:
                    if stale not in better:
                        shutil.rmtree(os.path.join(
                            self.root_dir, name,
                            f"{name}_step{stale['step']}_{stale['value']:.4f}"),
                            ignore_errors=True)
                self._index[name] = better
        with open(self._index_path, "w") as f:
            json.dump(self._index, f)
        return written

    # --------------------------------------------------------------- restore
    @staticmethod
    def read_meta(path: str) -> Dict:
        meta = os.path.join(path, "meta.json")
        if not os.path.exists(meta):
            return {}
        with open(meta) as f:
            return json.load(f)

    @classmethod
    def is_slim(cls, path: str) -> bool:
        return bool(cls.read_meta(path).get("slim"))

    def restore(self, path: str, target, optimizer=None, scheduler=None):
        """Restore ``path`` into ``target`` (a ``TrainState``): its params
        in place (the optimizer holds the trainable leaves), the kw-BN
        statistics, the step, the generator's state and an accumulation in
        progress; the optimizer's and scheduler's state where given. For a
        slim checkpoint ``target`` must already carry the frozen towers
        (``load_pretrained``)."""
        file = os.path.join(path, STATE_FILE)
        if not os.path.exists(file):
            raise FileNotFoundError(f"{file}: not a checkpoint of the port (torch.save format)")
        if self.is_slim(path) and self.slim_mask is None:
            raise ValueError(
                f"{path} is a slim checkpoint (frozen towers excluded); construct the "
                "CheckpointManager with slim_mask (set trainer.checkpoint_frozen: false) to "
                "restore it")
        payload = torch.load(file, map_location="cpu", weights_only=True)
        saved = payload["params"]
        if self.slim_mask is not None:
            saved = merge_restored_params(target.params, saved, self.slim_mask)
        _copy_into(target.params, saved)
        device = target.generator.device
        if optimizer is not None and payload["optimizer"] is not None:
            optimizer.load_state_dict(payload["optimizer"])
        if scheduler is not None and payload["scheduler"] is not None:
            scheduler.load_state_dict(payload["scheduler"])
        generator = target.generator
        generator.set_state(payload["generator"])
        acc = payload["acc_grads"]
        return dataclasses.replace(
            target, model_state=_move(payload["model_state"], device), step=payload["step"],
            generator=generator, acc_grads=None if acc is None else _move(acc, device))

    def restore_last(self, target, optimizer=None, scheduler=None):
        """``restore`` of the run's ``last`` checkpoint."""
        return self.restore(os.path.join(self.root_dir, "last"), target, optimizer, scheduler)

    def best_path(self, monitor: str) -> Optional[str]:
        entries = self._index.get(monitor, [])
        if not entries:
            return None
        best = entries[0]
        return os.path.join(self.root_dir, monitor,
                            f"{monitor}_step{best['step']}_{best['value']:.4f}")


def load_config_from_checkpoint(ckpt_dir: str) -> ConfigTree:
    """The run's ``config.yaml``: in the checkpoint directory, or one or two
    levels up (the ckpts root)."""
    ckpt_dir = ckpt_dir.rstrip("/")
    for cand in (os.path.join(ckpt_dir, "config.yaml"),
                 os.path.join(os.path.dirname(ckpt_dir), "config.yaml"),
                 os.path.join(os.path.dirname(os.path.dirname(ckpt_dir)), "config.yaml")):
        if os.path.exists(cand):
            return load_config(cand)
    raise FileNotFoundError(f"no config.yaml found near {ckpt_dir}")


def load_any_checkpoint(ckpt_path: str, device="cuda"):
    """(model, params, model_state) from a reference Lightning ``.ckpt``
    (converted by ``convert/reference_ckpt.py``, the params placed as a
    train state places them) or from a run checkpoint of the port
    (``restore_inference_state`` with the ``config.yaml`` beside it): the
    restore path of the serving runtime. The JAX package's switch of PRNG
    implementation (``trainer.fast_rng``) has no counterpart: the port has
    one generator implementation, so there is nothing to configure first."""
    if str(ckpt_path).endswith(".ckpt"):
        from ..config import model_config_from_tree
        from ..convert.reference_ckpt import load_reference_checkpoint
        from ..models.speechclip import SpeechCLIPModel
        from .train_step import create_train_state

        params, model_state, config = load_reference_checkpoint(ckpt_path)
        model = SpeechCLIPModel(model_config_from_tree(config), device=device)
        state = create_train_state(model, params=params, model_state=model_state)
        return model, state.params, state.model_state
    return restore_inference_state(load_config_from_checkpoint(ckpt_path), ckpt_path, device)


def restore_inference_state(config: ConfigTree, ckpt_path: str, device="cuda"):
    """(model, params, model_state) from a run checkpoint, without the run
    machinery (no run directory, no metrics file). A slim checkpoint gets
    its frozen towers from ``load_pretrained`` first."""
    from ..config import model_config_from_tree
    from ..models.speechclip import SpeechCLIPModel
    from .train_step import create_train_state

    model = SpeechCLIPModel(model_config_from_tree(config), device=device)
    state = create_train_state(model, seed=0)
    mask = model.trainable_mask(state.params)
    slim = CheckpointManager.is_slim(ckpt_path)
    if slim:
        state = dataclasses.replace(state, params=model.load_pretrained(state.params))
    mgr = CheckpointManager(os.path.dirname(os.path.abspath(ckpt_path)),
                            slim_mask=mask if slim else None)
    state = mgr.restore(ckpt_path, state)
    return model, state.params, state.model_state
