"""Train steps of a cascaded model's fit, worked out again by the plain
reference, as ``train_ref`` works out the parallel model's: the batches
from the corpus on disk (``loader_plan``), the weights from the seed
(``portbench.weights_casc``), the image-feature cache from the JPEGs, the
head's dropout masks from the trainer's generator seed (the run's seed + 1)
in the order the program draws them, then per step the loss, its gradient
on the trainable leaves, the kw-BN running statistics, the global-norm clip
and an Adam step at the schedule's learning rate.

Each step also returns its cosine scores and its own argmax ids. Given the
program's ids of a step (``ids``), the step is teacher-forced: the hard
forward takes the program's subwords, the gradient the reference's own
softmax (``speechclip_casc.vq``).

Everything comes from the configuration file's plain tree and sizes; the
measured package is not imported.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..weights_casc import make_params, model_state, reduced_ids
from . import loader_plan
from .speechclip_casc import cascaded_branch, keep_mask
from .speechclip_par import (
    Precision,
    clip_global,
    contrastive_loss,
    f32_math,
    feature_lens,
    hubert_stack,
    l2n,
    linear_warmup_decay,
    weighted_sum,
)
from .train_ref import _adam, hyper, image_features, leaves, rebuild, to_f32

TRAINABLE_ROOTS = ("weighted_sum", "cascaded_branch", "criterion")


def special_ids(t: Dict):
    """(SOT, EOT) in the table the program holds: CLIP's last two ids, or
    their rows in the reduced table."""
    sot, eot = t["vocab_size"] - 2, t["vocab_size"] - 1
    ids = reduced_ids(t)
    if ids is None:
        return sot, eot
    rows = {int(o): i for i, o in enumerate(ids)}
    return rows[sot], rows[eot]


class _Step:
    """What every reference step reads: the frozen weights in f32, the
    image features of the given images, the trainable leaves' skeleton."""

    def __init__(self, config: Dict, seed: int, device, P: Precision, image_paths: List[str],
                 rows: int):
        self.P, self.device, self.rows = P, device, rows
        self.hp, sizes = hyper(config["tree"]), config["sizes"]
        self.a, self.c, self.t = sizes["audio"], sizes["cascaded_branch"], sizes["text"]
        self.sot, self.eot = special_ids(self.t)
        params = make_params(sizes, seed, device)
        self.audio = to_f32(params["audio_encoder"])
        self.text = to_f32(params["clip"]["text"])
        self.img = image_features(P, to_f32(params["clip"]["visual"]), sizes["vision"],
                                  image_paths, device)
        self.initial = {path: t.detach().float().clone()
                        for path, t in leaves(params) if path[0] in TRAINABLE_ROOTS}
        self.skeleton = {k: params[k] for k in TRAINABLE_ROOTS if k in params}
        self.state0 = {k: v.float() for k, v in model_state(sizes, device)["cascaded_branch"]
                       ["bn"].items()}
        del params

    def frames(self, samples: int) -> int:
        for _ch, k, s in self.a["conv_layers"]:
            samples = (samples - k) // s + 1
        return samples

    def keep(self, gen, n: int, frames: int):
        c = self.c
        return keep_mask(gen, n, frames, c["keyword_number"], c["dropout"]) if c["dropout"] > 0 \
            else None

    def __call__(self, k: int, batch: Dict, train: Dict, order: List, adam, gen, state: Dict,
                 ids: Optional[torch.Tensor] = None, half_batch: bool = False) -> Dict:
        """One step (index ``k`` of the fit) in place on ``train`` -> {"loss",
        "taken" (the gradients as Adam's moments took them), "scores",
        "own", "state"}."""
        P, hp, a, device = self.P, self.hp, self.a, self.device
        n = hp["batch_size"] // 2 if half_batch else hp["batch_size"]
        wav = torch.from_numpy(batch["wav"][:n]).to(device)
        lens = torch.from_numpy(batch["wav_len"][:n]).to(device)
        pair = torch.from_numpy(batch["id"][:n]).to(device)
        stack = hubert_stack(P, self.audio, a, wav, lens, self.rows, hp["s3prl_norm"])
        frames = stack.shape[2]
        tree = rebuild(self.skeleton, train)
        feat = weighted_sum(stack, tree["weighted_sum"]["weights"])
        keep = self.keep(gen, n, frames)
        out = cascaded_branch(P, tree["cascaded_branch"], state, self.c, self.text, self.t,
                              self.sot, self.eot, feat,
                              feature_lens(lens, a["downsample_rate"], frames), keep,
                              None if ids is None else ids[:n].to(device))
        image = l2n(torch.stack([self.img[p] for p in batch["image"][:n]]))
        if hp["temperature_trainable"]:
            inv_temp = torch.exp(tree["criterion"]["log_inv_temp"])
        else:
            inv_temp = torch.tensor(1.0 / hp["temperature"], device=device)
        loss = contrastive_loss(l2n(out["feat"]), image, pair, inv_temp)
        grads = torch.autograd.grad(loss, [train[p] for p in order])
        grads = clip_global(list(grads), hp["clip"])
        lr = linear_warmup_decay(k, hp["lr"], hp["warmup"], hp["max_step"], hp["final_lr"])
        taken = adam.step(grads, lr)
        return {"loss": float(loss.detach()), "taken": [g.detach() for g in taken],
                "scores": out["scores"].detach(), "own": out["own"], "state": out["state"]}


def _ids(ids, k: int):
    return None if ids is None else torch.as_tensor(ids[k])


def run_reference(config: Dict, root: str, seed: int, steps: int, device,
                  precision: Optional[Precision] = None, half_batch: bool = False,
                  rows: int = 32, ids: Optional[List] = None) -> Dict:
    """-> {"losses", "first_grads", "change", "initial", "batches" (as
    ``train_ref.run_reference``), "scores" and "own" (per step, (B, K, V)
    and (B, K)), "bn_change" {"mean", "var"}: the running statistics after
    ``steps`` steps less their initial values}. ``ids``: per step the
    program's (B, K) ids, for teacher forcing; ``half_batch``: the planted
    fault of a step that drops half of its rows."""
    hp = hyper(config["tree"])
    batches = loader_plan.first_batches(root, hp["crop"], hp["batch_size"], seed, steps)
    with f32_math():
        step = _Step(config, seed, device, precision or Precision(),
                     [p for b in batches for p in b["image"]], rows)
        initial = step.initial
        train = {path: t.clone().requires_grad_(True) for path, t in initial.items()}
        order = list(train)
        adam = _adam(hp, [train[p] for p in order])
        gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
        state = dict(step.state0)
        losses, first, scores, own = [], None, [], []
        for k, batch in enumerate(batches):
            got = step(k, batch, train, order, adam, gen, state, _ids(ids, k), half_batch)
            state = got["state"]
            losses.append(got["loss"])
            scores.append(got["scores"])
            own.append(got["own"])
            if k == 0:
                first = dict(zip(order, got["taken"]))
        change = {p: (train[p].detach() - initial[p]) for p in order}
        bn_change = {n: state[n] - step.state0[n] for n in state}
    return {"losses": losses, "first_grads": first, "change": change, "initial": initial,
            "batches": batches, "scores": scores, "own": own, "bn_change": bn_change}


def window_step(config: Dict, root: str, seed: int, before: Dict, device,
                precision: Optional[Precision] = None, half_batch: bool = False,
                rows: int = 32, ids=None) -> Dict:
    """The fit's step ``before["index"]`` from the program's trainable
    leaves and Adam moments just before it, as ``train_ref.window_step``,
    teacher-forced on ``ids`` (the program's (B, K) ids of that step) where
    given -> {"loss", "grads", "change", "batch", "scores", "own"}."""
    hp = hyper(config["tree"])
    index = int(before["index"])
    batch, earlier = loader_plan.batch_at(root, hp["crop"], hp["batch_size"], seed, index)
    with f32_math():
        step = _Step(config, seed, device, precision or Precision(), list(batch["image"]), rows)
        missing = set(step.initial) - set(before["params"])
        if missing:
            raise ValueError(f"trainable leaves missing from the program: {sorted(missing)[:4]}")
        order = list(step.initial)
        train = {p: before["params"][p].detach().float().clone().to(device).requires_grad_(True)
                 for p in order}
        start = {p: t.detach().clone() for p, t in train.items()}
        adam = _adam(hp, [train[p] for p in order])
        adam.m = [before["exp_avg"][p].detach().float().clone().to(device) for p in order]
        adam.v = [before["exp_avg_sq"][p].detach().float().clone().to(device) for p in order]
        adam.t = index
        gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
        for samples in earlier:  # every earlier step's masks, in order
            step.keep(gen, hp["batch_size"], step.frames(samples))
        got = step(index, batch, train, order, adam, gen, dict(step.state0),
                   None if ids is None else torch.as_tensor(ids), half_batch)
        change = {p: train[p].detach() - start[p] for p in order}
    return {"loss": got["loss"], "grads": dict(zip(order, got["taken"])), "change": change,
            "batch": batch, "scores": got["scores"], "own": got["own"]}
