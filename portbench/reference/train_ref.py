"""Train steps of a fit, worked out again by the plain reference: the
batches from the corpus on disk (``loader_plan``), the weights from the
seed (``portbench.weights``), the image-feature cache from the JPEGs, the
branch's dropout masks from the trainer's generator seed (the run's seed +
1) in the order the branch uses them, then per step the loss, its gradient
on the trainable leaves, the global-norm clip and an Adam step at the
schedule's learning rate.

``run_reference`` follows the fit's first steps from the seed alone;
``window_step`` follows one later step from the trainable leaves and Adam
moments that the program held just before it (the program's state: the
reference cannot reach step k on its own without following every step
before it), with the batch and the dropout masks still worked out again:
the masks by drawing, in order, those of every step before it.

Everything comes from the configuration file's plain tree and sizes; the
measured package is not imported.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..weights import make_params
from . import loader_plan
from .speechclip_par import (
    Adam,
    Precision,
    branch,
    clip_global,
    contrastive_loss,
    dropout_masks,
    f32_math,
    feature_lens,
    hubert_stack,
    l2n,
    linear_warmup_decay,
    load_images,
    vit,
    weighted_sum,
)

TRAINABLE_ROOTS = ("weighted_sum", "parallel_branch", "criterion")


def hyper(tree: Dict) -> Dict:
    """The values of a configuration tree (plain dicts) the reference reads."""
    ae, tr = tree["audio_encoder"], tree["trainer"]
    opt, sch = ae["optim"], ae["scheduler"]
    pb = tree["model_settings"]["parallel_branch"]["transformer_args"]
    cl = tree["cl_loss"]["args"]
    return {
        "batch_size": int(tree["data"]["batch_size"]),
        "crop": int(ae["max_audio_len"]),
        "s3prl_norm": bool(ae.get("normalize_hiddenstates", False)),
        "lr": float(opt["args"]["lr"]), "weight_decay": float(opt["args"].get("weight_decay", 0.0)),
        "betas": tuple(opt["args"].get("betas", (0.9, 0.999))),
        "eps": float(opt["args"].get("eps", 1e-8)),
        "warmup": int(sch["warmup"]), "max_step": int(sch["max_step"]),
        "final_lr": float(sch["final_lr"]),
        "clip": float(tr.get("gradient_clip_val", 0) or 0),
        "dropout": float(pb.get("dropout", 0.0)),
        "temperature": float(cl.get("temperature", 0.07)),
        "temperature_trainable": bool(cl.get("temperature_trainable", False)),
    }


def leaves(tree, prefix=()):
    """(path, leaf) of a tree of dicts and lists in insertion order, None
    leaves left out: the order in which the program walks its trees."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, prefix + (i,))
    elif tree is not None:
        yield prefix, tree


def to_f32(tree):
    if isinstance(tree, dict):
        return {k: to_f32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_f32(v) for v in tree]
    return None if tree is None else tree.float()


def rebuild(tree, values: Dict, prefix=()):
    """``tree`` with the leaves at the paths of ``values`` replaced."""
    if isinstance(tree, dict):
        return {k: rebuild(v, values, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [rebuild(v, values, prefix + (i,)) for i, v in enumerate(tree)]
    return values.get(prefix, tree)


def image_features(P: Precision, visual: Dict, v: Dict, paths: List[str], device,
                   chunk: int = 64) -> Dict[str, torch.Tensor]:
    unique = sorted(set(paths))
    out = {}
    with torch.no_grad():
        for lo in range(0, len(unique), chunk):
            part = unique[lo:lo + chunk]
            imgs = torch.from_numpy(load_images(part, v["image_size"])).to(device)
            for path, feat in zip(part, vit(P, visual, v, imgs)):
                out[path] = feat
    return out


class _Step:
    """What every reference step reads: the frozen weights in f32, the
    image features of the given images, the trainable leaves' skeleton."""

    def __init__(self, config: Dict, seed: int, device, P: Precision, image_paths: List[str],
                 rows: int):
        self.P, self.device, self.rows = P, device, rows
        self.hp, sizes = hyper(config["tree"]), config["sizes"]
        self.a, self.br, v = sizes["audio"], sizes["parallel_branch"], sizes["vision"]
        params = make_params(sizes, seed, device)
        self.audio = to_f32(params["audio_encoder"])
        self.img = image_features(P, to_f32(params["clip"]["visual"]), v, image_paths, device)
        self.initial = {path: t.detach().float().clone()
                        for path, t in leaves(params) if path[0] in TRAINABLE_ROOTS}
        self.skeleton = {k: params[k] for k in TRAINABLE_ROOTS if k in params}
        del params

    def frames(self, samples: int) -> int:
        for _ch, k, s in self.a["conv_layers"]:
            samples = (samples - k) // s + 1
        return samples

    def masks(self, gen, n: int, frames: int):
        hp, br = self.hp, self.br
        return ([dropout_masks(gen, n, frames + 1, br, hp["dropout"])
                 for _ in range(br["n_layers"])] if hp["dropout"] > 0 else None)

    def __call__(self, k: int, batch: Dict, train: Dict, order: List, adam: Adam, gen,
                 half_batch: bool):
        """One step (index ``k`` of the fit) in place on ``train`` -> (loss,
        the gradients as Adam's moments took them)."""
        P, hp, a, br, device = self.P, self.hp, self.a, self.br, self.device
        n = hp["batch_size"] // 2 if half_batch else hp["batch_size"]
        wav = torch.from_numpy(batch["wav"][:n]).to(device)
        lens = torch.from_numpy(batch["wav_len"][:n]).to(device)
        ids = torch.from_numpy(batch["id"][:n]).to(device)
        stack = hubert_stack(P, self.audio, a, wav, lens, self.rows, hp["s3prl_norm"])
        frames = stack.shape[2]
        tree = rebuild(self.skeleton, train)
        feat = weighted_sum(stack, tree["weighted_sum"]["weights"])
        masks = self.masks(gen, n, frames)
        speech = l2n(branch(P, tree["parallel_branch"], br, feat,
                            feature_lens(lens, a["downsample_rate"], frames), masks,
                            hp["dropout"]))
        image = l2n(torch.stack([self.img[p] for p in batch["image"][:n]]))
        if hp["temperature_trainable"]:
            inv_temp = torch.exp(tree["criterion"]["log_inv_temp"])
        else:
            inv_temp = torch.tensor(1.0 / hp["temperature"], device=device)
        loss = contrastive_loss(speech, image, ids, inv_temp)
        grads = torch.autograd.grad(loss, [train[p] for p in order])
        grads = clip_global(list(grads), hp["clip"])
        lr = linear_warmup_decay(k, hp["lr"], hp["warmup"], hp["max_step"], hp["final_lr"])
        taken = adam.step(grads, lr)
        return float(loss.detach()), [g.detach() for g in taken]


def _adam(hp: Dict, params: List[torch.Tensor]) -> Adam:
    return Adam(params, betas=hp["betas"], eps=hp["eps"], wd=hp["weight_decay"])


def run_reference(config: Dict, root: str, seed: int, steps: int, device,
                  precision: Optional[Precision] = None, half_batch: bool = False,
                  rows: int = 32) -> Dict:
    """-> {"losses", "first_grads" {path: the gradient Adam's moments took
    at step 1}, "change" {path: leaf after ``steps`` steps - its initial
    value}, "initial" {path: initial value}, "batches"}. ``half_batch``: the
    planted fault of a step that drops half of its rows and takes the mean
    over the rest."""
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
        losses, first = [], None
        for k, batch in enumerate(batches):
            loss, taken = step(k, batch, train, order, adam, gen, half_batch)
            losses.append(loss)
            if k == 0:
                first = dict(zip(order, taken))
        change = {p: (train[p].detach() - initial[p]) for p in order}
    return {"losses": losses, "first_grads": first, "change": change, "initial": initial,
            "batches": batches}


def window_step(config: Dict, root: str, seed: int, before: Dict, device,
                precision: Optional[Precision] = None, half_batch: bool = False,
                rows: int = 32) -> Dict:
    """The fit's step ``before["index"]`` from the program's trainable
    leaves and Adam moments just before it (``before["params"]``,
    ``["exp_avg"]``, ``["exp_avg_sq"]``: {path: tensor}) -> {"loss",
    "grads" {path: the gradient Adam's moments took}, "change" {path: the
    step's change of the leaf}, "batch"}."""
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
            step.masks(gen, hp["batch_size"], step.frames(samples))
        loss, taken = step(index, batch, train, order, adam, gen, half_batch)
        change = {p: train[p].detach() - start[p] for p in order}
    return {"loss": loss, "grads": dict(zip(order, taken)), "change": change, "batch": batch}
