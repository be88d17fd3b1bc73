"""The training and validation steps (port of
speechclip_tpu/training/train_step.py): forward, the contrastive loss,
backward, the global-norm clip, Adam and the LR schedule, on one device.

    model = SpeechCLIPModel(flagship_config())            # on the card
    state = create_train_state(model, seed=0)
    optimizer, scheduler = build_optimizer(model.config, state.params,
                                           model.trainable_mask(state.params))
    step = make_train_step(model, optimizer, scheduler,
                           model.config.accumulate_grad_batches)
    state, metrics = step(state, batch)

The train state keeps the trainable leaves f32 (the master weights Adam
updates, in place: the branches, and the encoder's or a CLIP tower's where
the config trains them) and the frozen ones in the compute dtype as
``cast_params`` casts them, without ``requires_grad``: a frozen leaf takes
no gradient (JAX's ``stop_gradient`` on the frozen leaves), so
``grad_norm`` and the clip see the trainable leaves alone, as JAX's do.
It also keeps the kw-BN running statistics; the micro-batch count; and the
``torch.Generator`` the dropout masks and the Gumbel noise are drawn from.
Data-parallel training (with the loss's feature all-gather) waits for the
ROADMAP item "DDP". ``device_prefetch`` stages host batches on the card
ahead of the step that takes them.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..models.speechclip import SpeechCLIPModel, cast_params
from ..ops.basic import Params
from .optim import clip_by_global_norm, global_norm, trainable_leaves


@dataclasses.dataclass
class TrainState:
    params: Params
    model_state: Params  # kw-BN running statistics
    step: int  # micro-batches taken
    generator: torch.Generator  # dropout and Gumbel noise
    acc_grads: Optional[List[torch.Tensor]] = None  # the running mean under accumulation


def _place(params: Params, mask: Params, dtype: torch.dtype, device) -> Params:
    """Trainable leaves -> fresh f32 copies on ``device`` that require grad;
    frozen leaves -> ``cast_params``'s dtype and device."""
    frozen = cast_params(params, dtype, device)

    def walk(p, f, m):
        if isinstance(p, dict):  # sorted keys: one leaf order, so one optimizer order
            return {k: walk(p[k], f[k], m[k]) for k in sorted(p)}
        if isinstance(p, (list, tuple)):
            return [walk(a, b, c) for a, b, c in zip(p, f, m)]
        if p is None or not m:
            return f
        return p.detach().to(device=device, dtype=torch.float32).clone().requires_grad_(True)

    return walk(params, frozen, mask)


def create_train_state(model: SpeechCLIPModel, seed: int = 0, params: Optional[Params] = None,
                       model_state: Optional[Params] = None,
                       rng_seed: Optional[int] = None) -> TrainState:
    """The model's seeded ``init`` (or the given params and state, e.g.
    carried from JAX) placed for training, and a generator seeded with
    ``rng_seed`` (default ``seed + 1``, a stream apart from the init's)."""
    if params is None:
        params, model_state = model.init(seed)
    mask = model.trainable_mask(params)
    state = {k: v for k, v in (model_state or {}).items()}
    return TrainState(
        params=_place(params, mask, model.compute_dtype, model.device),
        model_state=_to_f32(state, model.device),
        step=0,
        generator=torch.Generator(device=model.device).manual_seed(
            seed + 1 if rng_seed is None else rng_seed),
    )


def _to_f32(tree, device):
    if isinstance(tree, dict):
        return {k: _to_f32(v, device) for k, v in tree.items()}
    return tree.detach().to(device=device, dtype=torch.float32).clone()


def make_train_step(model: SpeechCLIPModel, optimizer: torch.optim.Optimizer,
                    scheduler: torch.optim.lr_scheduler.LRScheduler,
                    accumulate_grad_batches: int = 1, plain: bool = False):
    """-> ``train_step(state, batch) -> (state, metrics)``.

    With ``accumulate_grad_batches = k`` the micro-batch gradients are
    averaged (optax ``MultiSteps``' running mean) and the clip, the Adam
    step and the schedule step run once per k micro-batches; the VQ's
    scheduled temperature reads ``step // k``, the optimizer's count.
    ``grad_norm`` is the micro-batch gradient's global norm over the
    trainable leaves (the frozen ones carry none). ``plain``: every kernel
    route through its plain version. The optimizer must hold the trainable
    leaves of the state it steps (``build_optimizer`` over ``state.params``):
    the step checks that, since a leaf the forward does not use would take
    a zero gradient."""
    accum = max(int(accumulate_grad_batches), 1)
    leaves = optimizer.param_groups[0]["params"]
    clip = float(model.config.gradient_clip_val or 0.0)

    def train_step(state: TrainState, batch: Dict[str, Any]) -> Tuple[TrainState, Dict]:
        own = trainable_leaves(state.params, model.trainable_mask(state.params))
        if len(own) != len(leaves) or any(a is not b for a, b in zip(own, leaves)):
            raise ValueError("the optimizer does not hold this state's trainable leaves: "
                             "build it over state.params")
        num_updates = torch.tensor(state.step // accum, device=model.device)
        loss_feats, log_metrics, _, new_model_state = model.forward(
            state.params, state.model_state, batch, generator=state.generator, train=True,
            num_updates=num_updates, plain=plain)
        losses = model.compute_loss(state.params, loss_feats)
        grads = torch.autograd.grad(losses["loss"], leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        metrics = {f"train_{k}": v.detach() for k, v in {**losses, **log_metrics}.items()}
        metrics["grad_norm"] = global_norm(grads)
        acc = state.acc_grads
        mini = state.step % accum
        if accum > 1:
            acc = [g if mini == 0 else a + (g - a) / (mini + 1) for a, g in zip(acc or grads, grads)]
            grads = acc
        if mini == accum - 1:
            if clip:
                grads = clip_by_global_norm(grads, clip)
            for p, g in zip(leaves, grads):
                p.grad = g
            optimizer.step()
            scheduler.step()
            optimizer.zero_grad(set_to_none=True)
            acc = None
        return TrainState(params=state.params, model_state=new_model_state, step=state.step + 1,
                          generator=state.generator, acc_grads=acc), metrics

    return train_step


def make_eval_step(model: SpeechCLIPModel):
    """-> ``eval_step(state, batch)``: the features and losses the
    validation epoch collects (``id``, ``audio_feat`` of the branch
    ``retrieval_audio_feat_src`` names, ``image_feat``, ``metrics`` as
    ``val_*``, and the cascaded branch's ``keywords``), at eval, without a
    graph."""
    default_src = "parallel" if model.use_parallel else "cascaded"
    audio_src = model.config.retrieval_audio_feat_src or default_src
    have = {"parallel": model.use_parallel, "cascaded": model.use_cascaded}
    if not have.get(audio_src):
        raise ValueError(
            f"retrieval audio_feat_src={audio_src!r} but the model has no {audio_src} branch "
            f"(objective weights enable: {[k for k, v in have.items() if v]})")

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, Any]) -> Dict[str, Any]:
        loss_feats, log_metrics, others, _ = model.forward(state.params, state.model_state,
                                                           batch, train=False)
        losses = model.compute_loss(state.params, loss_feats)
        out = {
            "id": others["id"],
            "audio_feat": others[f"{audio_src}_audio_feat"],
            "image_feat": others["image_feat"],
            "metrics": {f"val_{k}": v for k, v in {**losses, **log_metrics}.items()},
        }
        if others.get("keywords") is not None:
            out["keywords"] = others["keywords"]
        return out

    return eval_step


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A host batch of numpy arrays -> tensors on ``device``: on the card
    through pinned host memory with a non-blocking copy, so the copy runs
    beside the work already queued; on the CPU the arrays' own memory."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def staged(items: Iterable, size: int = 2) -> Iterator:
    """``items`` with a bounded lookahead: the producer runs ``size``
    elements ahead of the consumer, so work an element starts when it is
    made (a non-blocking copy) overlaps the consumer's."""
    buf: deque = deque()
    for item in items:
        buf.append(item)
        if len(buf) >= size:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


def device_prefetch(batches: Iterable[Dict[str, np.ndarray]], device,
                    size: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """Stage the next batches on ``device`` while the current one runs
    (``size`` = 2: double buffering). One card: no mesh, no sharding."""
    return staged((to_device(b, device) for b in batches), size)
