"""The optimizer of the training step (port of
speechclip_tpu/training/optim.py): Adam with its L2 weight decay in the
gradient before the moments (``torch.optim.Adam``'s ``weight_decay``, the
reference's recipe), or AdamW, over the trainable leaves only; the LR
schedule as a ``LambdaLR`` stepped once per optimizer update; the
global-norm clip of ``trainer.gradient_clip_val`` in optax's form.

Frozen leaves (the encoder and the CLIP towers unless the config trains
them, the layers outside ``unfreeze_layers``) are not handed to the
optimizer, so they get no moments, as the JAX package's ``set_to_zero``
branch keeps none; a trainable tower's leaves are f32 masters with
moments like the branches'. Gradient accumulation (optax ``MultiSteps``: the mean of
k micro-batch gradients, then one clip, one Adam step and one schedule
step) is done by ``train_step.make_train_step``.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import torch

from ..config import SpeechCLIPConfig
from ..ops.basic import Params
from ..ops.schedules import get_schedule


def tree_leaves(tree) -> Iterator:
    """The leaves of a tree of dicts and lists, in insertion order, None
    leaves left out."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    elif tree is not None:
        yield tree


def trainable_leaves(params: Params, trainable_mask: Params) -> List[torch.Tensor]:
    """The leaves of ``params`` whose mask entry is True, in tree order."""
    flags = list(tree_leaves(trainable_mask))
    leaves = list(tree_leaves(params))
    if len(flags) != len(leaves):
        raise ValueError(f"mask has {len(flags)} leaves, params {len(leaves)}")
    return [p for p, keep in zip(leaves, flags) if keep]


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every element's square, in f32."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """optax's ``clip_by_global_norm``: each gradient as it is when their
    global norm is under ``max_norm``, else ``g / norm * max_norm`` (not
    torch's ``clip_grad_norm_``, whose scale is ``max / (norm + 1e-6)``)."""
    norm = global_norm(grads)
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm) for g in grads]


def build_optimizer(config: SpeechCLIPConfig, params: Params, trainable_mask: Params
                    ) -> Tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR]:
    """-> (Adam or AdamW over the trainable leaves of ``params``, a
    ``LambdaLR`` over ``config.scheduler``). The trainable leaves must be
    f32 and require grad, as ``train_step.create_train_state`` makes them
    (the master weights)."""
    opt, sched = config.optim, config.scheduler
    if opt.name not in ("Adam", "AdamW"):
        raise NotImplementedError(f"optimizer {opt.name}")
    leaves = trainable_leaves(params, trainable_mask)
    for p in leaves:
        if p.dtype != torch.float32 or not p.requires_grad:
            raise ValueError("trainable leaves must be f32 and require grad "
                             "(create_train_state makes them so)")
    cls = torch.optim.Adam if opt.name == "Adam" else torch.optim.AdamW
    optimizer = cls(leaves, lr=opt.lr, betas=tuple(opt.betas), eps=opt.eps,
                    weight_decay=opt.weight_decay)
    schedule = get_schedule(sched.name, opt.lr, warmup=sched.warmup, max_step=sched.max_step,
                            final_lr=sched.final_lr)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda step: schedule(step) / opt.lr)
    return optimizer, scheduler
