"""The training and validation steps (port of
speechclip_tpu/training/train_step.py): forward, the contrastive loss,
backward, the global-norm clip, Adam and the LR schedule, on one device or
one rank of a data-parallel world.

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
``device_prefetch`` stages host batches on the card ahead of the step that
takes them.

Data parallelism (``mesh``, a ``parallel.DataMesh`` of N ranks): the
state is the same on every rank (``place_state`` broadcasts rank 0's);
each rank takes its rows of the global batch (``shard_batch``), runs the
forward on them, gathers the features for the global batch's loss, and
computes kw-BN's and the VQ's statistics over the global batch. After the
backward one flat all-reduce averages the trainable leaves' gradients
(``parallel/collectives.py`` says why the mean is exact); the frozen leaves
take neither a gradient nor a collective. ``grad_norm``, the clip and Adam
then run on identical gradients, so the params stay bitwise equal across
the ranks, and the step equals the single-device step on the global batch
up to the order of the sums. The reduction runs after every micro-batch,
as the sharded JAX step reduces each micro-batch's gradient: so each
``grad_norm`` is the micro-batch's global one, as at world 1. The dropout
masks and the Gumbel noise are drawn over the global batch
(``ops/basic.RowShardGenerator``), so any dropout gives world 1's masks.

Tensor parallelism (a mesh with ``model_size`` M > 1: the ``model`` axis
of JAX's ``make_mesh(data, model)``): ``place_state`` broadcasts the full
tree over the world, then keeps each rank's shard of the leaves
``parallel.tensor.param_partition_specs`` shards (the frozen towers' and
the trainable branches' transformer matrices; a restored optimizer's
moments and an accumulation in progress with them). The steps run inside
``model_mesh``, where the layers are tensor-parallel. The gradient mean
runs over the data group; ``grad_norm`` and the clip sum the sharded
leaves' squares over the model group and count the replicated ones once;
Adam is elementwise, so each shard updates alone. The dropout masks on a
sharded axis are the single-device draw's part of it, so a step at any
dropout is world 1's up to the order of the sums. ``gather_state`` puts
the state back in the full layout (the checkpoints').
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..models.speechclip import SpeechCLIPModel, cast_params
from ..ops.basic import Params, RowShardGenerator
from ..parallel import collectives
from ..parallel import tensor as tp
from ..parallel.mesh import DataMesh, shard_batch
from ..utils import tracing
from .optim import clip_by_global_norm, global_norm, trainable_leaves, tree_leaves


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
                       rng_seed: Optional[int] = None,
                       mesh: Optional[DataMesh] = None) -> TrainState:
    """The model's seeded ``init`` (or the given params and state, e.g.
    carried from JAX) placed for training, and a generator seeded with
    ``rng_seed`` (default ``seed + 1``, a stream apart from the init's):
    on a ``mesh`` of N > 1 data ranks, one that draws over the global batch
    and keeps this rank's rows."""
    if params is None:
        params, model_state = model.init(seed)
    mask = model.trainable_mask(params)
    state = {k: v for k, v in (model_state or {}).items()}
    if mesh is not None and mesh.data_size > 1:
        generator = RowShardGenerator(model.device, mesh.data_rank, mesh.data_size)
    else:
        generator = torch.Generator(device=model.device)
    return TrainState(
        params=_place(params, mask, model.compute_dtype, model.device),
        model_state=_to_f32(state, model.device),
        step=0,
        generator=generator.manual_seed(seed + 1 if rng_seed is None else rng_seed),
    )


def place_state(state: TrainState, mesh: Optional[DataMesh],
                model: Optional[SpeechCLIPModel] = None,
                optimizer: Optional[torch.optim.Optimizer] = None) -> TrainState:
    """The state made the same on every rank of ``mesh``: the params (in
    place, so an optimizer over them keeps its leaves), the kw-BN
    statistics, an accumulation in progress and the generator's state
    broadcast from rank 0, after a check that every rank holds the same
    tree (leaf count, elements, step). JAX's ``place_state`` replicates the
    state over the mesh the same way. Under a model axis the params are
    then sharded (``parallel.tensor.shard_params_``, by ``model``'s
    attention heads), and with them ``optimizer``'s moments and an
    accumulation in progress (aligned with the optimizer's leaves)."""
    if mesh is None or not mesh.distributed:
        return state
    if tp.is_sharded(state.params):
        raise ValueError("the train state is placed already (its params are model-axis shards)")
    leaves = list(tree_leaves(state.params))
    collectives.agree([len(leaves), sum(t.numel() for t in leaves), state.step], mesh,
                      "the train state's params and step")
    collectives.broadcast_tree([state.params, state.model_state, state.acc_grads], mesh,
                               "train state")
    seed_state = state.generator.get_state()
    collectives.broadcast_tree(seed_state, mesh, "generator state")
    state.generator.set_state(seed_state)
    if mesh.model_size == 1:
        return state
    if model is None:
        raise ValueError("a model axis shards the params by the model's attention heads: "
                         "pass model=")
    tp.shard_params_(state.params, mesh, model.attention_heads())
    acc = state.acc_grads
    if optimizer is not None:
        tp.shard_optimizer_state_(optimizer, mesh)
        if acc is not None:
            acc = tp.take_like(acc, optimizer.param_groups[0]["params"], mesh)
    elif acc is not None:
        raise ValueError("an accumulation in progress is sharded with the optimizer's "
                         "leaves: pass optimizer=")
    return dataclasses.replace(state, acc_grads=acc)


def gather_state(state: TrainState, mesh: Optional[DataMesh],
                 optimizer: Optional[torch.optim.Optimizer] = None):
    """-> (the state with its params and accumulation in JAX's full
    layout, the optimizer's ``state_dict()`` with full moments): a
    collective over the model groups; the state and optimizer themselves
    where there is no model axis."""
    if mesh is None or mesh.model_size == 1:
        return state, optimizer
    acc = state.acc_grads
    if acc is not None:
        acc = tp.full_like(acc, optimizer.param_groups[0]["params"], mesh, "accumulation")
    opt = None if optimizer is None else tp.gathered_optimizer_state(optimizer, mesh)
    return dataclasses.replace(state, params=tp.gather_params(state.params, mesh),
                               acc_grads=acc), opt


def _to_f32(tree, device):
    if isinstance(tree, dict):
        return {k: _to_f32(v, device) for k, v in tree.items()}
    return tree.detach().to(device=device, dtype=torch.float32).clone()


def make_train_step(model: SpeechCLIPModel, optimizer: torch.optim.Optimizer,
                    scheduler: torch.optim.lr_scheduler.LRScheduler,
                    accumulate_grad_batches: int = 1, plain: bool = False,
                    mesh: Optional[DataMesh] = None):
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
    a zero gradient. ``mesh``: ``batch`` is this rank's shard of the global
    batch, the params its model-axis shards (see the module docstring)."""
    accum = max(int(accumulate_grad_batches), 1)
    leaves = optimizer.param_groups[0]["params"]
    clip = float(model.config.gradient_clip_val or 0.0)

    def train_step(state: TrainState, batch: Dict[str, Any]) -> Tuple[TrainState, Dict]:
        with tp.model_mesh(mesh):
            return step(state, batch)

    def step(state: TrainState, batch: Dict[str, Any]) -> Tuple[TrainState, Dict]:
        own = trainable_leaves(state.params, model.trainable_mask(state.params))
        if len(own) != len(leaves) or any(a is not b for a, b in zip(own, leaves)):
            raise ValueError("the optimizer does not hold this state's trainable leaves: "
                             "build it over state.params")
        # the optimizer's count for a scheduled VQ temperature, kept on the
        # host: a tensor made from it on the card waits for the card
        num_updates = torch.tensor(state.step // accum)
        with tracing.span("speechclip.step.forward", device=True):
            loss_feats, log_metrics, _, new_model_state = model.forward(
                state.params, state.model_state, batch, generator=state.generator, train=True,
                num_updates=num_updates, plain=plain, mesh=mesh)
        with tracing.span("speechclip.step.loss", device=True):
            losses = model.compute_loss(state.params, loss_feats, mesh=mesh)
        with tracing.span("speechclip.step.backward", device=True):
            grads = torch.autograd.grad(losses["loss"], leaves, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
            grads = collectives.all_reduce_mean(grads, mesh)
        with tracing.span("speechclip.step.optimizer", device=True):
            metrics = {f"train_{k}": v.detach() for k, v in {**losses, **log_metrics}.items()}
            sharded = [tp.kind_of(p) is not None for p in leaves]
            metrics["grad_norm"] = global_norm(grads, mesh, sharded)
            acc = state.acc_grads
            mini = state.step % accum
            if accum > 1:
                acc = [g if mini == 0 else a + (g - a) / (mini + 1)
                       for a, g in zip(acc or grads, grads)]
                grads = acc
            if mini == accum - 1:
                if clip:
                    grads = clip_by_global_norm(grads, clip, mesh, sharded)
                for p, g in zip(leaves, grads):
                    p.grad = g
                optimizer.step()
                scheduler.step()
                optimizer.zero_grad(set_to_none=True)
                acc = None
        return TrainState(params=state.params, model_state=new_model_state, step=state.step + 1,
                          generator=state.generator, acc_grads=acc), metrics

    return train_step


def make_eval_step(model: SpeechCLIPModel, mesh: Optional[DataMesh] = None):
    """-> ``eval_step(state, batch)``: the features and losses the
    validation epoch collects (``id``, ``audio_feat`` of the branch
    ``retrieval_audio_feat_src`` names, ``image_feat``, ``metrics`` as
    ``val_*``, and the cascaded branch's ``keywords``), at eval, without a
    graph. ``mesh``: ``batch`` is this rank's shard; the features, ids and
    keywords are gathered over the data ranks first, so every rank returns
    the global batch's outputs and losses."""
    default_src = "parallel" if model.use_parallel else "cascaded"
    audio_src = model.config.retrieval_audio_feat_src or default_src
    have = {"parallel": model.use_parallel, "cascaded": model.use_cascaded}
    if not have.get(audio_src):
        raise ValueError(
            f"retrieval audio_feat_src={audio_src!r} but the model has no {audio_src} branch "
            f"(objective weights enable: {[k for k, v in have.items() if v]})")

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, Any]) -> Dict[str, Any]:
        with tp.model_mesh(mesh):
            loss_feats, log_metrics, others, _ = model.forward(state.params, state.model_state,
                                                               batch, train=False)
        loss_feats = {k: collectives.all_gather_rows(v, mesh, k) for k, v in loss_feats.items()}
        losses = model.compute_loss(state.params, loss_feats)
        out = {
            "id": loss_feats["id"],
            "audio_feat": loss_feats[f"{audio_src}_audio_feat"],
            "image_feat": loss_feats["image_feat"],
            "metrics": {f"val_{k}": v for k, v in {**losses, **log_metrics}.items()},
        }
        if others.get("keywords") is not None:
            out["keywords"] = collectives.all_gather_rows(others["keywords"], mesh, "keywords")
        return out

    return eval_step


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A host batch of numpy arrays -> tensors on ``device``: on the card
    through pinned host memory with a non-blocking copy, so the copy runs
    beside the work already queued; on the CPU the arrays' own memory."""
    device = torch.device(device)
    out = {}
    with tracing.span("speechclip.fit.h2d"):
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            tracing.count_bytes("speechclip.h2d.bytes", v)
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
    (``size`` = 2: double buffering). ``device`` may be a ``DataMesh``:
    then each batch's rows of this rank go to the rank's device."""
    if isinstance(device, DataMesh):
        mesh = device
        return staged((to_device(shard_batch(b, mesh), mesh.device) for b in batches), size)
    return staged((to_device(b, device) for b in batches), size)
