"""The ranks of the tensor-parallel parity tests (tests/test_torch_tensor_parallel*.py),
importable without jax: ``run_world`` runs in each spawned process of a
gloo world of ``data * model`` ranks on the CPU, runs the checks its spec
names over its ``(data, model)`` mesh and saves what they return, per rank,
in the full layout (``parallel.tensor.gather_params``), for the test
process to hold against the port's world-1 step and JAX's step on
``make_mesh(data, model)``. The tests of this file check the shard layout
and the model-axis draws in one process."""

import os

import numpy as np
import pytest
import torch

from speechclip_tpu_torch.models.speechclip import SpeechCLIPModel
from speechclip_tpu_torch.ops.basic import linear, matmul_f32, rand_rows
from speechclip_tpu_torch.parallel import collectives
from speechclip_tpu_torch.parallel import tensor as tp
from speechclip_tpu_torch.parallel.inventory import recording
from speechclip_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch
from speechclip_tpu_torch.training import optim, train_step
from speechclip_tpu_torch.training.optim import build_optimizer, trainable_leaves
from speechclip_tpu_torch.training.train_step import (
    create_train_state,
    make_eval_step,
    make_train_step,
    place_state,
)
from tests.test_torch_dp_worker import flat, torch_batch, trainable_paths
from tests.test_torch_dp_worker import run_ranks as _run_ranks


def tp_setup(spec, mesh, config_key="config", rng_seed=0):
    pm = SpeechCLIPModel(spec[config_key], device="cpu")
    state = create_train_state(pm, params=spec["params"], model_state=spec["state"],
                               rng_seed=rng_seed, mesh=mesh)
    optimizer, scheduler = build_optimizer(pm.config, state.params,
                                           pm.trainable_mask(state.params))
    return pm, place_state(state, mesh, pm, optimizer), optimizer, scheduler


def _leaves(pm, state):
    return trainable_leaves(state.params, pm.trainable_mask(state.params))


def tp_grads(pm, state, batch, mesh):
    """The train-mode loss of this rank's rows, the trainable gradients
    reduced as the train step reduces them and gathered into the full
    layout, and the VQ's diagnostics."""
    with tp.model_mesh(mesh):
        feats, _, others, new_state = pm.forward(state.params, state.model_state, batch,
                                                 generator=state.generator, train=True,
                                                 num_updates=torch.tensor(0), mesh=mesh)
        losses = pm.compute_loss(state.params, feats, mesh=mesh)
        leaves = _leaves(pm, state)
        grads = torch.autograd.grad(losses["loss"], leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    grads = collectives.all_reduce_mean(grads, mesh)
    full = tp.full_like(grads, leaves, mesh, "test")
    vq = others["vq_results"]
    return {
        "losses": {k: float(v.detach()) for k, v in losses.items()},
        "grads": dict(zip(trainable_paths(pm, state.params), (g.numpy().copy() for g in full))),
        "vq": {k: vq[k].detach().numpy().copy()
               for k in ("code_perplexity", "prob_perplexity", "diversity_loss")},
        "model_state": flat(new_state),
    }


def _local_replicated(params):
    """{path: this rank's values} of the leaves no rank shards."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}['{k}']")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}[{i}]")
        elif torch.is_tensor(node) and tp.kind_of(node) is None:
            out[prefix] = node.detach().float().numpy().copy()

    walk(params, "")
    return out


def check_step(spec, mesh):
    """Gradients at the initial params, then one train step: its metrics,
    the params gathered, the replicated leaves as this rank holds them, the
    kw-BN statistics and the eval step's outputs."""
    pm, state, optimizer, scheduler = tp_setup(spec, mesh)
    batch = shard_batch(torch_batch(spec["batch"]), mesh)
    out = tp_grads(pm, state, batch, mesh)
    out["kinds"] = {p: tp.kind_of(t) for p, t in _paths(state.params).items()}
    pm, state, optimizer, scheduler = tp_setup(spec, mesh)
    with recording(mesh) as inv:
        state, metrics = make_train_step(pm, optimizer, scheduler, mesh=mesh)(state, batch)
    out["inventory"] = inv.entries
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    out["params"] = flat(tp.gather_params(state.params, mesh))
    out["replicated"] = _local_replicated(state.params)
    out["step_state"] = flat(state.model_state)
    out["eval"] = {k: (v.float().numpy().copy() if torch.is_tensor(v) else
                       {m: float(x) for m, x in v.items()})
                   for k, v in make_eval_step(pm, mesh)(state, batch).items()}
    return out


def _paths(params):
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}['{k}']")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}[{i}]")
        elif torch.is_tensor(node):
            out[prefix] = node

    walk(params, "")
    return out


def check_dropout(spec, mesh):
    """Two train steps at dropout 0.1 from one generator seed, and each
    step's gradient under the masks the step draws."""
    pm, state, optimizer, scheduler = tp_setup(spec, mesh, "config_dropout", rng_seed=11)
    step = make_train_step(pm, optimizer, scheduler, mesh=mesh)
    out = {"loss": [], "grads": [], "grad_norm": []}
    for batch in (spec["batch"], spec["batch1"]):
        batch = shard_batch(torch_batch(batch), mesh)
        drawn = state.generator.get_state()  # the step draws the same masks again
        out["grads"].append(tp_grads(pm, state, batch, mesh)["grads"])
        state.generator.set_state(drawn)
        state, metrics = step(state, batch)
        out["loss"].append(float(metrics["train_loss"]))
        out["grad_norm"].append(float(metrics["grad_norm"]))
    out["params"] = flat(tp.gather_params(state.params, mesh))
    return out


def check_planted_norm(spec, mesh):
    """One step with ``grad_norm`` and the clip summing each rank's shards
    alone (no model-group reduction)."""
    real = optim.global_norm

    def local_norm(tensors, mesh=None, sharded=None):
        return real(tensors)

    optim.global_norm = train_step.global_norm = local_norm
    try:
        pm, state, optimizer, scheduler = tp_setup(spec, mesh, "config_clip")
        batch = shard_batch(torch_batch(spec["batch"]), mesh)
        state, metrics = make_train_step(pm, optimizer, scheduler, mesh=mesh)(state, batch)
        return {"grad_norm": float(metrics["grad_norm"]),
                "params": flat(tp.gather_params(state.params, mesh))}
    finally:
        optim.global_norm = train_step.global_norm = real


def check_clip(spec, mesh):
    """One step under a clip the gradient's norm exceeds."""
    pm, state, optimizer, scheduler = tp_setup(spec, mesh, "config_clip")
    batch = shard_batch(torch_batch(spec["batch"]), mesh)
    state, metrics = make_train_step(pm, optimizer, scheduler, mesh=mesh)(state, batch)
    return {"grad_norm": float(metrics["grad_norm"]),
            "params": flat(tp.gather_params(state.params, mesh))}


def check_planted_world(spec, mesh):
    """The loss with the batch's collectives run over the whole world, not
    the data group: a model group's ranks hold the same rows, so the
    gather repeats each row ``model`` times."""
    group, size = collectives._group, collectives._size
    collectives._group = lambda m, axis: group(m, "world" if axis == "data" else axis)
    collectives._size = lambda m, axis: size(m, "world" if axis == "data" else axis)
    try:
        pm, state, _, _ = tp_setup(spec, mesh)
        batch = shard_batch(torch_batch(spec["batch"]), mesh)
        with torch.no_grad(), tp.model_mesh(mesh):
            feats, _, _, _ = pm.forward(state.params, state.model_state, batch,
                                        generator=state.generator, train=True,
                                        num_updates=torch.tensor(0), mesh=mesh)
            losses = pm.compute_loss(state.params, feats, mesh=mesh)
        return {"losses": {k: float(v) for k, v in losses.items()}}
    finally:
        collectives._group, collectives._size = group, size


def _bf16_partials(x, w):
    """The planted row-parallel partial: rounded to the activation dtype
    before the sum."""
    return matmul_f32(x, w.to(x.dtype)).to(x.dtype).float()


def check_row_layer(spec, mesh):
    """A row-parallel layer (``fc2``) on this rank's shard of a seeded
    input, in f32 and bf16, as written and with its partials planted in
    the activation dtype."""
    case = spec["row_layer"]
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(case["x"]).to(dtype)
        params = {"fc2": {"w": torch.from_numpy(case["w"]).clone(),
                          "b": torch.from_numpy(case["b"])}}
        tp.shard_params_(params, mesh)
        x_shard = x[..., mesh.model_rank * x.shape[-1] // mesh.model_size:][
            ..., :x.shape[-1] // mesh.model_size]
        name = str(dtype).split(".")[-1]
        with tp.model_mesh(mesh):
            out[name] = tp.linear_row(params["fc2"], x_shard).float().numpy()
            real = tp.partial_f32
            tp.partial_f32 = _bf16_partials
            try:
                out[f"{name}_planted"] = tp.linear_row(params["fc2"], x_shard).float().numpy()
            finally:
                tp.partial_f32 = real
    return out


def check_inventory(spec, mesh):
    """The collectives of one train step, by axis."""
    pm, state, optimizer, scheduler = tp_setup(spec, mesh)
    batch = shard_batch(torch_batch(spec["batch"]), mesh)
    with recording(mesh) as inv:
        make_train_step(pm, optimizer, scheduler, mesh=mesh)(state, batch)
    return {"entries": inv.entries, "by_axis": inv.by_axis()}


def check_rn_pool(spec, mesh):
    """The frozen RN50 tower's features (its attention pool's ``c_proj``
    row-parallel over the pooled row's slices) on seeded images."""
    pm = SpeechCLIPModel(spec["config_rn"], device="cpu")
    params, model_state = pm.init(0)
    state = place_state(create_train_state(pm, params=params, model_state=model_state,
                                           mesh=mesh), mesh, pm)
    kinds = {p: tp.kind_of(t) for p, t in _paths(state.params["clip"]["visual"]).items()}
    with tp.model_mesh(mesh):
        feat = pm.encode_image_tower(state.params, torch.from_numpy(spec["rn_images"]))
    return {"feat": feat.float().numpy(), "kinds": {p: k for p, k in kinds.items() if k}}


CHECKS = {"rn_pool": check_rn_pool, "step": check_step, "dropout": check_dropout, "planted_norm": check_planted_norm,
          "clip": check_clip, "planted_world": check_planted_world,
          "row_layer": check_row_layer, "inventory": check_inventory}


def world_mesh(spec) -> Mesh:
    return make_mesh(devices=["cpu"] * spec["world"], model=spec["model"])


def run_world(rank: int, spec_path: str, out_dir: str) -> None:
    """One rank: every check of the spec, its results saved as rank{r}.pt."""
    torch.set_num_threads(1)
    spec = torch.load(spec_path, weights_only=False)
    mesh = world_mesh(spec)
    results = {name: CHECKS[name](spec, mesh) for name in spec["checks"]}
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


def run_trainer(rank: int, spec_path: str, out_dir: str) -> None:
    """One rank of a fit at ``trainer.model_parallel``: ``Trainer.fit``
    from the spec's initial params to its config's ``max_steps``, then a
    fresh ``Trainer`` over the second config resumed from the run's
    ``ckpts/last``; each final state's params gathered and its step saved
    as trainer{r}.pt."""
    from speechclip_tpu_torch.config import load_config
    from speechclip_tpu_torch.training.trainer import Trainer

    torch.set_num_threads(1)
    spec = torch.load(spec_path, weights_only=False)
    mesh = world_mesh(spec)
    out = {}
    trainer = Trainer(load_config(spec["config"]), workdir=spec["workdir"], device="cpu",
                      mesh=mesh)
    state = trainer.fit(initial_params=spec["params"], initial_model_state=spec["state"])
    out["fit"] = {"step": state.step, "params": flat(tp.gather_params(state.params, mesh))}
    trainer = Trainer(load_config(spec["resume_config"]), workdir=spec["workdir"], device="cpu",
                      mesh=mesh)
    state = trainer.fit(resume="auto")
    out["resume"] = {"step": state.step, "params": flat(tp.gather_params(state.params, mesh))}
    torch.save(out, os.path.join(out_dir, f"trainer{rank}.pt"))


def run_ranks(spec: dict, tmp_dir, fn=None, prefix="rank") -> list:
    """Spawn ``spec["world"]`` gloo ranks on the CPU running ``fn``
    (default ``run_world``) over ``spec``; -> each rank's results."""
    return _run_ranks(spec, tmp_dir, fn or run_world, prefix)


# ------------------------------------------------------------------ in process
def _mesh(rank, model, world=None):
    return Mesh(rank=rank, world_size=world or model, device=torch.device("cpu"),
                model_size=model)


@pytest.mark.parametrize("model", [2, 4])
def test_shards_gather_back_into_the_full_layout(model):
    """Each kind's shards, taken on every model rank and stacked as the
    gather stacks them, rebuild the full leaf; the heads kind holds
    [Q_m | K_m | V_m] of its heads."""
    g = torch.Generator().manual_seed(0)
    d = 8 * model
    full = {"col": torch.rand((6, 4 * d), generator=g), "row": torch.rand((4 * d, 6), generator=g),
            "heads": torch.rand((d, 3 * d), generator=g), "bias": torch.rand(3 * d, generator=g)}
    for kind, t in full.items():
        k = "heads" if kind == "bias" else kind
        parts = torch.stack([tp._take(t, k, _mesh(m, model)) for m in range(model)])
        if k == "row":
            back = parts.reshape(-1, *t.shape[1:])
        elif k == "col":
            back = parts.movedim(0, -2).reshape(*t.shape[:-1], -1)
        else:
            n = t.shape[-1] // 3 // model
            back = parts.reshape(model, *t.shape[:-1], 3, n).movedim(0, -2).reshape(t.shape)
        torch.testing.assert_close(back, t, rtol=0, atol=0)
    m = model - 1
    n = d // model
    q, k_, v = full["heads"].split(d, dim=1)
    want = torch.cat([z[:, m * n:(m + 1) * n] for z in (q, k_, v)], dim=1)
    torch.testing.assert_close(tp._take(full["heads"], "heads", _mesh(m, model)), want)


def test_the_model_axis_draws_its_part_of_the_single_device_draw():
    """A split draw keeps the full draw's columns (heads) of this model
    rank; the data axis's rows as before."""
    shape = (4, 3, 10)
    want = torch.rand(shape, generator=torch.Generator().manual_seed(3))
    for m in range(2):
        got = rand_rows((4, 3, 5), torch.Generator().manual_seed(3), "cpu", (-1, m, 2))
        torch.testing.assert_close(got, want[..., m * 5:(m + 1) * 5], rtol=0, atol=0)
        got = rand_rows((4, 1, 10), torch.Generator().manual_seed(3), "cpu", (1, m, 3))
        torch.testing.assert_close(
            got, torch.rand((4, 3, 10), generator=torch.Generator().manual_seed(3))[:, m:m + 1])
    with pytest.raises(ValueError, match="batch axis"):
        rand_rows((4, 3), torch.Generator(), "cpu", (0, 0, 2))


def test_linear_layers_are_plain_without_a_sharded_leaf():
    """Outside a model axis, or on a replicated leaf, the tensor-parallel
    layers are ``linear``; a sharded leaf outside ``model_mesh`` raises."""
    g = torch.Generator().manual_seed(1)
    p = {"w": torch.rand((6, 4), generator=g), "b": torch.rand(4, generator=g)}
    x = torch.rand((2, 6), generator=g)
    for fn in (tp.linear_col, tp.linear_row):
        torch.testing.assert_close(fn(p, x), linear(p, x), rtol=0, atol=0)
    assert tp.split_of(p) is None
    params = {"fc1": {"w": p["w"].clone(), "b": p["b"].clone()}}
    tp.shard_params_(params, _mesh(1, 2))
    assert tp.kind_of(params["fc1"]["w"]) == tp.kind_of(params["fc1"]["b"]) == "col"
    assert tp.is_sharded(params) and not tp.is_sharded({"fc1": p})
    torch.testing.assert_close(params["fc1"]["w"], p["w"][:, 2:])
    with pytest.raises(RuntimeError, match="outside a model_mesh"):
        tp.linear_col(params["fc1"], x)
    with pytest.raises(ValueError, match="sharded already"):
        tp.shard_params_(params, _mesh(1, 2))
