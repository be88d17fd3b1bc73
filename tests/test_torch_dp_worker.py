"""The ranks of the data-parallel parity tests (tests/test_torch_data_parallel*.py),
importable without jax: ``run_world`` runs in each spawned process of a
gloo world on the CPU, runs the checks a spec file names over its
``DataMesh`` and saves what they return, per rank, for the test process to
hold against the port's world-1 step and JAX's sharded step. The tests of
this file check the row split and the group sums that the world relies on,
in one process."""

import os

import numpy as np
import pytest
import torch

from speechclip_tpu_torch.models.speechclip import SpeechCLIPModel
from speechclip_tpu_torch.ops.kw_bn import _Groups, kw_bn_apply
from speechclip_tpu_torch.ops.losses import masked_contrastive_loss_sharded
from speechclip_tpu_torch.ops.vq import vq_apply
from speechclip_tpu_torch.parallel import collectives
from speechclip_tpu_torch.parallel.inventory import recording
from speechclip_tpu_torch.parallel.mesh import DataMesh, make_mesh, shard_batch, spawn
from speechclip_tpu_torch.training.optim import build_optimizer, trainable_leaves
from speechclip_tpu_torch.training.train_step import (
    create_train_state,
    make_eval_step,
    make_train_step,
    place_state,
)


def flat(tree, prefix="") -> dict:
    """{path: f32 numpy array} over a tree's tensor leaves, paths in
    ``jax.tree_util.keystr``'s form (``['key'][0]``); None leaves left out."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}['{k}']"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}[{i}]"))
    elif torch.is_tensor(tree):
        out[prefix] = tree.detach().float().numpy().copy()
    elif tree is not None:
        out[prefix] = np.asarray(tree)
    return out


def torch_batch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def trainable_paths(pm, params):
    return [path for path, keep in flat(pm.trainable_mask(params)).items() if keep]


def train_setup(spec, mesh, config_key="config", rng_seed=0):
    pm = SpeechCLIPModel(spec[config_key], device="cpu")
    state = create_train_state(pm, params=spec["params"], model_state=spec["state"],
                               rng_seed=rng_seed, mesh=mesh)
    optimizer, scheduler = build_optimizer(pm.config, state.params,
                                           pm.trainable_mask(state.params))
    return pm, place_state(state, mesh), optimizer, scheduler


def grads_and_stats(pm, state, batch, mesh):
    """The train-mode loss of one (sharded) batch, its trainable gradients
    reduced as the train step reduces them, the VQ's diagnostics and the
    new kw-BN state."""
    feats, _, others, new_state = pm.forward(state.params, state.model_state, batch,
                                             generator=state.generator, train=True,
                                             num_updates=torch.tensor(0), mesh=mesh)
    losses = pm.compute_loss(state.params, feats, mesh=mesh)
    leaves = trainable_leaves(state.params, pm.trainable_mask(state.params))
    grads = torch.autograd.grad(losses["loss"], leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    grads = collectives.all_reduce_mean(grads, mesh)
    vq = others["vq_results"]
    return {
        "losses": {k: float(v.detach()) for k, v in losses.items()},
        "grads": dict(zip(trainable_paths(pm, state.params), (g.numpy().copy() for g in grads))),
        "vq": {k: vq[k].detach().numpy().copy()
               for k in ("code_perplexity", "prob_perplexity", "ent_per_t", "diversity_loss")},
        "model_state": flat(new_state),
    }


def check_step(spec, mesh):
    """Gradients and statistics at the initial params, then one train step."""
    pm, state, optimizer, scheduler = train_setup(spec, mesh)
    batch = shard_batch(torch_batch(spec["batch"]), mesh)
    out = grads_and_stats(pm, state, batch, mesh)
    pm, state, optimizer, scheduler = train_setup(spec, mesh)
    state, metrics = make_train_step(pm, optimizer, scheduler, mesh=mesh)(state, batch)
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    out["params"] = flat(state.params)
    out["step_state"] = flat(state.model_state)
    out["eval"] = {k: (v.float().numpy().copy() if torch.is_tensor(v) else
                       {m: float(x) for m, x in v.items()})
                   for k, v in make_eval_step(pm, mesh)(state, batch).items()}
    return out


def check_accum(spec, mesh):
    """Four micro-steps, ``accumulate_grad_batches`` 2, over batches 0, 1, 0,
    1, and each micro-batch's reduced gradient before its step."""
    pm, state, optimizer, scheduler = train_setup(spec, mesh, "config_accum")
    step = make_train_step(pm, optimizer, scheduler, pm.config.accumulate_grad_batches,
                           mesh=mesh)
    out = {"loss": [], "grad_norm": [], "model_state": [], "grads": []}
    for batch in (spec["batch"], spec["batch1"], spec["batch"], spec["batch1"]):
        batch = shard_batch(torch_batch(batch), mesh)
        out["grads"].append(grads_and_stats(pm, state, batch, mesh)["grads"])
        state, metrics = step(state, batch)
        out["loss"].append(float(metrics["train_loss"]))
        out["grad_norm"].append(float(metrics["grad_norm"]))
        out["model_state"].append(flat(state.model_state))
    out["params"] = flat(state.params)
    return out


def check_dropout(spec, mesh):
    """Two train steps at dropout 0.1 from one generator seed, and each
    step's reduced gradient (under the masks the step draws)."""
    pm, state, optimizer, scheduler = train_setup(spec, mesh, "config_dropout", rng_seed=11)
    step = make_train_step(pm, optimizer, scheduler, mesh=mesh)
    out = {"loss": [], "grads": []}
    for batch in (spec["batch"], spec["batch1"]):
        batch = shard_batch(torch_batch(batch), mesh)
        drawn = state.generator.get_state()  # the step draws the same masks again
        out["grads"].append(grads_and_stats(pm, state, batch, mesh)["grads"])
        state.generator.set_state(drawn)
        state, metrics = step(state, batch)
        out["loss"].append(float(metrics["train_loss"]))
    out["params"] = flat(state.params)
    return out


def _slice_backward(ctx, g):
    return g[ctx.mesh.rows(g.shape[0])], None, None


def check_planted(spec, mesh):
    """The gradients with the gather's backward planted as a plain slice
    (each rank's rows of its own gradient, not summed over the ranks)."""
    real = collectives._AllGatherRows.backward
    collectives._AllGatherRows.backward = staticmethod(_slice_backward)
    try:
        pm, state, _, _ = train_setup(spec, mesh)
        return grads_and_stats(pm, state, shard_batch(torch_batch(spec["batch"]), mesh), mesh)
    finally:
        collectives._AllGatherRows.backward = real


def check_inventory(spec, mesh):
    """The collectives of one train step: JAX's forms, and each entry's tag."""
    pm, state, optimizer, scheduler = train_setup(spec, mesh)
    step = make_train_step(pm, optimizer, scheduler, mesh=mesh)
    batch = shard_batch(torch_batch(spec["batch"]), mesh)
    with recording(mesh) as inv:
        step(state, batch)
    leaves = trainable_leaves(state.params, pm.trainable_mask(state.params))
    return {"entries": inv.entries, "bytes": inv.collective_bytes(),
            "results": inv.collective_results(),
            "trainable_bytes": sum(p.numel() * p.element_size() for p in leaves)}


def check_kw_bn(spec, mesh):
    """kw-BN in train mode on this rank's rows: the output rows, the new
    state, and the gradients of sum(out * cotangent) over the global batch
    (the input's rows; the scale's and bias's summed over the ranks)."""
    out = {}
    for case in spec["kw_bn"]:
        name, kind, parallel, groups = case["name"], case["type"], case["parallel"], case["groups"]
        rows = mesh.rows(len(case["x"]))
        x = torch.from_numpy(case["x"][rows]).requires_grad_(True)
        params = {k: torch.from_numpy(v).requires_grad_(True) for k, v in case["params"].items()}
        state = {k: torch.from_numpy(v) for k, v in case["state"].items()}
        lens = None if case["seq_lens"] is None else torch.from_numpy(case["seq_lens"][rows])
        y, new_state = kw_bn_apply(params, state, x, batchnorm_type=kind, parallel=parallel,
                                   train=True, replica_groups=groups, seq_lens=lens, mesh=mesh)
        cot = torch.from_numpy(case["cotangent"][rows])
        gx, gs, gb = torch.autograd.grad((y * cot).sum(), [x, params["scale"], params["bias"]])
        gs, gb = (collectives.all_reduce_sum(g, mesh, "test") for g in (gs, gb))
        out[name] = {"y": y.detach().numpy(), "state": flat(new_state), "gx": gx.numpy(),
                     "g_scale": gs.numpy(), "g_bias": gb.numpy()}
    return out


def check_vq(spec, mesh):
    """The VQ's diagnostics in train mode over the global batch, and the
    diversity loss's gradient with respect to this rank's scores (every
    rank's loss is the global one, so the ranks' gradients carry N times
    it: divided by N)."""
    case = spec["vq"]
    rows = mesh.rows(len(case["x"]))
    x = torch.from_numpy(case["x"][rows]).requires_grad_(True)
    res = vq_apply({}, x, temp_spec=case["temp"], train=True, mesh=mesh,
                   ground_truth_perplexity=case["gt"])
    (gx,) = torch.autograd.grad(res["diversity_loss"], [x])
    return {k: res[k].detach().numpy() for k in ("code_perplexity", "prob_perplexity",
                                                  "ent_per_t", "diversity_loss")} | {
        "grad": gx.numpy() / mesh.world_size}


def check_contrastive(spec, mesh):
    """``masked_contrastive_loss_sharded`` with a trainable temperature:
    the loss, the gradients of this rank's features (divided by N, as in
    ``check_vq``) and the temperature's, averaged over the ranks."""
    case = spec["contrastive"]
    rows = mesh.rows(len(case["a"]))
    a, b = (torch.from_numpy(case[k][rows]).requires_grad_(True) for k in ("a", "b"))
    params = {"log_inv_temp": torch.tensor(case["log_inv_temp"]).requires_grad_(True)}
    loss = masked_contrastive_loss_sharded(params, a, b, torch.from_numpy(case["ids"][rows]),
                                           mesh, temperature_trainable=True)
    ga, gb, gt = torch.autograd.grad(loss, [a, b, params["log_inv_temp"]])
    (gt,) = collectives.all_reduce_mean([gt], mesh)
    return {"loss": float(loss.detach()), "ga": ga.numpy() / mesh.world_size,
            "gb": gb.numpy() / mesh.world_size, "g_temp": float(gt)}


CHECKS = {"step": check_step, "accum": check_accum, "dropout": check_dropout,
          "planted": check_planted, "inventory": check_inventory, "kw_bn": check_kw_bn,
          "vq": check_vq, "contrastive": check_contrastive}


def run_trainer(rank: int, spec_path: str, out_dir: str) -> None:
    """One rank of a fit: ``Trainer.fit`` from the spec's initial params to
    its config's ``max_steps``, then a fresh ``Trainer`` over the second
    config resumed from the run's ``ckpts/last``; each final state's params
    and step saved as trainer{r}.pt."""
    from speechclip_tpu_torch.config import load_config
    from speechclip_tpu_torch.training.trainer import Trainer

    torch.set_num_threads(1)
    spec = torch.load(spec_path, weights_only=False)
    mesh = make_mesh(devices=["cpu"] * spec["world"])
    out = {}
    trainer = Trainer(load_config(spec["config"]), workdir=spec["workdir"], device="cpu",
                      mesh=mesh)
    state = trainer.fit(initial_params=spec["params"], initial_model_state=spec["state"])
    out["fit"] = {"step": state.step, "params": flat(state.params)}
    trainer = Trainer(load_config(spec["resume_config"]), workdir=spec["workdir"], device="cpu",
                      mesh=mesh)
    state = trainer.fit(resume="auto")
    out["resume"] = {"step": state.step, "params": flat(state.params)}
    torch.save(out, os.path.join(out_dir, f"trainer{rank}.pt"))


def run_world(rank: int, spec_path: str, out_dir: str) -> None:
    """One rank: every check of the spec, its results saved as rank{r}.pt."""
    torch.set_num_threads(1)
    spec = torch.load(spec_path, weights_only=False)
    mesh = make_mesh(devices=["cpu"] * spec["world"])
    results = {name: CHECKS[name](spec, mesh) for name in spec["checks"]}
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


def run_ranks(spec: dict, tmp_dir, fn=run_world, prefix="rank") -> list:
    """Spawn ``spec["world"]`` gloo ranks on the CPU running ``fn`` over
    ``spec``; -> each rank's results."""
    spec_path = os.path.join(tmp_dir, "spec.pt")
    torch.save(spec, spec_path)
    spawn(fn, spec["world"], "gloo", args=(spec_path, str(tmp_dir)))
    return [torch.load(os.path.join(tmp_dir, f"{prefix}{r}.pt"), weights_only=False)
            for r in range(spec["world"])]


def world1_mesh() -> DataMesh:
    return make_mesh(devices=["cpu"])


@pytest.mark.parametrize("start,m,total,groups,want", [
    (0, 8, 8, 1, [(0, 0, 8)]),  # world 1, no groups
    (4, 4, 8, 2, [(1, 0, 4)]),  # a group a rank
    (3, 3, 12, 2, [(0, 0, 3)]),  # a group across two ranks
    (3, 3, 12, 3, [(0, 0, 1), (1, 1, 3)]),  # a rank across two groups
    (0, 4, 8, 4, [(0, 0, 2), (1, 2, 4)]),  # two groups in a rank
])
def test_group_segments(start, m, total, groups, want):
    part = _Groups(start, m, total, groups)
    assert part.segments == want
    v = torch.arange(m * 2, dtype=torch.float32).reshape(m, 2)
    sums = part.sums(v)
    assert sums.shape == (groups, 2)
    for g, lo, hi in want:
        torch.testing.assert_close(sums[g], v[lo:hi].sum(0))
    stat = torch.arange(groups * 2, dtype=torch.float32).reshape(groups, 2) * 100
    got = part.apply(torch.add, v, stat)
    for g, lo, hi in want:
        torch.testing.assert_close(got[lo:hi], v[lo:hi] + stat[g])


def test_world_1_mesh_and_shard_batch():
    mesh = world1_mesh()
    assert (mesh.rank, mesh.world_size, mesh.distributed) == (0, 1, False)
    batch = {"x": np.arange(6)}
    assert shard_batch(batch, mesh) is batch
    two = DataMesh(rank=1, world_size=2, device=torch.device("cpu"))
    np.testing.assert_array_equal(shard_batch(batch, two)["x"], [3, 4, 5])
    with pytest.raises(ValueError, match="does not split over 4 ranks"):
        DataMesh(rank=0, world_size=4, device=torch.device("cpu")).rows(6)
    x = torch.ones(3, requires_grad=True)
    assert collectives.all_gather_rows(x, mesh) is x
    assert collectives.all_reduce_sum(x, mesh, "t") is x


def run_mesh(rank: int, spec_path: str, out_dir: str) -> None:
    """One rank of a ``(data, model)`` mesh: its coordinates, its rows, and
    each subgroup's sum of the world ranks, saved as mesh{r}.pt."""
    spec = torch.load(spec_path, weights_only=False)
    mesh = make_mesh(devices=["cpu"] * spec["world"], model=spec["model"])
    sums = {}
    for axis in ("data", "model"):
        t = torch.tensor([float(rank)])
        sums[axis] = float(collectives._all_reduce_(t, mesh, "test", axis))
    torch.save({"rank": mesh.rank, "data_rank": mesh.data_rank, "model_rank": mesh.model_rank,
                "sizes": (mesh.data_size, mesh.model_size), "rows": mesh.rows(8), "sums": sums,
                "batch": shard_batch({"x": np.arange(8)}, mesh)["x"].tolist()},
               os.path.join(out_dir, f"mesh{rank}.pt"))


def test_the_mesh_s_ranks_and_groups(tmp_path):
    """A world of 4 at ``model=2`` in JAX's grid order: world rank r is data
    rank r // 2 and model rank r % 2; the data groups {0, 2} and {1, 3}
    hold different rows, the model groups {0, 1} and {2, 3} the same ones.
    World 1 takes no model axis, and ``data`` must be the world's."""
    got = run_ranks({"world": 4, "model": 2}, tmp_path, run_mesh, "mesh")
    for r, g in enumerate(got):
        assert (g["rank"], g["data_rank"], g["model_rank"], g["sizes"]) == (r, r // 2, r % 2,
                                                                            (2, 2))
        assert g["sums"] == {"data": float(r % 2 + (r % 2 + 2)),
                             "model": float(2 * (r // 2) + 2 * (r // 2) + 1)}
        assert g["rows"] == slice(4 * (r // 2), 4 * (r // 2) + 4)
        assert g["batch"] == list(range(4 * (r // 2), 4 * (r // 2) + 4))
    with pytest.raises(ValueError, match="model=2 does not divide the world of 1"):
        make_mesh(devices=["cpu"], model=2)
    with pytest.raises(ValueError, match="data=2 but the world has 1 rank"):
        make_mesh(devices=["cpu"], data=2)
    with pytest.raises(ValueError, match="does not split into model groups of 2"):
        DataMesh(rank=0, world_size=3, device=torch.device("cpu"), model_size=2)
