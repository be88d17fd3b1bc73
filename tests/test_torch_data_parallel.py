"""The port's data-parallel train step (gloo ranks on the CPU) against the
JAX package's sharded step on a virtual CPU mesh of the same size, and
against the port's own world-1 step on the same global batch.

One module-scoped world (``tests/test_torch_dp_worker.py``'s ranks,
spawned once) runs every check while this process runs JAX's side: the
tiny flagship (both branches, precision 32, dropout 0) from ONE JAX
``create_train_state`` carried over by ``convert/from_jax.py``, on
``tests/test_torch_train_step.py``'s seeded batches of 8. JAX's step runs
as ``tests/test_train_step.py`` runs it (``place_state`` and
``shard_batch`` on ``make_mesh(data=N)``); the sharded loss against JAX's
``shard_map`` form (``tests/test_ops.py``).

Against JAX: ``tests/test_torch_train_step.py``'s tolerances (the loss
1e-5 abs + 1e-4 relative, each gradient 1e-5 abs + 1e-4 of its leaf's
largest, the params 1e-5 abs but for the elements whose gradient the two
packages do not resolve, the kw-BN statistics 1e-6 abs); the sharded loss
1e-5 relative (``tests/test_ops.py``). Against the port's world 1, which
differs only in the order of the sums (the gathered features, the
per-rank kw-BN and VQ sums, the gradients' all-reduce): the losses 1e-6
relative, each gradient 1e-5 of its leaf's largest + 1e-6 of the largest
of all, ``grad_norm`` 1e-5 relative, the params 1e-6 abs but for the
unresolved elements, the kw-BN statistics and the VQ's diagnostics 1e-6
relative; at dropout 0.1 the same limits (the ranks draw the global
batch's masks). The ranks' params after a step are bitwise equal. A gather
whose backward takes each rank's own rows without the sum over the ranks
fails the world-1 gradient check.
"""

import concurrent.futures

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from speechclip_tpu.models.speechclip import SpeechCLIPModel as JaxModel
from speechclip_tpu.ops.kw_bn import kw_bn_apply as jax_kw_bn_apply
from speechclip_tpu.ops.losses import masked_contrastive_loss_sharded as jax_sharded_loss
from speechclip_tpu.ops.vq import vq_apply as jax_vq_apply
from speechclip_tpu.parallel import make_mesh as jax_make_mesh
from speechclip_tpu.training import build_optimizer as jax_build_optimizer
from speechclip_tpu.training import create_train_state as jax_create_train_state
from speechclip_tpu.training import make_train_step as jax_make_train_step
from speechclip_tpu.training import place_state as jax_place_state
from speechclip_tpu.training import shard_batch as jax_shard_batch
from speechclip_tpu_torch.convert.from_jax import (
    speechclip_params_from_jax,
    speechclip_state_from_jax,
)
from tests.test_torch_config import port_config_from_jax
from tests.test_torch_dp_worker import CHECKS, run_ranks, world1_mesh
from tests.test_torch_train_step import (
    ATOL,
    MAX_UNRESOLVED_SHARE,
    RTOL,
    _jax_grad_fn,
    _np,
    assert_grads_match,
    flat,
    jax_config,
    make_batch,
    port_tree,
    unresolved,
)

torch.set_num_threads(2)

WORLD_RTOL = 1e-6  # the port's world N against its world 1: the losses, statistics
GRAD_LEAF, GRAD_TOP = 1e-4, 1e-6  # of a leaf's largest gradient, of the largest of all
BN_CASES = [  # (name, batchnorm_type, parallel, replica_groups), B = 8 rows, K = 4, D = 6
    ("eachKw_parallel_g0", "eachKw", True, 0),
    ("eachKw_parallel_g2", "eachKw", True, 2),
    ("eachKw_parallel_g4", "eachKw", True, 4),
    ("eachKw_g2", "eachKw", False, 2),
    ("same_g4", "same", False, 4),
    ("same_masked_g2", "same", False, 2),  # with seq_lens: the valid rows counted globally
]
VQ_TEMP, VQ_GT = "fixed=0.1", 20.0


@pytest.fixture(scope="module")
def world_size():
    return 2


def _kw_bn_cases(rng):
    cases = []
    b, k, d = 8, 4, 6
    for name, kind, parallel, groups in BN_CASES:
        shape = (d * k,) if parallel else ((k, d) if kind == "eachKw" else (d,))
        cases.append({
            "name": name, "type": kind, "parallel": parallel, "groups": groups,
            "x": rng.standard_normal((b, k, d)).astype(np.float32) * 2 + 0.5,
            "cotangent": rng.standard_normal((b, k, d)).astype(np.float32),
            "params": {"scale": rng.uniform(0.5, 1.5, shape).astype(np.float32),
                       "bias": rng.standard_normal(shape).astype(np.float32)},
            "state": {"mean": rng.standard_normal(shape).astype(np.float32),
                      "var": rng.uniform(0.5, 2.0, shape).astype(np.float32)},
            "seq_lens": (np.array([4, 1, 3, 2, 4, 2, 0, 3], np.int32) if "masked" in name
                         else None),
        })
    return cases


def _spec(world):
    rng = np.random.default_rng(42)
    feats = rng.standard_normal((2, 8, 16)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    return {
        "world": world,
        "checks": ["step", "accum", "dropout", "planted", "inventory", "kw_bn", "vq",
                   "contrastive"],
        "kw_bn": _kw_bn_cases(rng),
        "vq": {"x": rng.standard_normal((8, 4, 64)).astype(np.float32) * 3, "temp": VQ_TEMP,
               "gt": VQ_GT},
        "contrastive": {"a": feats[0], "b": feats[1], "ids": np.repeat(np.arange(4), 2),
                        "log_inv_temp": float(np.log(1 / 0.07))},
        "batch": make_batch(0), "batch1": make_batch(1),
    }


def _jax_side(spec, cfg, jm, tx, jstate, mesh):
    """JAX's sharded step and ops on ``mesh`` (data = N)."""
    data = NamedSharding(mesh, P("data"))
    jb = lambda batch: jax_shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
    placed = jax_place_state(jstate, mesh)
    (_, losses), grads = _jax_grad_fn(jm)(placed.params, placed.model_state, jb(spec["batch"]))
    new, metrics = jax.jit(jax_make_train_step(jm, tx))(placed, jb(spec["batch"]))
    out = {"losses": losses, "grads": grads, "new": new, "metrics": metrics}

    cfg2 = jax_config(accum=2)
    jm2 = JaxModel(cfg2)
    tx2, _ = jax_build_optimizer(cfg2, jm2.trainable_mask(jstate.params))
    state = jax_place_state(jstate.__class__(
        params=jstate.params, model_state=jstate.model_state,
        opt_state=tx2.init(jstate.params), step=jstate.step, rng=jstate.rng), mesh)
    step = jax.jit(jax_make_train_step(jm2, tx2, accumulate_grad_batches=2))
    accum = {"loss": [], "grads": []}
    for batch in (spec["batch"], spec["batch1"], spec["batch"], spec["batch1"]):
        # the forward is the same model's: jm's compiled gradient serves
        accum["grads"].append(_jax_grad_fn(jm)(state.params, state.model_state, jb(batch))[1])
        state, m = step(state, jb(batch))
        accum["loss"].append(float(m["train_loss"]))
        if len(accum["loss"]) == 2:
            accum["state2"] = state.model_state
    accum["params"] = state.params
    out["accum"] = accum

    out["kw_bn"] = {}
    for case in spec["kw_bn"]:
        st = {k: jnp.asarray(v) for k, v in case["state"].items()}

        def bn(x, params, case=case, st=st):
            lens = None if case["seq_lens"] is None else jnp.asarray(case["seq_lens"])
            return jax_kw_bn_apply(params, st, x, batchnorm_type=case["type"],
                                   parallel=case["parallel"], train=True,
                                   replica_groups=case["groups"], seq_lens=lens)

        x = jax.device_put(jnp.asarray(case["x"]), data)
        params = {k: jnp.asarray(v) for k, v in case["params"].items()}
        (y, new_st), vjp = jax.vjp(jax.jit(bn), x, params)
        gx, gp = vjp((jnp.asarray(case["cotangent"]), jax.tree.map(jnp.zeros_like, new_st)))
        out["kw_bn"][case["name"]] = {"y": y, "state": new_st, "gx": gx, "g_scale": gp["scale"],
                                      "g_bias": gp["bias"]}

    vq = spec["vq"]

    def diversity(x):
        res = jax_vq_apply({}, x, temp_spec=vq["temp"], train=True,
                           ground_truth_perplexity=vq["gt"])
        return res["diversity_loss"], res

    x = jax.device_put(jnp.asarray(vq["x"]), data)
    (_, res), gx = jax.jit(jax.value_and_grad(diversity, has_aux=True))(x)
    out["vq"] = {**{k: res[k] for k in ("code_perplexity", "prob_perplexity", "ent_per_t",
                                        "diversity_loss")}, "grad": gx}

    c = spec["contrastive"]
    fn = shard_map(
        lambda p, fa, fb, i: jax_sharded_loss(p, fa, fb, i, axis_name="data",
                                              temperature_trainable=True),
        mesh=mesh, in_specs=(P(), P("data"), P("data"), P("data")), out_specs=P(),
        check_vma=False)
    params = {"log_inv_temp": jnp.asarray(c["log_inv_temp"], jnp.float32)}
    loss, (gp, ga, gb) = jax.jit(jax.value_and_grad(
        lambda p, a, b: fn(p, a, b, jnp.asarray(c["ids"])), argnums=(0, 1, 2)))(
        params, jnp.asarray(c["a"]), jnp.asarray(c["b"]))
    out["contrastive"] = {"loss": float(loss), "ga": ga, "gb": gb,
                          "g_temp": float(gp["log_inv_temp"])}
    return out


@pytest.fixture(scope="module")
def dp(world_size, tmp_path_factory):
    cfg = jax_config()
    jm = JaxModel(cfg)
    tx, _ = jax_build_optimizer(cfg, jm.trainable_mask(jax.eval_shape(jm.init,
                                                                        jax.random.key(0))[0]))
    jstate = jax.jit(lambda key: jax_create_train_state(jm, tx, key))(jax.random.key(0))
    spec = _spec(world_size)
    spec.update(config=port_config_from_jax(cfg),
                config_accum=port_config_from_jax(jax_config(accum=2)),
                config_dropout=port_config_from_jax(jax_config(dropout=0.1)),
                params=speechclip_params_from_jax(_np(jstate.params)),
                state=speechclip_state_from_jax(_np(jstate.model_state)))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, spec, tmp_path_factory.mktemp("world"))
        want = _jax_side(spec, cfg, jm, tx, jstate, jax_make_mesh(data=world_size))
        one = {name: CHECKS[name](spec, world1_mesh())
               for name in ("step", "accum", "dropout", "kw_bn", "vq", "contrastive")}
        got = ranks.result()
    return {"spec": spec, "jax": want, "one": one, "ranks": got, "world": world_size}


def assert_world_grads(got, want, err_msg=""):
    """Each leaf within GRAD_LEAF of its largest + GRAD_TOP of the largest
    of all, against the port's world 1."""
    top = max(np.abs(w).max() for w in want.values())
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0,
                                   atol=GRAD_LEAF * np.abs(w).max() + GRAD_TOP * top,
                                   err_msg=f"{err_msg} {path}")


def assert_params(got, want, skip, atol):
    """The trainable leaves within ``atol`` but the ``skip`` elements
    (counted: under MAX_UNRESOLVED_SHARE of the elements)."""
    total = n_skip = 0
    for path, s in skip.items():
        live = ~s
        total += s.size
        n_skip += int(s.sum())
        np.testing.assert_allclose(got[path][live], want[path][live], atol=atol, rtol=0,
                                   err_msg=path)
    assert n_skip <= MAX_UNRESOLVED_SHARE * total, (n_skip, total)


def world_unresolved(got, want):
    """The elements whose gradient the two worlds leave to rounding."""
    return {p: (np.abs(w) < 1e-7) | (np.abs(got[p] - w) > 1e-3 * np.abs(w))
            for p, w in want.items()}


def test_loss_and_gradients_match_jax_and_world_1(dp):
    jlosses, jgrads = dp["jax"]["losses"], dp["jax"]["grads"]
    want1 = dp["one"]["step"]
    for rank in dp["ranks"]:
        got = rank["step"]
        assert set(got["losses"]) == {"loss", "c_cl_loss", "p_cl_loss"}
        for key, value in got["losses"].items():
            np.testing.assert_allclose(value, float(jlosses[key]), atol=ATOL, rtol=RTOL)
            np.testing.assert_allclose(value, want1["losses"][key], rtol=WORLD_RTOL)
        assert_grads_match(got["grads"], flat(port_tree(jgrads)))
        assert_world_grads(got["grads"], want1["grads"])
        assert len(got["grads"]) > 10


def test_one_step_matches_jax_and_world_1(dp):
    """The metrics, the params after Adam (bitwise equal on every rank), the
    kw-BN statistics, the VQ's diagnostics and the eval step's gathered
    outputs."""
    jax_out, want1 = dp["jax"], dp["one"]["step"]
    got = dp["ranks"][0]["step"]
    jmetrics = jax_out["metrics"]
    assert set(got["metrics"]) == set(jmetrics)
    for key in ("train_loss", "train_p_cl_loss", "train_c_cl_loss", "train_softmax_temp",
                "train_cl_temp"):
        np.testing.assert_allclose(got["metrics"][key], float(jmetrics[key]), atol=ATOL,
                                   rtol=RTOL, err_msg=key)
        np.testing.assert_allclose(got["metrics"][key], want1["metrics"][key], rtol=WORLD_RTOL)
    np.testing.assert_allclose(got["metrics"]["grad_norm"], float(jmetrics["grad_norm"]),
                               rtol=RTOL)
    np.testing.assert_allclose(got["metrics"]["grad_norm"], want1["metrics"]["grad_norm"],
                               rtol=1e-5)
    trainable = set(got["grads"])
    jparams = flat(port_tree(jax_out["new"].params))
    assert_params({p: got["params"][p] for p in trainable}, jparams,
                  unresolved(jax_out["grads"], got["grads"]), ATOL)
    assert_params(got["params"], want1["params"], world_unresolved(got["grads"], want1["grads"]),
                  1e-6)
    for path, v in got["params"].items():
        if path not in trainable:
            np.testing.assert_array_equal(v, want1["params"][path], err_msg=path)
    for rank in dp["ranks"][1:]:
        for path, v in got["params"].items():
            np.testing.assert_array_equal(rank["step"]["params"][path], v, err_msg=path)
    for path, want in flat(_np(jax_out["new"].model_state)).items():
        np.testing.assert_allclose(got["step_state"][path], want, atol=1e-6, err_msg=path)
        np.testing.assert_allclose(got["step_state"][path], want1["step_state"][path],
                                   rtol=WORLD_RTOL, atol=1e-7, err_msg=path)
    for key, value in want1["vq"].items():  # the diversity loss: a small difference of two
        np.testing.assert_allclose(got["vq"][key], value, rtol=WORLD_RTOL, atol=1e-6,
                                   err_msg=key)
    for key in ("id", "audio_feat", "image_feat", "keywords"):
        np.testing.assert_allclose(got["eval"][key], want1["eval"][key], atol=1e-6, err_msg=key)
    for key, value in want1["eval"]["metrics"].items():
        np.testing.assert_allclose(got["eval"]["metrics"][key], value, rtol=WORLD_RTOL)


def test_four_accumulated_steps_match_jax_and_world_1(dp):
    """``accumulate_grad_batches`` 2 over batches 0, 1, 0, 1: the losses and
    the micro-batches' ``grad_norm`` step by step, the kw-BN statistics
    after two micro-steps, the params after two updates."""
    jax_acc, want1 = dp["jax"]["accum"], dp["one"]["accum"]
    got = dp["ranks"][0]["accum"]
    np.testing.assert_allclose(got["loss"], jax_acc["loss"], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got["loss"], want1["loss"], rtol=WORLD_RTOL)
    np.testing.assert_allclose(got["grad_norm"], want1["grad_norm"], rtol=1e-5)
    for path, want in flat(_np(jax_acc["state2"])).items():
        np.testing.assert_allclose(got["model_state"][1][path], want, atol=1e-6, err_msg=path)
    # the pairs' mean gradients, which Adam takes, decide which elements resolve
    skip_jax, skip_one = None, None
    for i in (0, 2):
        jpair = jax.tree.map(lambda a, b: (a + b) / 2, *jax_acc["grads"][i:i + 2])
        pair, pair1 = ({p: (g[i][p] + g[i + 1][p]) / 2 for p in g[i]}
                       for g in (got["grads"], want1["grads"]))
        now, now1 = unresolved(jpair, pair), world_unresolved(pair, pair1)
        skip_jax = now if skip_jax is None else {k: skip_jax[k] | now[k] for k in now}
        skip_one = now1 if skip_one is None else {k: skip_one[k] | now1[k] for k in now1}
    assert_params(got["params"], flat(port_tree(jax_acc["params"])), skip_jax, ATOL)
    assert_params(got["params"], want1["params"], skip_one, 1e-6)
    for rank in dp["ranks"][1:]:
        for path, v in got["params"].items():
            np.testing.assert_array_equal(rank["accum"]["params"][path], v, err_msg=path)


@pytest.mark.parametrize("case", [c[0] for c in BN_CASES])
def test_kw_bn_statistics_match_jax(dp, case):
    """Train-mode kw-BN over the global batch (``replica_groups`` 0: one
    group; 2 and 4: per-group statistics, a group inside a rank or across
    ranks), its running statistics from group 0, and its gradients."""
    want, want1 = dp["jax"]["kw_bn"][case], dp["one"]["kw_bn"][case]
    spec = next(c for c in dp["spec"]["kw_bn"] if c["name"] == case)
    n = len(spec["x"]) // dp["world"]
    for r, rank in enumerate(dp["ranks"]):
        got = rank["kw_bn"][case]
        rows = slice(r * n, (r + 1) * n)
        np.testing.assert_allclose(got["y"], np.asarray(want["y"])[rows], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got["y"], want1["y"][rows], atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(got["gx"], np.asarray(want["gx"])[rows], atol=1e-5,
                                   rtol=1e-4)
        np.testing.assert_allclose(got["gx"], want1["gx"][rows], atol=1e-6, rtol=1e-5)
        for key in ("mean", "var"):
            np.testing.assert_allclose(got["state"][f"['{key}']"], np.asarray(want["state"][key]),
                                       atol=1e-6, err_msg=key)
            np.testing.assert_array_equal(got["state"][f"['{key}']"],
                                          dp["ranks"][0]["kw_bn"][case]["state"][f"['{key}']"])
        for key in ("g_scale", "g_bias"):
            np.testing.assert_allclose(got[key], np.asarray(want[key]), atol=1e-5, rtol=1e-4,
                                       err_msg=key)


def test_vq_diagnostics_and_the_diversity_gradient_match_jax(dp):
    want, want1 = dp["jax"]["vq"], dp["one"]["vq"]
    n = len(dp["spec"]["vq"]["x"]) // dp["world"]
    for r, rank in enumerate(dp["ranks"]):
        got = rank["vq"]
        for key in ("code_perplexity", "prob_perplexity", "ent_per_t", "diversity_loss"):
            np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=1e-5, err_msg=key)
            np.testing.assert_allclose(got[key], want1[key], rtol=WORLD_RTOL, atol=1e-6,
                                       err_msg=key)
        rows = slice(r * n, (r + 1) * n)
        scale = np.abs(np.asarray(want["grad"])).max()
        np.testing.assert_allclose(got["grad"], np.asarray(want["grad"])[rows], rtol=0,
                                   atol=1e-4 * scale)
        np.testing.assert_allclose(got["grad"], want1["grad"][rows], rtol=0, atol=1e-5 * scale)


def test_sharded_contrastive_loss_matches_jax_shard_map(dp):
    """The loss, the features' gradients and the trainable temperature's
    (a leaf every rank uses after the gather)."""
    want, want1 = dp["jax"]["contrastive"], dp["one"]["contrastive"]
    n = len(dp["spec"]["contrastive"]["a"]) // dp["world"]
    for r, rank in enumerate(dp["ranks"]):
        got = rank["contrastive"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["loss"], want1["loss"], rtol=WORLD_RTOL)
        np.testing.assert_allclose(got["g_temp"], want["g_temp"], rtol=1e-5)
        rows = slice(r * n, (r + 1) * n)
        for key in ("ga", "gb"):
            np.testing.assert_allclose(got[key], np.asarray(want[key])[rows], rtol=1e-4,
                                       atol=1e-6, err_msg=key)


def test_dropout_draws_the_global_batch_noise(dp):
    """At dropout 0.1 the ranks' steps equal world 1's: each rank draws the
    global batch's masks from the shared generator and keeps its rows."""
    got, want = dp["ranks"][0]["dropout"], dp["one"]["dropout"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=WORLD_RTOL)
    assert abs(got["loss"][0] - dp["one"]["step"]["losses"]["loss"]) > 1e-4  # masks did draw
    for g, w in zip(got["grads"], want["grads"]):
        assert_world_grads(g, w)
    skip = [world_unresolved(g, w) for g, w in zip(got["grads"], want["grads"])]
    assert_params(got["params"], want["params"], {p: skip[0][p] | skip[1][p] for p in skip[0]},
                  1e-6)


def test_a_gather_without_the_rank_sum_fails(dp):
    """The planted wrong reduction: each rank's gradient rows of the gathered
    features taken as they are, not summed over the ranks (paired with the
    mean all-reduce), leaves 1 / N of the gradient upstream of the gather,
    and the world-1 check fails on those leaves."""
    got = dp["ranks"][0]["planted"]["grads"]
    want = dp["one"]["step"]["grads"]
    with pytest.raises(AssertionError):
        assert_world_grads(got, want)
    branch = "['parallel_branch']['proj']['w']"
    ratio = np.abs(got[branch]).sum() / np.abs(want[branch]).sum()
    np.testing.assert_allclose(ratio, 1 / dp["world"], rtol=1e-3)


def test_collective_inventory_matches_jax_gates(dp):
    """``tests/test_scaling_hlo.py``'s gates on one train step: the feature
    all-gather of (N, feat) rows is present, the gradient all-reduce moves
    the trainable leaves' bytes alone (no frozen leaf), and no rank-3 float
    tensor is gathered."""
    inv = dp["ranks"][0]["inventory"]
    b = len(dp["spec"]["batch"]["id"])
    gathers = [e for e in inv["entries"] if e[0] == "all-gather"]
    assert ("all-gather", "f32", (b, 16), "features", "data") in gathers
    assert ("all-gather", "s32", (b,), "ids", "data") in gathers
    assert {e[4] for e in inv["entries"]} == {"data"}
    assert not [e for e in gathers if len(e[2]) >= 3 and e[1] in ("f32", "bf16")]
    grads = [e for e in inv["entries"] if e[3] == "gradients"]
    assert len(grads) == 1 and grads[0][0] == "all-reduce"
    assert np.prod(grads[0][2]) * 4 == inv["trainable_bytes"]
    ops = {op for op, _, _ in inv["results"]}
    assert ops == {"all-gather", "all-reduce"}
    assert inv["bytes"]["all-gather"][0] == len(gathers) == 6  # two pair losses, 3 each
