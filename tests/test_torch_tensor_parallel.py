"""The port's model axis (gloo ranks on the CPU, ``make_mesh(model=M)``)
against the JAX package's step on ``make_mesh(data, model)`` over virtual
CPU devices, and against the port's own world-1 step on the same global
batch; the parameter layout against JAX's ``param_partition_specs``.

One module-scoped world (``tests/test_torch_tp_worker.py``'s ranks,
spawned once; here ``(data 1, model 2)``, in
tests/test_torch_tensor_parallel_world4.py ``(data 2, model 2)``) runs
every check while this process runs JAX's side once: the tiny flagship
(both branches, precision 32) from ONE JAX ``create_train_state`` carried
over by ``convert/from_jax.py``, on ``tests/test_torch_train_step.py``'s
seeded batches of 8. Every tower and branch layer is tensor-parallel there
(HuBERT, ViT and the text tower at 4 heads, the parallel branch at 4; the
cascaded head's single head keeps its ``in_proj`` replicated).

Against JAX: ``tests/test_torch_train_step.py``'s tolerances. Against the
port's world 1, which differs only in the order of the f32 sums (the
row-parallel partials, the gradients' norm over the model group, and at
data 2 the gathered features and statistics): the losses 1e-6 relative,
each gradient 1e-5 of its leaf's largest + 1e-6 of the largest of all (the
biases kw-BN cancels have gradients of pure rounding), ``grad_norm`` 1e-5
relative, the params after a step 1e-6 abs but for the elements whose
gradient the two worlds leave to rounding; the same at dropout 0.1, whose
masks are world 1's. Where the data axis joins (data 2) or dropout draws,
each gradient is held to the data-parallel suite's 1e-4 of its leaf's
largest instead: the kw-BN scale and bias, behind the VQ's 1 / 0.1 and the
loss's 1 / 0.07, move by up to ~3.5e-4 of their largest at the new order
of the sums. The frozen leaves come back bitwise, and each rank's
replicated leaves are bitwise equal. Planted faults: a ``grad_norm``
without the model group's sum, and the batch's collectives over the whole
world, fail those limits; partials rounded to the activation dtype before
their sum pass at f32 and show at bf16.
"""

import concurrent.futures
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from speechclip_tpu.config import ConfigNode
from speechclip_tpu.config import load_config as jax_load_config
from speechclip_tpu.models.speechclip import SpeechCLIPModel as JaxModel
from speechclip_tpu.parallel import make_mesh as jax_make_mesh
from speechclip_tpu.parallel.mesh import param_partition_specs as jax_partition_specs
from speechclip_tpu.training import build_optimizer as jax_build_optimizer
from speechclip_tpu.training import create_train_state as jax_create_train_state
from speechclip_tpu.training import make_train_step as jax_make_train_step
from speechclip_tpu.training import place_state as jax_place_state
from speechclip_tpu.training import shard_batch as jax_shard_batch
from speechclip_tpu_torch import config as port_config
from speechclip_tpu_torch.convert.from_jax import (
    speechclip_params_from_jax,
    speechclip_state_from_jax,
)
from speechclip_tpu_torch.models.speechclip import SpeechCLIPModel
from speechclip_tpu_torch.ops.basic import linear
from speechclip_tpu_torch.parallel import tensor as tp
from speechclip_tpu_torch.parallel.mesh import make_mesh
from tests.test_torch_config import port_config_from_jax
from tests.test_torch_data_parallel import assert_params, world_unresolved
from tests.test_torch_tp_worker import CHECKS, run_ranks
from tests.test_torch_train_step import (
    ATOL,
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_RTOL = 1e-6  # the losses against the port's world 1
GRAD_LEAF, GRAD_TOP = 1e-5, 1e-6  # of a leaf's largest gradient, of the largest of all
DP_GRAD_LEAF = 1e-4  # tests/test_torch_data_parallel.py's: at data 2, or dropout 0.1
NORM_RTOL = 1e-5
CLIP = 0.5  # under the gradient's norm at the initial params: the clip engages
CHECK_NAMES = ["step", "dropout", "clip", "planted_norm", "planted_world", "row_layer",
               "rn_pool"]
PORT_TINY_RN = port_config.CLIPResNetVisionConfig(image_size=64, width=8, layers=(1, 1, 1, 1),
                                                  heads=4, output_dim=16)
PINNED_REPLICATED_IN_PROJ = {  # H % M != 0: JAX shards these columns, the port keeps them whole
    "flagship": ["['cascaded_branch']['transformer']['attn']['in_proj']['b']",
                 "['cascaded_branch']['transformer']['attn']['in_proj']['w']"],
    "rn50": ["['cascaded_branch']['transformer']['attn']['in_proj']['b']",
             "['cascaded_branch']['transformer']['attn']['in_proj']['w']"],
    "large_p": [],
    "large_c": ["['cascaded_branch']['transformer']['attn']['in_proj']['b']",
                "['cascaded_branch']['transformer']['attn']['in_proj']['w']"],
}


@pytest.fixture(scope="module")
def mesh_shape():
    return 1, 2  # (data, model)


def _clip_config():
    cfg = jax_config()
    cfg.trainer.gradient_clip_val = CLIP
    return cfg


def _row_layer(rng):
    return {"x": rng.standard_normal((64, 128)).astype(np.float32),
            "w": (rng.standard_normal((128, 48)) / 8).astype(np.float32),
            "b": rng.standard_normal(48).astype(np.float32)}


def _jax_side(spec, jm, tx, jstate, mesh):
    """JAX's step on ``mesh`` as tests/test_train_step.py runs it:
    ``place_state`` (the params sharded by ``param_shardings``) and
    ``shard_batch``."""
    jb = lambda batch: jax_shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh)
    placed = jax_place_state(jstate, mesh)
    (_, losses), grads = _jax_grad_fn(jm)(placed.params, placed.model_state, jb(spec["batch"]))
    new, metrics = jax.jit(jax_make_train_step(jm, tx))(placed, jb(spec["batch"]))
    return {"losses": losses, "grads": grads, "new": new, "metrics": metrics}


@pytest.fixture(scope="module")
def tpw(mesh_shape, tmp_path_factory):
    data, model = mesh_shape
    cfg = jax_config()
    jm = JaxModel(cfg)
    tx, _ = jax_build_optimizer(cfg, jm.trainable_mask(jax.eval_shape(jm.init,
                                                                        jax.random.key(0))[0]))
    jstate = jax.jit(lambda key: jax_create_train_state(jm, tx, key))(jax.random.key(0))
    spec = {"world": data * model, "model": model, "checks": CHECK_NAMES,
            "batch": make_batch(0), "batch1": make_batch(1),
            "row_layer": _row_layer(np.random.default_rng(5)),
            "config": port_config_from_jax(cfg),
            "config_dropout": port_config_from_jax(jax_config(dropout=0.1)),
            "config_clip": port_config_from_jax(_clip_config()),
            "params": speechclip_params_from_jax(_np(jstate.params)),
            "state": speechclip_state_from_jax(_np(jstate.model_state)),
            "config_rn": dataclasses.replace(port_config_from_jax(cfg), clip_vision=PORT_TINY_RN),
            "rn_images": np.random.default_rng(6).standard_normal((4, 64, 64, 3)).astype(
                np.float32)}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, spec, tmp_path_factory.mktemp("tp_world"))
        want = _jax_side(spec, jm, tx, jstate, jax_make_mesh(data=data, model=model))
        mesh1 = make_mesh(devices=["cpu"])
        one = {name: CHECKS[name](dict(spec, world=1, model=1), mesh1)
               for name in ("step", "dropout", "clip", "rn_pool")}
        got = ranks.result()
    return {"spec": spec, "jax": want, "one": one, "ranks": got, "data": data, "model": model}


def assert_world_grads(got, want, err_msg="", leaf=GRAD_LEAF):
    """Each leaf within ``leaf`` of its largest + GRAD_TOP of the largest
    of all, against the port's world 1."""
    top = max(np.abs(w).max() for w in want.values())
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0,
                                   atol=leaf * np.abs(w).max() + GRAD_TOP * top,
                                   err_msg=f"{err_msg} {path}")


# ------------------------------------------------------------------- the specs
def _rn50_config():
    cfg = jax_config()
    cfg.clip.custom["vision"] = ConfigNode({"image_size": 64, "width": 8, "layers": [1, 1, 1, 1],
                                            "heads": 4, "output_dim": 16})
    return cfg


SPEC_CONFIGS = {
    "flagship": jax_config,
    "rn50": _rn50_config,
    "large_p": lambda: jax_load_config(os.path.join(REPO, "configs/large_flickr/spchclp_p.yaml")),
    "large_c": lambda: jax_load_config(os.path.join(REPO, "configs/large_flickr/spchclp_c.yaml")),
}


def _meta(tree):
    """JAX's abstract params as the port's tree of meta tensors (the specs
    read paths and shapes alone)."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_meta(v) for v in tree]
    return None if tree is None else torch.empty(tree.shape, device="meta")


def _port_spec_paths(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_port_spec_paths(v, f"{prefix}['{k}']"))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_port_spec_paths(v, f"{prefix}[{i}]"))
    else:
        out[prefix] = tree
    return out


JAX_SPEC_NAMES = {P(): None, P(None, "model"): "col", P("model"): "col",
                  P("model", None): "row"}


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("name", list(SPEC_CONFIGS))
def test_param_partition_specs_match_jax_leaf_by_leaf(name, model):
    """The port's specs equal JAX's on every leaf but the pinned ``in_proj``
    leaves whose head count does not divide by M (the port shards by heads
    and keeps those whole); everything else is JAX's suffix and divisibility
    rule, ``out_proj`` and the conv front end replicated."""
    cfg = SPEC_CONFIGS[name]()
    shapes = jax.eval_shape(JaxModel(cfg).init, jax.random.key(0))[0]
    want = jax_partition_specs(shapes, jax_make_mesh(model=model))
    want = {jax.tree_util.keystr(path): JAX_SPEC_NAMES[spec] for path, spec in
            jax.tree_util.tree_flatten_with_path(want, is_leaf=lambda x: isinstance(x, P))[0]}
    heads = SpeechCLIPModel(port_config_from_jax(cfg), device="cpu").attention_heads()
    got = _port_spec_paths(tp.param_partition_specs(_meta(shapes), model, heads))
    assert set(want) <= set(got)
    differ = sorted(path for path in want if got[path] != want[path])
    assert differ == PINNED_REPLICATED_IN_PROJ[name]
    for path in differ:
        assert want[path] == "col" and got[path] is None
    assert {s for s in got.values()} == {None, "col", "row"}
    assert all(got[p] is None for p in got if "out_proj" in p or "pos_conv" in p)


# ----------------------------------------------------------- the step's parity
def test_loss_and_gradients_match_jax_and_world_1(tpw):
    jlosses, jgrads = tpw["jax"]["losses"], tpw["jax"]["grads"]
    want1 = tpw["one"]["step"]
    for rank in tpw["ranks"]:
        got = rank["step"]
        assert set(got["losses"]) == {"loss", "c_cl_loss", "p_cl_loss"}
        for key, value in got["losses"].items():
            np.testing.assert_allclose(value, float(jlosses[key]), atol=ATOL, rtol=RTOL)
            np.testing.assert_allclose(value, want1["losses"][key], rtol=WORLD_RTOL)
        assert_grads_match(got["grads"], flat(port_tree(jgrads)))
        assert_world_grads(got["grads"], want1["grads"],
                           leaf=GRAD_LEAF if tpw["data"] == 1 else DP_GRAD_LEAF)


def test_the_sharded_leaves_are_the_specs(tpw):
    """Every tower's and branch's transformer matrices are shards (the
    trainable branch's ``linear1``, ``linear2`` and ``in_proj`` too); the
    cascaded head's ``in_proj`` and every ``out_proj`` stay whole."""
    kinds = tpw["ranks"][0]["step"]["kinds"]
    sharded = {p for p, k in kinds.items() if k}
    assert {k for k in kinds.values() if k} == {"col", "row", "heads"}
    for tower in ("['audio_encoder']", "['clip']['visual']", "['clip']['text']",
                  "['parallel_branch']"):
        assert any(p.startswith(tower) and "in_proj" in p for p in sharded), tower
    assert not [p for p in sharded if "cascaded_branch" in p or "out_proj" in p]
    assert kinds["['parallel_branch']['transformer']['layers'][0]['linear2']['w']"] == "row"
    assert kinds["['parallel_branch']['transformer']['layers'][0]['linear2']['b']"] is None


def test_one_step_matches_jax_and_world_1(tpw):
    """The metrics, the params after Adam gathered from the shards, the
    kw-BN statistics and the eval step's outputs; the frozen leaves come
    back bitwise, and the ranks' replicated leaves are bitwise equal."""
    jax_out, want1 = tpw["jax"], tpw["one"]["step"]
    got = tpw["ranks"][0]["step"]
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
                               rtol=NORM_RTOL)
    trainable = set(got["grads"])
    assert_params({p: got["params"][p] for p in trainable}, flat(port_tree(jax_out["new"].params)),
                  unresolved(jax_out["grads"], got["grads"]), ATOL)
    assert_params(got["params"], want1["params"], world_unresolved(got["grads"], want1["grads"]),
                  1e-6)
    assert set(got["params"]) == set(want1["params"])
    for path, v in got["params"].items():
        if path not in trainable:
            np.testing.assert_array_equal(v, want1["params"][path], err_msg=path)
    for rank in tpw["ranks"]:
        np.testing.assert_array_equal(
            np.concatenate([v.ravel() for v in rank["step"]["params"].values()]),
            np.concatenate([v.ravel() for v in got["params"].values()]))
        rep = rank["step"]["replicated"]
        assert rep.keys() == got["replicated"].keys() and len(rep) > 50
        for path, v in rep.items():
            np.testing.assert_array_equal(v, got["replicated"][path], err_msg=path)
    for path, want in flat(_np(jax_out["new"].model_state)).items():
        np.testing.assert_allclose(got["step_state"][path], want, atol=1e-6, err_msg=path)
        np.testing.assert_allclose(got["step_state"][path], want1["step_state"][path],
                                   rtol=WORLD_RTOL, atol=1e-7, err_msg=path)
    for key in ("id", "audio_feat", "image_feat", "keywords"):
        np.testing.assert_allclose(got["eval"][key], want1["eval"][key], atol=1e-6, err_msg=key)
    for key, value in want1["eval"]["metrics"].items():
        np.testing.assert_allclose(got["eval"]["metrics"][key], value, rtol=WORLD_RTOL)


def test_dropout_draws_world_1_s_masks(tpw):
    """At dropout 0.1 two steps equal world 1's: the masks on a sharded
    axis (the FFN's middle, the attention weights of the local heads) are
    the single-device draw's part of it."""
    got, want = tpw["ranks"][0]["dropout"], tpw["one"]["dropout"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=WORLD_RTOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=NORM_RTOL)
    assert abs(got["loss"][0] - tpw["one"]["step"]["losses"]["loss"]) > 1e-4  # masks did draw
    for g, w in zip(got["grads"], want["grads"]):
        assert_world_grads(g, w, leaf=DP_GRAD_LEAF)
    skip = [world_unresolved(g, w) for g, w in zip(got["grads"], want["grads"])]
    assert_params(got["params"], want["params"], {p: skip[0][p] | skip[1][p] for p in skip[0]},
                  1e-6)


def test_the_clip_sees_the_whole_tree_s_norm(tpw):
    got, want = tpw["ranks"][0]["clip"], tpw["one"]["clip"]
    assert want["grad_norm"] > 2 * CLIP
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=NORM_RTOL)
    skip = world_unresolved(tpw["ranks"][0]["step"]["grads"], tpw["one"]["step"]["grads"])
    assert_params(got["params"], want["params"], skip, 1e-6)


def test_a_grad_norm_without_the_model_group_sum_fails(tpw):
    """Each rank's norm over its own shards and the replicated leaves falls
    short of world 1's by the other shards' share (here the trainable
    branch's sharded matrices: ~6e-4 of the norm), beyond the limit. (Adam's
    first step is nearly ``lr * sign(g)``, so the params it clips do not
    show it.)"""
    got, want = tpw["ranks"][0]["planted_norm"], tpw["one"]["clip"]
    assert got["grad_norm"] < want["grad_norm"]
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=NORM_RTOL)


def test_the_batch_collectives_over_the_world_fail(tpw):
    """A model group's ranks hold the same rows: gathered over the whole
    world, each row counts ``model`` times and the loss leaves world 1's."""
    got = tpw["ranks"][0]["planted_world"]["losses"]
    want = tpw["one"]["step"]["losses"]
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=WORLD_RTOL)
    assert abs(got["loss"] - want["loss"]) > 1e-3 * abs(want["loss"])


def test_row_parallel_partials_are_summed_in_f32(tpw):
    """``fc2`` row-parallel against the single-device ``linear``: at f32
    the partials planted in the activation dtype change nothing (the check
    cannot see it there); at bf16 the partials summed in f32 round once, as
    ``linear`` does, and differ from it in a few elements by one step of
    bf16, while partials rounded before their sum differ in many."""
    case = tpw["spec"]["row_layer"]
    for rank in tpw["ranks"]:
        got = rank["row_layer"]
        x, w, b = (torch.from_numpy(case[k]) for k in ("x", "w", "b"))
        want32 = linear({"w": w, "b": b}, x).numpy()
        np.testing.assert_allclose(got["float32"], want32, atol=1e-5, rtol=1e-6)
        np.testing.assert_array_equal(got["float32_planted"], got["float32"])
        want16 = linear({"w": w, "b": b}, x.bfloat16()).float().numpy()
        ulp = np.abs(want16) * 2.0**-7
        right = np.abs(got["bfloat16"] - want16)
        planted = np.abs(got["bfloat16_planted"] - want16)
        assert (right <= ulp + 1e-6).all()
        assert (right > 0).mean() < 0.02
        assert (planted > 0).mean() > 0.1, (planted > 0).mean()


def test_the_rn50_attention_pool_is_row_parallel(tpw):
    """The RN50 tower (no transformer layer: JAX shards its attention
    pool's ``c_proj`` alone) gives world 1's features, each rank
    multiplying its slice of the pooled row."""
    want = tpw["one"]["rn_pool"]["feat"]
    for rank in tpw["ranks"]:
        got = rank["rn_pool"]
        assert got["kinds"] == {"['attnpool']['c_proj']['w']": "row"}
        np.testing.assert_allclose(got["feat"], want, rtol=1e-5, atol=1e-6)


def test_the_step_s_collectives_by_axis(tpw):
    """The model axis moves the heads (an all-gather a sharded attention)
    and the row-parallel partials (an f32 all-reduce a row-parallel layer);
    the data axis keeps JAX's gates: the features' all-gather of the global
    batch, one gradient all-reduce."""
    entries = tpw["ranks"][0]["step"]["inventory"]
    b = len(tpw["spec"]["batch"]["id"])
    n = b // tpw["data"]
    data = [e for e in entries if e[4] == "data"]
    model = [e for e in entries if e[4] == "model"]
    assert ("all-gather", "f32", (b, 16), "features", "data") in data
    assert len([e for e in data if e[3] == "gradients"]) == 1
    heads = [e for e in model if e[3] == "heads"]
    outputs = [e for e in model if e[0] == "all-reduce" and e[3].endswith("output")]
    # 2 HuBERT + 2 ViT + 2 text (the cascaded keywords) + 1 parallel-branch layer
    assert len(heads) == len(outputs) == 7
    assert all(e[0] == "all-gather" and e[2][0] == n and e[1] == "f32" for e in heads)
    assert all(e[1] == "f32" and e[2][0] == n for e in outputs)
    assert {e[0] for e in entries} == {"all-gather", "all-reduce"}
