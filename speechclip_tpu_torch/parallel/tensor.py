"""The model axis: tensor parallelism of the transformer layers (port of
``param_partition_specs`` / ``param_shardings`` of
speechclip_tpu/parallel/mesh.py, and of what XLA's partitioner does with
them).

JAX shards the big matrices over the mesh's ``model`` axis and lets GSPMD
partition the unfused layers. The port computes the same function
Megatron-style, one process a rank:

- column-parallel (``fc1``, ``c_fc``, ``linear1``; the fused ``in_proj``):
  each model rank holds 1/M of the output columns (and of the bias) and
  multiplies the replicated input by them (``linear_col``); no sum crosses
  the ranks, so each column is the single-device column;
- row-parallel (``fc2``, ``c_proj``, ``linear2``): each rank holds 1/M of
  the input rows, multiplies its shard of the activation in f32, and the
  partial products are summed over the model group in f32, rounded once to
  the activation dtype, then the replicated bias is added in that dtype
  (``linear_row``): the single-device ``linear``'s rounding points, up to
  the f32 summation order;
- attention runs on the rank's H/M heads: ``in_proj`` is sharded by heads
  (rank m holds the Q, K and V columns of heads [m H/M, (m+1) H/M), its
  (D, 3D/M) shard laid out [Q_m | K_m | V_m]), and the heads are gathered
  before the replicated ``out_proj`` (``ops/attention.py``).

Which leaves shard is JAX's rule (``param_partition_specs``): the suffix
table below and the divisibility of the sharded dimension by M. JAX cuts
``in_proj``'s (D, 3D) columns contiguously; the port cuts it by heads, and
keeps it replicated where the head count does not divide by M (the
cascaded branch's single head), which is the one place the two layouts of
specs differ. ``gather_params`` inverts ``shard_params_`` into JAX's full
layout (checkpoints, tests, ``convert/from_jax.py``'s callers).

``shard_params_`` shards a tree in place (a trainable leaf keeps its
identity, so an optimizer built over the full leaves keeps them) and
records each shard's kind; the layers read the kind (``kind_of``) of the
leaves they are handed. The layers take their sharded paths inside a ``model_mesh(mesh)``
scope (JAX's ``ops.attention.kernel_mesh``), which the train and eval
steps open: there the fused kernel blocks step aside (``mha_layer_block``
needs the full-width LayerNorm and the replicated out-projection,
``ffn_block`` the sum of fc2's partials before its bias and LayerNorm),
and attention runs at the local head count on ``attention_vmem`` or
``flash_attention``. The scope is process-wide, not per thread: the
backward's recomputes (``remat``, the weighted sum's) run on autograd's
threads.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..ops.basic import Params, linear, matmul_f32
from . import collectives
from .mesh import Mesh

# (path component, spec): JAX's _TP_SHARDED_SUFFIXES, in its order
SHARDED_SUFFIXES = (
    ("fc1", "col"),
    ("fc2", "row"),
    ("c_fc", "col"),
    ("c_proj", "row"),
    ("linear1", "col"),
    ("linear2", "row"),
    ("in_proj", "col"),
)

_KINDS = WeakIdKeyDictionary()  # sharded leaf -> "col" | "row" | "heads"
_LIVE: Optional[Mesh] = None


@contextlib.contextmanager
def model_mesh(mesh: Optional[Mesh]) -> Iterator[None]:
    """Inside the block the layers run their model-axis paths on ``mesh``
    (a mesh with ``model_size`` 1, or None, opens no axis)."""
    global _LIVE
    prev = _LIVE
    _LIVE = mesh if mesh is not None and mesh.model_size > 1 else None
    try:
        yield
    finally:
        _LIVE = prev


def live_mesh() -> Optional[Mesh]:
    """The mesh of the open ``model_mesh`` scope with a model axis, or None."""
    return _LIVE


def kind_of(t: Optional[torch.Tensor]) -> Optional[str]:
    """"col", "row" or "heads" for a leaf ``shard_params_`` sharded, else None."""
    return None if t is None else _KINDS.get(t)


def mesh_of(t: torch.Tensor) -> Optional[Mesh]:
    """The live mesh where ``t`` is sharded; None where it is not; raises
    for a sharded leaf outside a ``model_mesh`` scope."""
    if kind_of(t) is None:
        return None
    if _LIVE is None:
        raise RuntimeError("a leaf sharded over the model axis is used outside a "
                           "model_mesh(mesh) scope")
    return _LIVE


# ----------------------------------------------------------------- the specs
def _names(path: Tuple) -> List[str]:
    """The dict keys of a path (list indices left out, as JAX's
    ``SequenceKey``s are)."""
    return [p for p in path if isinstance(p, str)]


def _heads_at(names: Sequence[str], heads: Optional[Mapping[str, int]]) -> Optional[int]:
    """The head count of the longest prefix of ``names`` in ``heads``."""
    for n in range(len(names), 0, -1):
        got = (heads or {}).get("/".join(names[:n]))
        if got is not None:
            return int(got)
    return None


def _spec_for(names: Sequence[str], leaf: Optional[torch.Tensor], model: int,
              heads: Optional[Mapping[str, int]]) -> Optional[str]:
    if model <= 1 or leaf is None:
        return None
    joined = "/" + "/".join(names) + "/"
    for suffix, spec in SHARDED_SUFFIXES:
        if f"/{suffix}/" not in joined:
            continue
        if names[-1] == "w" and leaf.dim() == 2:
            axis = 1 if spec == "col" else 0
            if leaf.shape[axis] % model == 0 and _heads_divide(suffix, names, model, heads):
                return spec
        if (names[-1] == "b" and spec == "col" and leaf.dim() == 1
                and leaf.shape[0] % model == 0 and _heads_divide(suffix, names, model, heads)):
            return spec
    return None


def _heads_divide(suffix: str, names: Sequence[str], model: int,
                  heads: Optional[Mapping[str, int]]) -> bool:
    """``in_proj`` shards by heads: only where its head count divides by M."""
    if suffix != "in_proj":
        return True
    h = _heads_at(names, heads)
    if h is None:
        raise ValueError(f"no head count for {'/'.join(names)}: pass heads= "
                         "(SpeechCLIPModel.attention_heads())")
    return h % model == 0


def _map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def param_partition_specs(params: Params, mesh, heads: Optional[Mapping[str, int]] = None):
    """The tree of "col" (JAX's ``P(None, "model")`` on a weight,
    ``P("model")`` on its bias), "row" (``P("model", None)``) or None
    (replicated) for ``params`` on ``mesh`` (a ``Mesh``, or the model-axis
    size). ``heads``: {path prefix: head count}
    (``SpeechCLIPModel.attention_heads()``), which decides ``in_proj``."""
    model = mesh if isinstance(mesh, int) else mesh.model_size
    return _map(lambda path, leaf: _spec_for(_names(path), leaf, model, heads), params)


# ------------------------------------------------------ sharding and gathering
def _take(t: torch.Tensor, kind: str, mesh: Mesh) -> torch.Tensor:
    """This model rank's shard of a full leaf (or of a tensor shaped like
    one: an Adam moment, an accumulated gradient)."""
    m, parts = mesh.model_rank, mesh.model_size
    if kind == "row":
        n = t.shape[0] // parts
        return t[m * n:(m + 1) * n]
    if kind == "col":
        n = t.shape[-1] // parts
        return t[..., m * n:(m + 1) * n]
    # "heads": [Q | K | V] along the last axis, each cut into M head groups
    d = t.shape[-1] // 3
    n = d // parts
    three = t.reshape(*t.shape[:-1], 3, d)[..., m * n:(m + 1) * n]
    return three.reshape(*t.shape[:-1], 3 * n)


def _full(t: torch.Tensor, kind: str, mesh: Mesh, what: str) -> torch.Tensor:
    """The full leaf from the model ranks' shards (a collective)."""
    parts = collectives._gather(t.detach().unsqueeze(0), mesh, what, "model")  # (M, ...)
    if kind == "row":
        return parts.reshape(-1, *t.shape[1:])
    if kind == "col":
        return parts.movedim(0, -2).reshape(*t.shape[:-1], -1)
    n = t.shape[-1] // 3
    three = parts.reshape(parts.shape[0], *t.shape[:-1], 3, n)  # (M, ..., 3, n)
    return three.movedim(0, -2).reshape(*t.shape[:-1], -1)  # (..., 3, M, n) -> (..., 3 M n)


def shard_params_(params: Params, mesh: Mesh, heads: Optional[Mapping[str, int]] = None
                  ) -> Params:
    """Keep this model rank's shard of every leaf ``param_partition_specs``
    shards, in place, and record the shard's kind; -> ``params``. A leaf
    that requires a gradient keeps its identity (its ``.data`` is cut: an
    optimizer over the leaves keeps them); any other leaf is replaced in
    its dict or list by a new tensor, so a tensor the tree shares with its
    caller is left whole. The leaves must be the full ones, equal on the
    model group's ranks."""
    specs = param_partition_specs(params, mesh, heads)

    def walk(node, spec, path):
        keys = node.keys() if isinstance(node, dict) else range(len(node))
        for k in keys:
            leaf, at = node[k], path + (k,)
            if isinstance(leaf, (dict, list)):
                walk(leaf, spec[k], at)
            elif spec[k] is not None:
                if kind_of(leaf) is not None:
                    raise ValueError(f"{'/'.join(map(str, at))} is sharded already")
                kind = "heads" if "in_proj" in _names(at) else spec[k]
                shard = _take(leaf.detach(), kind, mesh).clone()
                if leaf.requires_grad:
                    leaf.data = shard
                else:
                    node[k] = leaf = shard
                _KINDS[leaf] = kind

    walk(params, specs, ())
    return params


def is_sharded(params: Params) -> bool:
    """Whether any leaf of ``params`` is a model-axis shard."""
    found = []
    _map(lambda _, leaf: found.append(kind_of(leaf) is not None) if torch.is_tensor(leaf)
         else None, params)
    return any(found)


def gather_params(params: Params, mesh: Mesh) -> Params:
    """A new tree with every sharded leaf gathered into JAX's full layout
    (a collective: every rank of the model group calls it); replicated
    leaves are the tree's own."""
    def full(_, leaf):
        kind = kind_of(leaf)
        return leaf if kind is None else _full(leaf, kind, mesh, "params")

    return _map(full, params)


def take_like(tensors: Sequence[Optional[torch.Tensor]], leaves: Sequence[torch.Tensor],
              mesh: Mesh) -> List[Optional[torch.Tensor]]:
    """Each full tensor shaped like its leaf cut as the leaf is."""
    return [t if t is None or kind_of(p) is None else _take(t, kind_of(p), mesh).contiguous()
            for t, p in zip(tensors, leaves)]


def full_like(tensors: Sequence[Optional[torch.Tensor]], leaves: Sequence[torch.Tensor],
              mesh: Mesh, what: str) -> List[Optional[torch.Tensor]]:
    """Each shard shaped like its leaf gathered as the leaf would be."""
    return [t if t is None or kind_of(p) is None else _full(t, kind_of(p), mesh, what)
            for t, p in zip(tensors, leaves)]


def _moments(optimizer: torch.optim.Optimizer):
    """(index, leaf, state key) of every per-element optimizer state of a
    sharded leaf (Adam's moments: the state's tensors of the leaf's rank)."""
    for i, p in enumerate(optimizer.param_groups[0]["params"]):
        if kind_of(p) is None:
            continue
        for key, v in optimizer.state.get(p, {}).items():
            if torch.is_tensor(v) and v.dim() == p.dim() and v.dim() > 0:
                yield i, p, key


def shard_optimizer_state_(optimizer: torch.optim.Optimizer, mesh: Mesh) -> None:
    """Cut the full moments of the sharded leaves (a restored optimizer)
    to the leaves' shards, in place."""
    for _, p, key in list(_moments(optimizer)):
        v = optimizer.state[p][key]
        if v.shape != p.shape:
            optimizer.state[p][key] = _take(v, kind_of(p), mesh).contiguous()


def gathered_optimizer_state(optimizer: torch.optim.Optimizer, mesh: Mesh) -> Dict:
    """The optimizer's ``state_dict()`` with the sharded leaves' moments in
    the full layout (a collective)."""
    sd = optimizer.state_dict()
    for i, p, key in list(_moments(optimizer)):
        sd["state"][i] = dict(sd["state"][i], **{key: _full(optimizer.state[p][key],
                                                            kind_of(p), mesh, "optimizer")})
    return sd


# ------------------------------------------------------------------ the layers
@functools.lru_cache(maxsize=None)
def _mm_takes_out_dtype(device: torch.device) -> bool:
    """Whether this torch's ``torch.mm`` takes ``out_dtype`` (a bf16
    product accumulated and returned in f32 by the library) on ``device``."""
    a = torch.zeros((16, 16), dtype=torch.bfloat16, device=device)
    try:
        torch.mm(a, a, out_dtype=torch.float32)
    except (TypeError, RuntimeError):
        return False
    return True


def partial_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` accumulated and returned in f32 (w cast to x's dtype, as
    ``linear`` casts it). On the card a bf16 product without a graph takes
    ``torch.mm(..., out_dtype=torch.float32)`` where this torch has it;
    otherwise, and on the CPU, ``matmul_f32``."""
    w = w.to(x.dtype)
    if (x.is_cuda and x.dtype == torch.bfloat16 and not torch.is_grad_enabled()
            and _mm_takes_out_dtype(x.device)):
        return torch.mm(x.reshape(-1, x.shape[-1]), w,
                        out_dtype=torch.float32).reshape(*x.shape[:-1], w.shape[1])
    return matmul_f32(x, w)


def linear_col(params: Params, x: torch.Tensor, what: str = "activations") -> torch.Tensor:
    """A column-parallel layer: the output columns of this rank's shard
    (``linear`` where the weight is not sharded)."""
    mesh = mesh_of(params["w"])
    if mesh is None:
        return linear(params, x)
    return linear(params, collectives.copy_to_model(x, mesh, what))


def linear_row(params: Params, x: torch.Tensor, what: str = "activations",
               scatter: bool = False) -> torch.Tensor:
    """A row-parallel layer on this rank's shard of the input's last axis
    (``scatter``: on the replicated input, cut here): the f32 partial
    products summed over the model group, one rounding to ``x.dtype``, then
    the replicated bias (``linear`` where the weight is not sharded)."""
    mesh = mesh_of(params["w"])
    if mesh is None:
        return linear(params, x)
    if scatter:
        x = collectives.scatter_to_model(x, mesh, what)
    y = collectives.reduce_from_model(partial_f32(x, params["w"]), mesh, what).to(x.dtype)
    if params.get("b") is not None:
        y = y + params["b"].to(x.dtype)
    return y


def split_of(params: Params) -> Optional[Tuple[int, int, int]]:
    """The dropout split of a column-parallel layer's output: (axis, this
    rank's part, parts) where its weight is sharded, else None (see
    ``ops.basic.rand_rows``)."""
    mesh = mesh_of(params["w"])
    return None if mesh is None else (-1, mesh.model_rank, mesh.model_size)
