"""Sharding rules: per-arch parameter, optimizer-state, decode-cache and
batch PartitionSpecs (port of src/repro/distributed/sharding.py).

Axis roles (launch/mesh.py):
  pod   — data parallelism across pods; serving: replica groups
  data  — data parallelism / ZeRO / FSDP / MoE group axis
  model — tensor parallelism (heads, ffn inner, vocab) and expert axis

The rules are plain functions of leaf paths, leaf shapes and a mesh's
axis sizes, the reference's own; only the framework around them
changes.  A mesh is anything with ``shape`` (axis name -> size) and
``axis_names``: the port's :class:`~repro_torch.launch.mesh.ServingMesh`
or a JAX mesh.  A tree is nested dicts, lists and tuples (NamedTuples
keep their type) whose leaves have a ``shape``: tensors, or shape
records.  :class:`PartitionSpec` is a tuple, one entry per dim: None
(replicated), an axis name, or a tuple of axis names.

The port places shards itself (``distributed/tensor_parallel.py``), so
:func:`shard_hint` constrains nothing: it returns its input, with or
without an active mesh, and the models do not call it.
"""
from __future__ import annotations

import contextlib
import re
from typing import Any, Dict, Optional, Tuple

from repro_torch.optim.adamw import AdamWState

_ACTIVE_MESH: Any = None


class PartitionSpec(tuple):
    """One entry per dim of a leaf: None, an axis name, or a tuple of
    axis names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@contextlib.contextmanager
def use_mesh(mesh: Any):
    """Activate a mesh for :func:`shard_hint` and the rules below."""
    global _ACTIVE_MESH
    prev = _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    try:
        yield mesh
    finally:
        _ACTIVE_MESH = prev


def _mesh_axes() -> Tuple[str, ...]:
    return tuple(_ACTIVE_MESH.axis_names) if _ACTIVE_MESH is not None else ()


def _filter_spec(spec: Tuple[Any, ...]) -> P:
    """Drop axes the active mesh does not have (e.g. 'pod' on a 2-D mesh)."""
    axes = _mesh_axes()
    clean = []
    for s in spec:
        if s is None:
            clean.append(None)
        elif isinstance(s, tuple):
            kept = tuple(a for a in s if a in axes)
            clean.append(kept if kept else None)
        else:
            clean.append(s if s in axes else None)
    return P(*clean)


def shard_hint(x: Any, spec: Tuple[Any, ...]) -> Any:
    """``x`` unchanged, with or without an active mesh: the port places
    its shards explicitly (``distributed/tensor_parallel.py``) instead of
    constraining a compiler's layout, so there is nothing to hint."""
    del spec
    return x


# ---------------------------------------------------------------------------
# Parameter sharding rules.  Matched by parameter *path* (joined with '/').
# First match wins; specs written for the 3-D mesh and auto-filtered for
# the 2-D (single-pod) mesh.  Spec dims align to the parameter's trailing
# dims; leading dims (the reference's stacked layer dim) stay None.
#
# MoE expert-weight placement is switchable:
#   "fsdp": experts over 'model', expert ff dim over 'data'.
#   "ep2d": experts over 'data', ff dim over 'model'.
# ---------------------------------------------------------------------------
MOE_MODES: Dict[str, Tuple[Tuple[str, Tuple], ...]] = {
    "fsdp": (
        (r"mlp/(gate|up)$", ("model", None, "data")),
        (r"mlp/down$", ("model", "data", None)),
    ),
    "ep2d": (
        (r"mlp/(gate|up)$", ("data", None, "model")),
        (r"mlp/down$", ("data", "model", None)),
    ),
}
_MOE_MODE = "fsdp"


def set_moe_mode(mode: str) -> None:
    global _MOE_MODE
    assert mode in MOE_MODES, mode
    _MOE_MODE = mode


def _rules() -> Tuple[Tuple[str, Tuple], ...]:
    return (
        # embeddings: vocab sharded over model TP
        (r"embed/table$", ("model", None)),
        # attention projections: [d, H*hd] -> shard output heads over model
        (r"attn/w[qkv]/w$", (None, "model")),
        (r"attn/wo/w$", ("model", None)),
        # dense FFN: inner dim over model
        (r"mlp/(gate|up)/w$", (None, "model")),
        (r"mlp/down/w$", ("model", None)),
        # MoE: mode-dependent (see MOE_MODES)
        (r"mlp/router$", (None, None)),
    ) + MOE_MODES[_MOE_MODE] + (
        # Mamba2: inner projections over model
        (r"mamba/in_proj/w$", (None, "model")),
        (r"mamba/out_proj/w$", ("model", None)),
        (r"mamba/conv_w$", (None, "model")),
        (r"mamba/(A_log|D|dt_bias)$", (None,)),
        # norms: replicated
        (r"(ln1|ln2|ln|final_norm)/scale$", (None,)),
    )


def _axis_size(axis) -> int:
    if _ACTIVE_MESH is None:
        return 1
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= _ACTIVE_MESH.shape.get(a, 1)
        return n
    return _ACTIVE_MESH.shape.get(axis, 1)


def _spec_for_path(path: str, shape: Tuple[int, ...]) -> P:
    for pat, spec in _rules():
        if re.search(pat, path):
            pad = len(shape) - len(spec)
            full = _filter_spec((None,) * pad + tuple(spec))
            # drop axes the dim size cannot divide (e.g. odd vocab sizes)
            clean = [s if (s is None or shape[i] % _axis_size(s) == 0) else None
                     for i, s in enumerate(tuple(full))]
            return P(*clean)
    return P()  # replicate


def _is_node(x: Any) -> bool:
    return isinstance(x, (dict, list, tuple)) and not isinstance(x, P)


def tree_map_with_path(fn, tree: Any, *rest: Any, path: str = "") -> Any:
    """``fn(path, leaf, *rest_leaves)`` over a tree's leaves; the path
    joins dict keys and sequence indices with '/', as the reference's
    ``tree_map_with_path`` paths do.  A :class:`PartitionSpec` is a
    leaf."""
    def sub(k):
        return f"{path}/{k}" if path else str(k)

    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      path=sub(k))
                for k, v in tree.items()}
    if _is_node(tree):
        out = [tree_map_with_path(fn, v, *(r[i] for r in rest), path=sub(i))
               for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return fn(path, tree, *rest)


def _tree_map(fn, tree: Any, *rest: Any) -> Any:
    return tree_map_with_path(lambda _, *xs: fn(*xs), tree, *rest)


def param_specs(params_shape: Any, mesh: Any) -> Any:
    """PartitionSpec tree matching a params (shape) tree."""
    global _ACTIVE_MESH
    prev, _ACTIVE_MESH = _ACTIVE_MESH, mesh
    try:
        return tree_map_with_path(
            lambda path, leaf: _spec_for_path(path, tuple(leaf.shape)),
            params_shape)
    finally:
        _ACTIVE_MESH = prev


def zero_specs(opt_shapes: Any, params_shape: Any, mesh: Any) -> AdamWState:
    """ZeRO-style optimizer-state sharding: m/v follow the param spec and
    additionally shard over 'data' (extending the param's model-sharded
    dim to ('model','data') when divisible, else sharding the largest
    replicated dim over 'data').  The step counter is replicated."""
    del opt_shapes
    pspecs = param_specs(params_shape, mesh)
    data = mesh.shape.get("data", 1)

    def one(spec: P, leaf) -> P:
        dims = list(spec) + [None] * (len(leaf.shape) - len(spec))

        def uses(axis) -> bool:
            return any(axis == d or (isinstance(d, tuple) and axis in d)
                       for d in dims)

        if uses("data"):  # already data-sharded (e.g. MoE expert ff dim)
            return P(*dims)
        # try extending the model-sharded dim
        for i, s in enumerate(dims):
            if s == "model" and leaf.shape[i] % (mesh.shape["model"] * data) == 0:
                dims[i] = ("model", "data")
                return P(*dims)
        # else shard the largest replicated dim over data
        best, bi = 0, None
        for i, s in enumerate(dims):
            if s is None and leaf.shape[i] % data == 0 and leaf.shape[i] > best:
                best, bi = leaf.shape[i], i
        if bi is not None and best >= data:
            dims[bi] = "data"
        return P(*dims)

    mv = _tree_map(one, pspecs, params_shape)
    return AdamWState(step=P(), m=mv, v=mv)


# ---------------------------------------------------------------------------
# Decode-cache specs.  The reference's decode caches are a TUPLE of
# per-group buffers ([B, ...] leaves, batch at axis 0) or one stacked
# array ([G, B, ...], batch at axis 1); the port's are a list of
# per-layer dicts ([B, ...]).  The batch axis is located per leaf.
# ---------------------------------------------------------------------------
def cache_specs(caches: Any, mesh: Any, batch: int, *,
                mode: str = "minor") -> Any:
    """PartitionSpec tree for decode caches (KV buffers, SSM state, conv
    tails): batch over 'data' when divisible, plus one 'model'-sharded
    dim per leaf.

    mode="minor": shard the most-minor divisible dim over 'model'
    (typically head_dim).  mode="seq": shard the LONGEST dim (the KV
    sequence) over 'model'.  The port's tensor-parallel groups lay their
    K/V out by KV heads per shard instead, as their attention computes
    (``distributed/tensor_parallel.py``); these specs are the
    reference's rules, kept exact."""
    data = mesh.shape.get("data", 1)
    model = mesh.shape.get("model", 1)

    def spec_for(leaf) -> P:
        shape = tuple(leaf.shape)
        nd = len(shape)
        s: list = [None] * nd
        b_ax = None
        if nd >= 2 and shape[1] == batch:
            b_ax = 1
        elif nd >= 1 and shape[0] == batch:
            b_ax = 0
        if b_ax is not None and batch % data == 0:
            s[b_ax] = "data"
        # axes past the batch axis are eligible for model/data sharding
        lo = (b_ax + 1) if b_ax is not None else 1
        if mode == "seq":
            best, bi = 0, None
            for i in range(lo, nd):
                if s[i] is None and shape[i] % model == 0 and shape[i] > best:
                    best, bi = shape[i], i
            if bi is not None and best >= model:
                s[bi] = "model"
        else:
            for i in range(nd - 1, lo - 1, -1):
                if s[i] is None and shape[i] % model == 0 \
                        and shape[i] >= model:
                    s[i] = "model"
                    break
        if b_ax is not None and s[b_ax] is None:
            best, bi = 0, None
            for i in range(lo, nd):
                if s[i] is None and shape[i] % data == 0 and shape[i] > best:
                    best, bi = shape[i], i
            if bi is not None:
                s[bi] = "data"
        return P(*s)

    return _tree_map(spec_for, caches)


def batch_spec(mesh: Any) -> P:
    """Global batch sharded over every data-parallel axis present."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return P(axes if len(axes) > 1 else (axes[0] if axes else None))


def model_dim(spec: P) -> Optional[int]:
    """The dim a spec splits over 'model' (alone, or first of a tuple of
    axes), None when it splits none."""
    for i, s in enumerate(spec):
        if s == "model" or (isinstance(s, tuple) and s and s[0] == "model"):
            return i
    return None
