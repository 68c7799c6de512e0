"""Tensor-parallel replica groups in one process: params split over a
group's devices, and the ops that compute with the pieces.

A group is the devices of one ``(1, tp)`` row of a serving mesh
(``launch/mesh.py``).  :func:`shard_params` places a tenant's params by
``distributed/sharding.py::param_specs``: a leaf whose spec names
'model' on a dim is cut along it into ``tp`` contiguous pieces, piece
``r`` on the group's device ``r`` (a :class:`Sharded` leaf); every other
leaf is held once, on the group's first device, where the unsplit work
that reads it runs (norms, residuals, the router, Mamba2's conv and
scan and their state).

The split decides the compute (``models/``):

* column split (``[d, n]`` cut on n): each shard computes its own
  output columns, :func:`col`; :func:`linear` concatenates them on the
  first device where the consumer needs the whole width;
* row split (``[n, d]`` cut on n): each shard multiplies its slice of
  the input and the partial products are summed on the first device in
  shard order, in fp32, then cast back (:func:`reduce`).  The order is
  fixed, so a group repeats bitwise, and serial equals pipelined;
* vocab split of the embedding: a masked lookup per shard, summed in
  order (:func:`embed`); the logits are each shard's columns,
  concatenated (:func:`unembed`).

Attention whose split falls on head boundaries runs shard by shard on
the shards' devices, each over its own KV heads' cache
(``models/attention.py::head_shards``); an expert-split MoE runs each
expert on the shard that holds it (``models/moe.py``).

The group's devices may repeat: on one card every piece sits on
``cuda:0`` and every op runs on its stream, so the server captures a
group's programs as CUDA graphs as it does a single device's.  Moving a
tensor to its own device is free.  No collective library is used:
NCCL puts no two ranks of one communicator on one GPU.

A dry run (``launch/dryrun.py``) traces a group on fake tensors under a
per-device counter (``launch/cost_analysis.py::CostCounter``), set by
:func:`traced`.  Only then do the hooks here act: :func:`capturing` says
yes (the trace prices the captured form), each of :func:`reduce`,
:func:`embed`'s sum and the gathers of :func:`linear` and
:func:`unembed` reports one collective at its output bytes, and
:func:`broadcast` reports the all-reduce of its input's gradient.
Outside a trace they compute what they computed before.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, Iterator, List, Sequence

import torch

from repro_torch.distributed import sharding

_TRACE: Any = None     # the dry run's counter, while it traces


class Sharded:
    """A param leaf cut into contiguous pieces along ``dim``: ``pieces[r]``
    lives on the group's device ``r``.  It is not a tensor: any torch op
    or indexing on it raises, so nothing computes silently on one slice;
    the ops of this module take it apart."""

    __slots__ = ("pieces", "dim")

    def __init__(self, pieces: Sequence[torch.Tensor], dim: int):
        self.pieces = list(pieces)
        self.dim = dim

    @property
    def shape(self) -> torch.Size:
        sizes = list(self.pieces[0].shape)
        sizes[self.dim] = sum(p.shape[self.dim] for p in self.pieces)
        return torch.Size(sizes)

    @property
    def dtype(self) -> torch.dtype:
        return self.pieces[0].dtype

    @property
    def devices(self) -> List[torch.device]:
        return [p.device for p in self.pieces]

    def offsets(self) -> List[int]:
        """Each piece's first index along ``dim``."""
        out, o = [], 0
        for p in self.pieces:
            out.append(o)
            o += p.shape[self.dim]
        return out

    def _refuse(self, what: str):
        raise TypeError(f"{what} on a tensor-parallel shard "
                        f"(dim {self.dim}, {len(self.pieces)} pieces): use "
                        f"repro_torch.distributed.tensor_parallel's ops")

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        raise TypeError(f"{getattr(func, '__name__', func)} on a "
                        f"tensor-parallel shard: use "
                        f"repro_torch.distributed.tensor_parallel's ops")

    def __getitem__(self, idx):
        self._refuse("indexing")

    def __array__(self, *args, **kwargs):
        self._refuse("conversion to an array")

    def __repr__(self) -> str:
        return (f"Sharded(shape={tuple(self.shape)}, dim={self.dim}, "
                f"devices={self.devices})")


def _refuse_operator(name: str):
    def op(self, *args):
        self._refuse(f"operator {name}")
    return op


for _name in ("add", "sub", "mul", "truediv", "matmul", "pow"):
    for _form in ("__{}__", "__r{}__"):
        setattr(Sharded, _form.format(_name),
                _refuse_operator(_form.format(_name)))


def is_sharded(x: Any) -> bool:
    return isinstance(x, Sharded)


def first_device(leaf: Any) -> torch.device:
    return leaf.pieces[0].device if is_sharded(leaf) else leaf.device


def group_devices(mesh: Any) -> List[torch.device]:
    """A ``(1, tp)`` mesh's devices, in shard order."""
    if mesh.devices.shape[0] != 1:
        raise ValueError(f"a replica group is one mesh row, got "
                         f"{mesh.devices.shape}")
    return [torch.device(d) for d in mesh.devices.flat]


@contextlib.contextmanager
def traced(counter: Any) -> Iterator[Any]:
    """Report this module's collectives to ``counter`` (a dry run's
    ``CostCounter``) while the block traces."""
    global _TRACE
    prev, _TRACE = _TRACE, counter
    try:
        yield counter
    finally:
        _TRACE = prev


def capturing() -> bool:
    """Whether the current CUDA stream is capturing a graph, whose
    shapes may not depend on data; a dry run's trace counts as one, so
    it prices the form a served (captured) step runs."""
    if _TRACE is not None:
        return True
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _collective(kind: str):
    """Under a trace, ``fn``'s copies between devices are one collective
    of ``kind``, counted at its output's bytes."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if _TRACE is None:
                return fn(*args, **kwargs)
            with _TRACE.quiet():
                out = fn(*args, **kwargs)
            _TRACE.collective(kind, out)
            return out
        return run
    return wrap


class _Broadcast(torch.autograd.Function):
    """:func:`broadcast` under a trace: the gradients of the copies,
    summed on the input's device, are one all-reduce."""

    @staticmethod
    def forward(ctx, x, *devices):
        ctx.device = x.device
        return tuple(x.to(d) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        with _TRACE.quiet():
            parts = [g.to(ctx.device) for g in grads if g is not None]
            total = parts[0]
            for g in parts[1:]:
                total = total + g
        _TRACE.collective("all-reduce", total)
        return (total,) + (None,) * len(grads)


def broadcast(x: torch.Tensor, devices: Sequence[torch.device]
              ) -> List[torch.Tensor]:
    """``x`` on each of ``devices``: a replicated input handed to every
    shard."""
    if _TRACE is not None and x.requires_grad and torch.is_grad_enabled():
        return list(_Broadcast.apply(x, *devices))
    return [x.to(d) for d in devices]


def one_device(devices: Sequence[torch.device]) -> bool:
    """Whether every device of a group is the same device."""
    return len(set(map(str, devices))) == 1


def shard_leaf(x: torch.Tensor, spec: Sequence[Any],
               devices: Sequence[torch.device]) -> Any:
    """One leaf placed by its spec: :class:`Sharded` along its 'model'
    dim, else the leaf on the first device.  Each piece is a copy of its
    own, so the whole leaf can be freed."""
    dim = sharding.model_dim(sharding.P(*spec))
    if is_sharded(x):
        # placed before (a params_fn that hands out a group's tree)
        assert x.dim == dim and x.devices == list(devices), (x, devices)
        return x
    if dim is None or len(devices) == 1:
        return x.to(devices[0])
    n = len(devices)
    size = x.shape[dim] // n
    return Sharded([x.narrow(dim, r * size, size).to(devices[r]).clone(
        memory_format=torch.contiguous_format) for r in range(n)], dim)


def shard_params(params: Any, mesh: Any) -> Any:
    """A params tree placed on a ``(1, tp)`` group by ``param_specs``: a
    new tree of new dicts and lists, whose leaves are
    :func:`shard_leaf`'s.  ``params`` is left as it was, so a caller may
    keep it (at full width it then holds the whole weights beside their
    pieces: drop it to free them)."""
    devices = group_devices(mesh)

    def place(node, spec):
        if isinstance(node, dict):
            return {k: place(v, spec[k]) for k, v in node.items()}
        if isinstance(node, list):
            return [place(v, s) for v, s in zip(node, spec)]
        return shard_leaf(node, spec, devices)
    return place(params, sharding.param_specs(params, mesh))


def leaves(tree: Any) -> List[Any]:
    """A params tree's leaves (tensors and :class:`Sharded`)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def bytes_by_shard(tree: Any) -> List[int]:
    """Bytes of a params tree each shard holds: piece ``r`` of every split
    leaf on shard ``r``, every other leaf on shard 0 (the group's first
    device)."""
    out: List[int] = []
    for leaf in leaves(tree):
        for r, t in enumerate(leaf.pieces if is_sharded(leaf) else [leaf]):
            out += [0] * (r + 1 - len(out))
            out[r] += t.numel() * t.element_size()
    return out


# ----------------------------------------------------------------- ops --
DotFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, w)


@_collective("all-reduce")
def reduce(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The sum of partial results on ``device``, in shard order, in fp32,
    cast back to the parts' dtype."""
    acc = parts[0].to(device).float()
    for p in parts[1:]:
        acc = acc + p.to(device).float()
    return acc.to(parts[0].dtype)


def col(x: torch.Tensor, w: Sharded, dot: DotFn = _matmul
        ) -> List[torch.Tensor]:
    """A column-split ``w`` [d, n]: each shard's output columns,
    ``x @ piece`` on the piece's device."""
    assert w.dim == w.pieces[0].dim() - 1, w
    return [dot(xr, p) for xr, p in zip(broadcast(x, w.devices), w.pieces)]


def split_last(x: torch.Tensor, w: Sharded) -> List[torch.Tensor]:
    """``x``'s last dim cut as a row-split ``w`` [n, d] cuts its rows,
    each slice on its piece's device."""
    assert w.dim == w.pieces[0].dim() - 2, w
    return [x[..., o:o + p.shape[w.dim]].to(p.device)
            for o, p in zip(w.offsets(), w.pieces)]


def row(parts: Sequence[torch.Tensor], w: Sharded, device: torch.device,
        dot: DotFn = _matmul) -> torch.Tensor:
    """A row-split ``w`` over inputs already cut by shard (``parts[r]``
    matches ``w.pieces[r]``): the partial products, summed in shard
    order on ``device`` (:func:`reduce`)."""
    return reduce([dot(x.to(p.device), p) for x, p in zip(parts, w.pieces)],
                  device)


def linear(w: Sharded, x: torch.Tensor, dot: DotFn = _matmul) -> torch.Tensor:
    """``x @ w`` for a split 2-D weight, the whole output on ``x``'s
    device: a column split's pieces concatenated, a row split's partial
    products summed in shard order."""
    if w.dim == w.pieces[0].dim() - 1:
        return _gather(col(x, w, dot), x.device)
    return row(split_last(x, w), w, x.device, dot)


@_collective("all-gather")
def _gather(parts: Sequence[torch.Tensor], device: torch.device
            ) -> torch.Tensor:
    """Column pieces concatenated on ``device``."""
    return torch.cat([y.to(device) for y in parts], dim=-1)


@_collective("all-reduce")
def embed(table: Sharded, tokens: torch.Tensor) -> torch.Tensor:
    """A vocab-split embedding lookup: each shard looks up the ids in its
    range (others masked to zero), the rows summed in shard order; every
    id lies in one range, so the sum is that shard's row exactly."""
    assert table.dim == 0, table
    dev = tokens.device
    out = None
    for o, p in zip(table.offsets(), table.pieces):
        local = tokens.to(p.device) - o
        hit = (local >= 0) & (local < p.shape[0])
        rows = p[local.clamp(0, p.shape[0] - 1)]
        rows = torch.where(hit[..., None], rows, torch.zeros_like(rows))
        out = rows.to(dev) if out is None else out + rows.to(dev)
    return out


def unembed(table: Sharded, x: torch.Tensor) -> torch.Tensor:
    """fp32 logits of a vocab-split table: each shard's columns,
    concatenated on ``x``'s device."""
    assert table.dim == 0, table
    return _gather([torch.matmul(xr, p.float().t()) for xr, p in
                    zip(broadcast(x.float(), table.devices), table.pieces)],
                   x.device)
