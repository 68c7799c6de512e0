"""Per-device cost of one traced step, and its roofline terms (the
counterpart of src/repro/launch/hlo_analysis.py).

The reference reads FLOPs and HBM bytes from XLA's ``cost_analysis`` and
collective bytes from the post-SPMD HLO text.  The port has neither: the
dry run (``launch/dryrun.py``) runs the step itself on fake tensors
(``torch._subclasses.fake_tensor``, which allocate nothing and launch no
kernel) under :class:`CostCounter`, a ``TorchDispatchMode`` that sees
every ATen op the step dispatches, forward and backward.  Each shard of
a tensor-parallel group is a fake CPU device of its own (``cpu`` for
shard 0, ``cpu:r`` for shard r: fake tensors keep the index, and refuse
an op that mixes two devices as the card would), so every op runs on
the device of its tensors and is counted there:

* FLOPs by ``torch.utils.flop_counter``'s formulas, the ones
  ``FlopCounterMode`` applies (``kernels/ssd_scan.py`` registers its
  kernels' own for its operators);
* HBM bytes, eager PyTorch's own traffic: an op's input bytes plus its
  output bytes, views (an output on an input's storage) free; an
  in-place op reads its inputs and writes what it changes, a scatter
  into a buffer (``index_copy_``, ``index_put_``, ``scatter_``) only
  the rows it writes;
* live bytes and their peak: every storage an op creates counts from
  its creation until its last tensor (views included) is freed;
* collective bytes by kind, counted once a collective at its output
  bytes per device, on every device of the group, as
  ``hlo_analysis.collective_bytes`` (ref :45) counts an HLO op.  The
  collectives are the group's own (``distributed/tensor_parallel.py``
  reports them): an all-reduce per ``reduce`` and per ``embed``, an
  all-gather per concatenation of column pieces, and in a backward pass
  the all-reduce of every input ``broadcast`` handed to the shards.  Any
  other copy between devices is a point-to-point transfer
  (``collective-permute``) at its bytes on the receiving device, except
  a copy from shard 0 to another shard, which hands a replicated input
  to the shard that uses it: an SPMD program holds it there already.

The reference's ``extrapolate`` (the unroll-delta method) has no
counterpart: XLA counts a scan body once, while the port's layer loop
is Python, so the counter sees every layer.  Nor has its
``collective_bytes`` over HLO text: there is no HLO.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import Counter
from typing import Any, Dict, Iterator, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# NVIDIA's data sheet, SXM part, dense: bf16 tensor-core FLOP/s, HBM
# bytes/s, and NVLink 4's bytes/s per direction (in place of the v5e's
# ICI: ref launch/mesh.py:24-27).  Published figures, not measured ones.
HARDWARE: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"peak_flops": 989e12, "hbm_bw": 3.35e12,
                              "ici_bw": 450e9},
}
CPU_STAND_IN = "NVIDIA H100 80GB HBM3"
_H100 = HARDWARE[CPU_STAND_IN]

# in-place ops that write only the rows of their source into a buffer
_SCATTERS = {aten.index_copy_, aten.index_put_, aten._index_put_impl_,
             aten.scatter_, aten.scatter_add_, aten.index_add_,
             aten.masked_scatter_}
_WRITE_ONLY = {aten.copy_, aten.fill_, aten.zero_}


def hardware(device: Any = "cuda") -> Dict[str, Any]:
    """The card whose limits a roofline divides by: its name,
    ``total_memory`` and SM count from ``torch.cuda.get_device_properties``
    and its peaks from :data:`HARDWARE`, by name.  An unknown card
    raises.  ``"cpu"`` (the tests) takes :data:`CPU_STAND_IN`'s peaks and
    reads no card: its memory and SM count are None."""
    dev = torch.device(device)
    if dev.type == "cpu":
        name, memory, sms = CPU_STAND_IN, None, None
    else:
        props = torch.cuda.get_device_properties(dev)
        name, memory, sms = (props.name, props.total_memory,
                             props.multi_processor_count)
    if name not in HARDWARE:
        raise KeyError(f"no peak rates for {name!r}; known: "
                       f"{sorted(HARDWARE)}")
    return {"name": name, "total_memory": memory, "sm_count": sms,
            **HARDWARE[name]}


@dataclasses.dataclass
class Roofline:
    flops: float               # per-device FLOPs
    hbm_bytes: float           # per-device bytes accessed
    coll_bytes: float          # per-device collective bytes
    coll_breakdown: Dict[str, int]
    peak_flops: float = _H100["peak_flops"]
    hbm_bw: float = _H100["hbm_bw"]
    ici_bw: float = _H100["ici_bw"]     # NVLink, one direction

    @property
    def compute_s(self) -> float:
        return self.flops / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / self.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / self.ici_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_dict(self) -> Dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes,
            "coll_breakdown": self.coll_breakdown,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
        }


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree: Any) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _op_tensors(xs) -> List[torch.Tensor]:
    """The tensors among an ATen op's arguments or results (a tensor, or
    a list of them: ATen nests no deeper)."""
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class CostCounter(TorchDispatchMode):
    """FLOPs, HBM bytes, live bytes and collective bytes of every device
    of a group (``devices``, in shard order), for the ops dispatched
    while it is active (see the module docstring).  Enter it inside the
    ``FakeTensorMode`` that made the inputs, so that the ops reach it
    first; tensors that exist before it starts (the arguments) are not
    live bytes of its own."""

    def __init__(self, devices: Sequence[Any]):
        super().__init__()
        self.devices = [torch.device(d) for d in devices]
        self._shard = {str(d): r for r, d in enumerate(self.devices)}
        n = len(self.devices)
        self.flops = [0] * n
        self.hbm_bytes = [0] * n
        self.live = [0] * n
        self.peak = [0] * n
        self.coll: List[Counter] = [Counter() for _ in range(n)]
        self._refs: Dict[int, int] = {}
        self._quiet = 0

    def shard(self, device: torch.device) -> int:
        return self._shard[str(device)]

    @contextlib.contextmanager
    def quiet(self) -> Iterator[None]:
        """Copies between devices inside the block are the data of a
        collective the caller counts itself."""
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    def collective(self, kind: str, out: Any) -> None:
        """One collective of ``kind``, its output ``out`` on every device
        of the group."""
        size = sum(nbytes(t) for t in _tensors(out))
        for c in self.coll:
            c[kind] += size

    def _release(self, key: int, r: int, size: int) -> None:
        self._refs[key] -= 1
        if not self._refs[key]:
            del self._refs[key]
            self.live[r] -= size

    def _track(self, t: torch.Tensor, new: bool) -> None:
        key = _key(t)
        if new and key not in self._refs:
            r, size = self.shard(t.device), t.untyped_storage().nbytes()
            self._refs[key] = 0
            self.live[r] += size
            self.peak[r] = max(self.peak[r], self.live[r])
        elif key not in self._refs:
            return          # a view of an argument
        r = self.shard(t.device)
        self._refs[key] += 1
        weakref.finalize(t, self._release, key, r,
                         t.untyped_storage().nbytes())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _op_tensors(args) + _op_tensors(kwargs.values())
        outs = _op_tensors(out if isinstance(out, (list, tuple)) else (out,))
        if not outs:
            return out
        mutable = func._schema.is_mutable
        if func is aten._to_copy.default and ins[0].device != outs[0].device:
            src, dst = self.shard(ins[0].device), self.shard(outs[0].device)
            if not self._quiet and src != 0:
                self.coll[dst]["collective-permute"] += nbytes(outs[0])
            self._track(outs[0], new=True)
            return out
        r = self.shard(outs[0].device)
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops[r] += flop_registry[packet](*args, **kwargs,
                                                   out_val=out)
        inputs = {_key(t) for t in ins}
        view = not mutable and all(_key(t) in inputs for t in outs)
        if not view:
            self.hbm_bytes[r] += self._op_bytes(func, args, ins, outs)
        if not mutable:
            for t in outs:
                self._track(t, new=_key(t) not in inputs)
        return out

    @staticmethod
    def _op_bytes(func, args, ins: List[torch.Tensor],
                  outs: List[torch.Tensor]) -> int:
        if not func._schema.is_mutable:
            return sum(map(nbytes, ins)) + sum(map(nbytes, outs))
        written = [a for a, s in zip(args, func._schema.arguments)
                   if isinstance(a, torch.Tensor) and s.alias_info is not None
                   and s.alias_info.is_write]
        read = [t for t in ins if not any(t is w for w in written)]
        packet = func.overloadpacket
        if packet in _SCATTERS:
            rows = max((t.numel() for t in read), default=0)
            return (sum(map(nbytes, read))
                    + sum(rows * w.element_size() for w in written))
        if packet in _WRITE_ONLY:
            return sum(map(nbytes, read)) + sum(map(nbytes, written))
        return sum(map(nbytes, read)) + 2 * sum(map(nbytes, written))

    def roofline(self, r: int, hw: Optional[Dict[str, Any]] = None,
                 extra: Optional[Dict[str, int]] = None) -> Roofline:
        """Device ``r``'s roofline at ``hw``'s peaks (:func:`hardware`),
        with ``extra`` collective bytes by kind added."""
        hw = hw or {**_H100}
        coll = Counter({k: 0 for k in COLLECTIVES})
        coll.update(self.coll[r])
        coll.update(extra or {})
        return Roofline(flops=float(self.flops[r]),
                        hbm_bytes=float(self.hbm_bytes[r]),
                        coll_bytes=float(sum(coll.values())),
                        coll_breakdown=dict(coll),
                        peak_flops=hw["peak_flops"], hbm_bw=hw["hbm_bw"],
                        ici_bw=hw["ici_bw"])
