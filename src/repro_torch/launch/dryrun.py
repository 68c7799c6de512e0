"""Dry run: every (architecture x input shape) on the production meshes,
traced on fake tensors; per-device memory and the roofline terms
(counterpart of src/repro/launch/dryrun.py).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --roofline

Reports land in experiments/dryrun_torch/<arch>__<shape>__<mesh>.json
(experiments/dryrun/ holds the reference's).  The reference's
``roofline_cell`` lowers a second time for its unroll delta; here one
trace gives the memory and the roofline, so ``lower_cell`` computes both.

The reference lowers and compiles each step under the production
meshes' shardings and reads XLA's memory and cost analyses.  Here:

* the argument bytes are the bytes the specs leave on one device:
  ``distributed/sharding.py``'s ``param_specs``, ``zero_specs``,
  ``cache_specs`` and the reference's batch rule (``_batch_shardings``)
  over the port's input specs (``models/model.py::input_specs``; the
  caches regrouped as the reference lays them out), at the mesh's axis
  sizes;
* the step is traced for one replica group, a ``(1, model)`` group of
  fake CPU shards (``tensor_parallel.shard_params``), at the local batch,
  through the port's ``make_train_step``, ``make_prefill`` or
  ``make_decode_step`` under ``cost_analysis.CostCounter``.  The trace
  allocates nothing and launches nothing.  It follows the card's route:
  these steps take no plan, so attention, the FFN and the projections
  run as plain PyTorch on the card too, and Mamba2's intra-chunk scan
  (``kernels/ssd_scan.py``'s operators, forward and backward) is priced
  as its kernel, at the kernel's FLOPs and bytes.  A server under a plan
  runs flash attention, ``block_fused_ffn`` and ``cache_matmul`` instead;
  no cell prices those;
* the temp bytes are device 0's peak live bytes in the trace less its
  arguments (the step's outputs included, as they are live at its end);
* the roofline takes the busiest device's FLOPs, HBM bytes and
  collective bytes, adds a train step's data-parallel gradient traffic
  from the specs where the mesh has ``data`` > 1, and divides by the
  card's peaks (``cost_analysis.hardware``; ``--device cpu`` takes the
  H100 80GB HBM3's figures without a card).

Where the trace's ops differ from the card's route: an ``"fsdp"`` MoE
decode over a split group is priced in its captured form (every entry
on each shard, a clamped id: the form a served step replays), and a
bf16 expert product (``models/moe.py::_dot_f32``) upcasts to fp32 on
the CPU where the card multiplies bf16 into fp32: the same FLOPs, but
the trace counts the fp32 copies' bytes the card does not move.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
import traceback
from collections import Counter
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ARCH_IDS
from repro_torch.distributed import sharding
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import (batch_spec, cache_specs,
                                              param_specs, zero_specs)
from repro_torch.launch import cost_analysis
from repro_torch.launch.mesh import ServingMesh, make_serving_mesh
from repro_torch.models import model as M
from repro_torch.models.base import ArchConfig, get_arch
from repro_torch.optim import adamw

REPORT_DIR = (pathlib.Path(__file__).resolve().parents[3] / "experiments"
              / "dryrun_torch")


def make_production_mesh(*, multi_pod: bool = False) -> ServingMesh:
    """The production meshes' axis sizes (ref launch/mesh.py:31): "16x16"
    is (data 16, model 16), "2x16x16" adds ``pod``.  No devices: the dry
    run places nothing on it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return ServingMesh(np.empty(shape, dtype=object), axes)


def _axes_size(mesh: Any, entry: Any) -> int:
    n = 1
    for a in (entry if isinstance(entry, tuple) else (entry,)):
        if a is not None:
            n *= mesh.shape.get(a, 1)
    return n


def _batch_specs(mesh: Any, batch: Dict[str, Any]) -> Dict[str, Any]:
    """The reference's ``_batch_shardings`` (ref :44): each leaf's
    leading dim over the data-parallel axes when they divide it."""
    axes = tuple(batch_spec(mesh))[0]
    size = _axes_size(mesh, axes)
    return {k: sharding.P(*(((axes if v.shape[0] % size == 0
                              and v.shape[0] >= size else None),)
                            + (None,) * (v.dim() - 1)))
            for k, v in batch.items()}


def local_batch(mesh: Any, batch: int) -> int:
    """One replica group's batch: the data-parallel split of the global
    batch when it divides, else the whole batch (ref :44-55)."""
    size = _axes_size(mesh, tuple(batch_spec(mesh))[0])
    return batch // size if batch % size == 0 and batch >= size else batch


def _leaf_bytes(leaf: torch.Tensor, spec: Any, mesh: Any) -> int:
    div = 1
    for s in spec:
        div *= _axes_size(mesh, s)
    size = leaf.numel() * leaf.element_size()
    assert size % div == 0, (tuple(leaf.shape), spec)
    return size // div


def _tree_bytes(tree: Any, specs: Any, mesh: Any) -> int:
    return sum(_leaf_bytes(leaf, spec, mesh) for leaf, spec in
               zip(_leaves(tree), _leaves(specs)))


def _leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, sharding.P):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# the reference keeps a tuple of per-group caches up to this many layer
# groups and stacks them past it (ref models/transformer.py:39, :266)
_DECODE_UNROLL_MAX_GROUPS = 8


def _stack(leaves: List[Any]) -> Any:
    """Shape stand-ins of ``leaves`` (equal trees) stacked on a new
    leading dim.  Call inside a ``FakeTensorMode``."""
    first = leaves[0]
    if isinstance(first, dict):
        return {k: _stack([x[k] for x in leaves]) for k in first}
    return torch.empty((len(leaves),) + tuple(first.shape), dtype=first.dtype)


def reference_cache_layout(cfg: ArchConfig, caches: List[dict]) -> Any:
    """The port's per-layer caches in the reference's layout: one entry a
    layer group (a hybrid group's Mamba2 states stacked, beside its K/V),
    the groups stacked past :data:`_DECODE_UNROLL_MAX_GROUPS`.
    ``cache_specs`` finds a leaf's batch axis by its position, so the
    bytes it leaves on a device depend on the layout: a hybrid stack's
    Mamba2 states, stacked twice, keep their batch whole.  Call inside a
    ``FakeTensorMode``."""
    groups: List[Any] = list(caches)
    if cfg.family == "hybrid":
        k = cfg.attn_every
        groups = [{"ssm": _stack(caches[g:g + k - 1]), "attn": caches[g + k - 1]}
                  for g in range(0, len(caches), k)]
    if len(groups) <= _DECODE_UNROLL_MAX_GROUPS:
        return tuple(groups)
    return _stack(groups)


def argument_bytes(cfg: ArchConfig, shape: M.ShapeSpec, mesh: Any) -> int:
    """The bytes the specs leave on one device for every input of the
    step.  Call inside a ``FakeTensorMode``."""
    specs = M.input_specs(cfg, shape)
    params = specs["params"]
    total = _tree_bytes(params, param_specs(params, mesh), mesh)
    if shape.kind == "train":
        total += _tree_bytes(specs["opt_state"],
                             zero_specs(specs["opt_state"], params, mesh),
                             mesh)
    if shape.kind != "decode":
        return total + _tree_bytes(specs["batch"],
                                   _batch_specs(mesh, specs["batch"]), mesh)
    B = shape.global_batch
    caches = reference_cache_layout(cfg, specs["caches"])
    total += _tree_bytes(caches, cache_specs(caches, mesh, B), mesh)
    rest = {k: specs[k] for k in ("token", "enc_out") if k in specs}
    total += _tree_bytes(rest, _batch_specs(mesh, rest), mesh)
    return total + specs["index"].numel() * specs["index"].element_size()


def _dp_gradient_traffic(cfg: ArchConfig, mesh: Any) -> Dict[str, int]:
    """A train step's data-parallel traffic per device: a leaf whose
    optimizer state ``zero_specs`` splits over 'data' reduce-scatters
    its gradient and all-gathers its update, any other leaf all-reduces
    its gradient.  Call inside a ``FakeTensorMode``."""
    params = M.param_specs_shapes(cfg)
    pspecs = _leaves(param_specs(params, mesh))
    zspecs = _leaves(zero_specs(None, params, mesh).m)
    out: Counter = Counter()
    for leaf, ps, zs in zip(_leaves(params), pspecs, zspecs):
        if any(s == "data" or (isinstance(s, tuple) and "data" in s)
               for s in zs):
            out["reduce-scatter"] += _leaf_bytes(leaf, zs, mesh)
            out["all-gather"] += _leaf_bytes(leaf, ps, mesh)
        else:
            out["all-reduce"] += _leaf_bytes(leaf, ps, mesh)
    return dict(out)


def _model_flops_per_chip(cfg: ArchConfig, shape: M.ShapeSpec,
                          chips: int) -> float:
    n_act = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_act * tokens / chips
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_act * tokens / chips
    return 2.0 * n_act * shape.global_batch / chips  # decode: 1 token/seq


def fake_devices(model: int) -> List[torch.device]:
    """A replica group's fake devices: shard 0 on ``cpu``, shard r on
    ``cpu:r``."""
    return [torch.device("cpu")] + [torch.device("cpu", r)
                                    for r in range(1, model)]


def _step_inputs(cfg: ArchConfig, shape: M.ShapeSpec, group: ServingMesh):
    """(step function, its arguments) for one group at ``shape``'s batch,
    params split over the group.  Call inside a ``FakeTensorMode``."""
    params = tp.shard_params(M.param_specs_shapes(cfg), group)
    if shape.kind == "train":
        return M.make_train_step(cfg), (params, M.opt_specs_shapes(params),
                                        M.batch_specs(cfg, shape))
    if shape.kind == "prefill":
        return M.make_prefill(cfg), (params, M.batch_specs(cfg, shape))
    B = shape.global_batch
    args = (params, M.cache_specs(cfg, B, shape.seq_len, params=params),
            torch.empty((B, 1), dtype=torch.int32),
            torch.empty((), dtype=torch.int32))
    if cfg.family == "encdec":
        args += (torch.empty((B, cfg.enc_len, cfg.d_model),
                             dtype=cfg.torch_dtype),)
    return M.make_decode_step(cfg), args


@dataclasses.dataclass
class Trace:
    """One traced step: the counter, device 0's argument and output
    bytes in the port's layout, and the trace's seconds."""
    counter: cost_analysis.CostCounter
    args_bytes: List[int]
    output_bytes: List[int]
    trace_s: float
    local_batch: int
    model: int


def _bytes_by_device(tree: Any, counter: cost_analysis.CostCounter
                     ) -> List[int]:
    """The bytes of ``tree``'s tensors (split leaves' pieces included) on
    each device of the group, each tensor once."""
    out = [0] * len(counter.devices)
    seen = set()
    for t in adamw.tree_leaves(tree):
        if isinstance(t, torch.Tensor) and id(t) not in seen:
            seen.add(id(t))
            out[counter.shard(t.device)] += cost_analysis.nbytes(t)
    return out


def trace_step(cfg: ArchConfig, shape: M.ShapeSpec, mesh: Any) -> Trace:
    """Trace one replica group of ``mesh`` (``(1, model)``) through
    ``shape``'s step at the local batch, under a fresh counter."""
    model = mesh.shape.get("model", 1)
    group = make_serving_mesh(1, tp=model, devices=fake_devices(model))
    lshape = dataclasses.replace(
        shape, global_batch=local_batch(mesh, shape.global_batch))
    with FakeTensorMode(allow_non_fake_inputs=True):
        step, args = _step_inputs(cfg, lshape, group)
        counter = cost_analysis.CostCounter(fake_devices(model))
        args_bytes = _bytes_by_device(args, counter)
        t0 = time.perf_counter()
        with tp.traced(counter), counter:
            out = step(*args)
        trace_s = time.perf_counter() - t0
        output_bytes = _bytes_by_device(out, counter)
        del out
    return Trace(counter, args_bytes, output_bytes, trace_s,
                 lshape.global_batch, model)


def _roofline(cfg: ArchConfig, shape: M.ShapeSpec, mesh: Any, trace: Trace,
              hw: Dict[str, Any]) -> Dict[str, Any]:
    extra: Dict[str, int] = {}
    if shape.kind == "train" and mesh.shape.get("data", 1) > 1:
        with FakeTensorMode():
            extra = _dp_gradient_traffic(cfg, mesh)
    rfs = [trace.counter.roofline(r, hw, extra)
           for r in range(len(trace.counter.devices))]
    busiest = max(range(len(rfs)), key=lambda r: rfs[r].bound_s)
    rf = rfs[busiest]
    mf = _model_flops_per_chip(cfg, shape, mesh.devices.size)
    out = rf.to_dict()
    out["busiest_device"] = busiest
    out["model_flops"] = mf
    out["useful_ratio"] = mf / rf.flops if rf.flops else 0.0
    return out


def _priced(cfg: ArchConfig, shape: M.ShapeSpec, model: int) -> Dict[str, str]:
    out = {"kernels": "ssd_chunk and its backward as the card's kernels; "
                      "no plan, so no other kernel"}
    if (cfg.is_moe and shape.kind == "decode" and model > 1
            and sharding._MOE_MODE == "fsdp"):
        out["moe_decode"] = ("captured: every entry on each shard, a "
                             "clamped id")
    return out


def _print_roofline(arch_id: str, shape_name: str,
                    rf: Dict[str, Any]) -> None:
    print(f"[roofline] {arch_id} x {shape_name}: "
          f"dominant={rf['dominant']} "
          f"compute={rf['compute_s'] * 1e3:.2f}ms "
          f"memory={rf['memory_s'] * 1e3:.2f}ms "
          f"collective={rf['collective_s'] * 1e3:.2f}ms "
          f"useful={rf['useful_ratio']:.2f}", flush=True)


def lower_cell(arch_id: str, shape_name: str, multi_pod: bool = False,
               roofline: bool = False, verbose: bool = True,
               device: Any = "cuda") -> Dict[str, Any]:
    """One cell's report (ref :165): the argument bytes from the specs,
    the trace's output and temp bytes of device 0, and with
    ``roofline`` (single pod only, as the reference's) the roofline of
    the busiest device."""
    hw = cost_analysis.hardware(device)
    cfg = get_arch(arch_id)
    shape = M.SHAPES[shape_name]
    ok, why = M.shape_applicable(cfg, shape)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    report: Dict[str, Any] = {
        "arch": arch_id, "shape": shape_name, "mesh": mesh_name,
        "status": "skip", "reason": why,
    }
    if not ok:
        return report
    mesh = make_production_mesh(multi_pod=multi_pod)
    with FakeTensorMode():
        report["argument_size_in_bytes"] = argument_bytes(cfg, shape, mesh)
    trace = trace_step(cfg, shape, mesh)
    report["output_size_in_bytes"] = trace.output_bytes[0]
    report["temp_size_in_bytes"] = trace.counter.peak[0]
    report["trace_s"] = round(trace.trace_s, 1)
    report["group"] = [1, trace.model]
    report["local_batch"] = trace.local_batch
    report["priced"] = _priced(cfg, shape, trace.model)
    if roofline and not multi_pod:
        report["roofline"] = _roofline(cfg, shape, mesh, trace, hw)
    report["hardware"] = hw
    report["status"] = "ok"
    if verbose:
        print(f"[dryrun] {arch_id} x {shape_name} x {mesh_name}: "
              f"trace {report['trace_s']}s "
              f"args/device={report['argument_size_in_bytes'] / 2**30:.2f}GiB "
              f"temp/device0={report['temp_size_in_bytes'] / 2**30:.2f}GiB",
              flush=True)
        if "roofline" in report:
            _print_roofline(arch_id, shape_name, report["roofline"])
    return report


def save_report(report: Dict[str, Any], opt: str = "base") -> pathlib.Path:
    REPORT_DIR.mkdir(parents=True, exist_ok=True)
    suffix = "" if opt == "base" else f"__{opt}"
    fn = REPORT_DIR / (f"{report['arch']}__{report['shape']}__"
                       f"{report['mesh']}{suffix}.json")
    fn.write_text(json.dumps(report, indent=2))
    return fn


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--roofline", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="whose peaks the roofline divides by: the card "
                         "(cuda), or the H100 80GB HBM3's figures (cpu)")
    args = ap.parse_args(argv)
    cost_analysis.hardware(args.device)     # no card, no cuda run

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(M.SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells: List[Tuple[str, str, bool]] = [
        (a, s, mp) for a in archs for s in shapes for mp in meshes]

    failures = 0
    for a, s, mp in cells:
        try:
            rep = lower_cell(a, s, multi_pod=mp, roofline=args.roofline,
                             device=args.device)
        except Exception as e:  # a failure here is a bug in the port
            traceback.print_exc()
            rep = {"arch": a, "shape": s,
                   "mesh": "2x16x16" if mp else "16x16",
                   "status": "fail", "error": str(e)[:500]}
            failures += 1
        save_report(rep)
        if rep["status"] == "skip":
            print(f"[dryrun] {a} x {s}: SKIP ({rep['reason']})", flush=True)
    print(f"[dryrun] done: {len(cells)} cells, {failures} failures",
          flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
