"""The port's dry run (src/repro_torch/launch/dryrun.py, cost_analysis.py
and models/model.py's input specs) against the reference's
(src/repro/launch/dryrun.py, hlo_analysis.py, models/model.py).

The specs are held exactly: ``SHAPES`` and ``shape_applicable``, every
input-spec leaf's shape and dtype against the reference's
``jax.eval_shape`` trees less the stacked layer dims, the bytes the
specs leave on one device against the reference's ``param_specs``,
``zero_specs``, ``cache_specs(mode="minor")`` and ``_batch_shardings``
on ``jax.sharding.AbstractMesh``es (no compile), and
``_model_flops_per_chip``.  The trace is held against real CPU runs:
its FLOPs equal ``FlopCounterMode``'s over the same step, Mamba2's scan
is priced as its kernel, and a tp = 2 group's collectives equal a count
by hand.
"""
import contextlib
import dataclasses
import functools
import io
import json
import os
from collections import Counter

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.distributed import sharding as RS
from repro.models import model as RM
from repro.models.base import get_arch as ref_arch
from repro_torch.configs import ARCH_IDS
from repro_torch.distributed import sharding as PS
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ssd_scan as kssd
from repro_torch.launch import cost_analysis as CA
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.models.base import get_arch
from repro_torch.optim import adamw

FAMILIES = ["yi-9b", "mamba2-370m", "olmoe-1b-7b", "zamba2-2.7b",
            "whisper-tiny", "llava-next-mistral-7b"]
# the four meshes of the argument-byte parity: axis sizes, axis names
MESHES = [((1, 2), ("data", "model")), ((2, 2), ("data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]


def _ref_dryrun():
    """The reference's dry-run module.  It sets ``XLA_FLAGS`` (512 forced
    host devices) when imported; the flag is put back at once, after the
    backend has started, so neither this process nor a child sees it."""
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return dryrun


def _cfgs(aid, full):
    return ((ref_arch(aid), get_arch(aid)) if full
            else (ref_arch(aid).reduced(), get_arch(aid).reduced()))


@functools.lru_cache(maxsize=None)
def _ref_specs(aid, full, shape_name):
    return RM.input_specs(_cfgs(aid, full)[0], RM.SHAPES[shape_name])


# ------------------------------------------------------------ shapes --
def test_shapes_equal_reference():
    assert ARCH_IDS == REF_ARCH_IDS
    assert ({k: dataclasses.astuple(v) for k, v in M.SHAPES.items()}
            == {k: dataclasses.astuple(v) for k, v in RM.SHAPES.items()})


@pytest.mark.parametrize("aid", ARCH_IDS)
def test_shape_applicable_equal_reference(aid):
    for name in M.SHAPES:
        assert (M.shape_applicable(get_arch(aid), M.SHAPES[name])
                == RM.shape_applicable(ref_arch(aid), RM.SHAPES[name]))


# ------------------------------------------------------- input specs --
def _walk(tree, path=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {path: tree}
    out = {}
    for k, v in items:
        out.update(_walk(v, f"{path}/{k}"))
    return out


def _key(path, arg):
    """A leaf's path without list and tuple indices; a cache leaf by its
    name alone (the reference nests a hybrid group's caches in
    ``{"ssm", "attn"}``, the port lists them by layer)."""
    parts = [p for p in path.split("/") if p and not p.isdigit()]
    return parts[-1] if arg == "caches" else "/".join(parts)


def _dtype(x):
    return str(x.dtype).replace("torch.", "")


def _leaf_counts(port, ref):
    """Per key: the port's leaves as a Counter of (shape, dtype), and the
    reference's, each stacked leaf counted once per index of the dims
    the port's leaf lacks."""
    got, want, ndim = {}, {}, {}
    for path, leaf in _walk(port).items():
        k = _key(path, path.split("/")[1])
        got.setdefault(k, Counter())[(tuple(leaf.shape), _dtype(leaf))] += 1
        ndim[k] = leaf.dim()
    for path, leaf in _walk(ref).items():
        k = _key(path, path.split("/")[1])
        drop = len(leaf.shape) - ndim[k]
        want.setdefault(k, Counter())[(tuple(leaf.shape[drop:]),
                                       _dtype(leaf))] += int(
            np.prod(leaf.shape[:drop]))
    return got, want


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("aid", FAMILIES)
def test_input_specs_follow_reference_leaves(aid, full):
    _, cfg = _cfgs(aid, full)
    for name, shape in M.SHAPES.items():
        with FakeTensorMode():
            specs = M.input_specs(cfg, shape)
        ref = _ref_specs(aid, full, name)
        assert list(specs) == list(ref), name
        got, want = _leaf_counts(specs, ref)
        assert got == want, (name, {k for k in got if got[k] != want.get(k)})


def test_input_specs_refuse_to_allocate():
    with pytest.raises(RuntimeError, match="FakeTensorMode"):
        M.input_specs(get_arch("yi-9b"), M.SHAPES["decode_32k"])


def test_input_specs_are_fake_at_full_width():
    with FakeTensorMode():
        specs = M.input_specs(get_arch("llava-next-mistral-7b"),
                              M.SHAPES["train_4k"])
        leaves = adamw.tree_leaves(specs)
        assert all(type(t).__name__ == "FakeTensor" for t in leaves)
        got = sum(t.numel() for t in adamw.tree_leaves(specs["params"]))
    ref = _ref_specs("llava-next-mistral-7b", True, "train_4k")["params"]
    assert got == sum(int(np.prod(x.shape))
                      for x in jax.tree_util.tree_leaves(ref))


# ---------------------------------------------------- argument bytes --
def _ref_leaf_bytes(leaf, spec, mesh):
    div = 1
    for s in tuple(spec):
        for a in (s if isinstance(s, tuple) else (s,)):
            if a is not None:
                div *= mesh.shape[a]
    size = int(np.prod(leaf.shape)) * leaf.dtype.itemsize
    assert size % div == 0
    return size // div


def _ref_tree_bytes(tree, specs, mesh):
    from jax.sharding import NamedSharding
    specs = jax.tree_util.tree_map(
        lambda s: s.spec if isinstance(s, NamedSharding) else s, specs,
        is_leaf=lambda s: isinstance(s, (NamedSharding, RS.P)))
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda s: isinstance(s, RS.P))
    assert len(leaves) == len(spec_leaves)
    return sum(_ref_leaf_bytes(x, s, mesh)
               for x, s in zip(leaves, spec_leaves))


def _ref_argument_bytes(aid, shape_name, mesh):
    """The bytes the reference's specs leave on one device: the
    shardings its ``_lower`` (ref dryrun.py:78) hands to ``jax.jit``."""
    RD = _ref_dryrun()
    specs = _ref_specs(aid, True, shape_name)
    shape = RM.SHAPES[shape_name]
    params = specs["params"]
    total = _ref_tree_bytes(params, RS.param_specs(params, mesh), mesh)
    if shape.kind == "train":
        total += _ref_tree_bytes(
            specs["opt_state"],
            RS.zero_specs(specs["opt_state"], params, mesh), mesh)
    if shape.kind != "decode":
        return total + _ref_tree_bytes(
            specs["batch"], RD._batch_shardings(mesh, specs["batch"]), mesh)
    total += _ref_tree_bytes(
        specs["caches"], RS.cache_specs(specs["caches"], mesh,
                                        shape.global_batch, mode="minor"),
        mesh)
    rest = {k: specs[k] for k in ("token", "enc_out") if k in specs}
    total += _ref_tree_bytes(rest, RD._batch_shardings(mesh, rest), mesh)
    return total + specs["index"].dtype.itemsize


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
@pytest.mark.parametrize("aid", FAMILIES)
def test_argument_bytes_equal_reference_specs(aid, mesh):
    sizes, axes = mesh
    ref_mesh = AbstractMesh(sizes, axes)
    port_mesh = D.ServingMesh(np.empty(sizes, dtype=object), axes)
    cfg = get_arch(aid)
    for name, shape in M.SHAPES.items():
        with FakeTensorMode():
            got = D.argument_bytes(cfg, shape, port_mesh)
        assert got == _ref_argument_bytes(aid, name, ref_mesh), name


def test_argument_bytes_whisper_multi_pod():
    """The count the reference's own specs give for the committed
    reference report's cell (its XLA figure is 109,250,324)."""
    with FakeTensorMode():
        got = D.argument_bytes(get_arch("whisper-tiny"),
                               M.SHAPES["decode_32k"],
                               D.make_production_mesh(multi_pod=True))
    assert got == 110_436_884


@pytest.mark.parametrize("mesh", MESHES[1:], ids=lambda m: "x".join(map(str, m[0])))
def test_data_parallel_traffic_follows_reference_zero_specs(mesh):
    sizes, axes = mesh
    ref_mesh = AbstractMesh(sizes, axes)
    port_mesh = D.ServingMesh(np.empty(sizes, dtype=object), axes)
    for aid in ("olmoe-1b-7b", "mamba2-370m"):
        params = _ref_specs(aid, True, "train_4k")["params"]
        leaves = jax.tree_util.tree_leaves(params)
        is_p = lambda s: isinstance(s, RS.P)  # noqa: E731
        pspecs = jax.tree_util.tree_leaves(RS.param_specs(params, ref_mesh),
                                           is_leaf=is_p)
        zspecs = jax.tree_util.tree_leaves(
            RS.zero_specs(None, params, ref_mesh).m, is_leaf=is_p)
        want = Counter()
        for x, ps, zs in zip(leaves, pspecs, zspecs):
            if any(s == "data" or (isinstance(s, tuple) and "data" in s)
                   for s in zs):
                want["reduce-scatter"] += _ref_leaf_bytes(x, zs, ref_mesh)
                want["all-gather"] += _ref_leaf_bytes(x, ps, ref_mesh)
            else:
                want["all-reduce"] += _ref_leaf_bytes(x, ps, ref_mesh)
        with FakeTensorMode():
            got = D._dp_gradient_traffic(get_arch(aid), port_mesh)
        assert got == dict(want), aid


@pytest.mark.parametrize("aid", ARCH_IDS)
def test_model_flops_per_chip_equal_reference(aid):
    RD = _ref_dryrun()
    for name in M.SHAPES:
        for chips in (256, 512):
            assert (D._model_flops_per_chip(get_arch(aid), M.SHAPES[name],
                                            chips)
                    == RD._model_flops_per_chip(ref_arch(aid),
                                                RM.SHAPES[name], chips))


def test_local_batch_follows_batch_rule():
    one = D.make_production_mesh(multi_pod=False)
    two = D.make_production_mesh(multi_pod=True)
    assert D.local_batch(one, 256) == 16 and D.local_batch(two, 256) == 8
    assert D.local_batch(one, 128) == 8 and D.local_batch(two, 128) == 4
    assert D.local_batch(one, 1) == 1 and D.local_batch(two, 24) == 24


# -------------------------------------------------------------- trace --
def _real_inputs(cfg, shape):
    """Real CPU inputs of ``shape``'s step, from a seed."""
    g = torch.Generator().manual_seed(0)
    params = M.init_params(cfg, device="cpu")

    def tok(*s):
        return torch.randint(0, cfg.vocab_size, s, generator=g,
                             dtype=torch.int32)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return M.make_decode_step(cfg), [
            params, T.init_caches(None, cfg, B, S, device="cpu"),
            tok(B, 1), torch.tensor(5, dtype=torch.int32)]
    batch = {"tokens": tok(B, S), "labels": tok(B, S)}
    if shape.kind == "train":
        return M.make_train_step(cfg), [params, adamw.init(params), batch]
    return M.make_prefill(cfg), [params, batch]


def _group_mesh(model):
    return D.ServingMesh(np.empty((1, model), dtype=object))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("aid", ["yi-9b", "mamba2-370m"])
def test_trace_flops_equal_a_real_run(aid, kind):
    cfg = get_arch(aid).reduced()
    shape = M.ShapeSpec("t", 64, 2, kind)
    trace = D.trace_step(cfg, shape, _group_mesh(1))
    step, args = _real_inputs(cfg, shape)
    with FlopCounterMode(display=False) as fc:
        step(*args)
    assert trace.counter.flops == [fc.get_total_flops()]
    assert trace.counter.flops[0] > 0 and trace.counter.hbm_bytes[0] > 0
    assert trace.counter.coll == [Counter()]
    # at (1, 1) the arguments are the whole params (and state, caches)
    assert trace.args_bytes == [sum(CA.nbytes(t) for t in
                                    adamw.tree_leaves(args))]


def test_trace_prices_ssd_chunk_as_its_kernel():
    """Mamba2's intra-chunk scan runs through kernels/ssd_scan.py's
    operators: on fake tensors they give the real CPU run's output and
    gradient shapes and dtypes, and the counter prices them as the card's
    kernels, at ``chunk_flops`` / ``chunk_bwd_flops`` and the forward's
    inputs read once and outputs written once (B and C per batch row)."""
    bh, heads, s, p, n, q = 8, 4, 64, 16, 8, 16
    shapes = [(bh, s, p), (bh, s), (bh,), (bh // heads, s, n),
              (bh // heads, s, n)]
    g = torch.Generator().manual_seed(0)
    real = [torch.rand(sh, generator=g, requires_grad=True) for sh in shapes]
    y, st = kops.ssd_intra_chunk(*real, q)
    (y.sum() + st.sum()).backward()
    fwd = kssd.chunk_flops(bh, s, p, n, q)
    with FakeTensorMode():
        fake = [torch.empty(sh, requires_grad=True) for sh in shapes]
        c = CA.CostCounter(["cpu"])
        with c, torch.no_grad():
            fy, fst = kops.ssd_intra_chunk(*fake, q)
        assert c.flops == [fwd]
        assert c.hbm_bytes == [sum(map(CA.nbytes, fake + [fy, fst]))]
        c = CA.CostCounter(["cpu"])
        with c:
            fy, fst = kops.ssd_intra_chunk(*fake, q)
            (fy.sum() + fst.sum()).backward()
        assert c.flops == [fwd + kssd.chunk_bwd_flops(bh, s, p, n, q)]
        for a, b in zip([fy, fst] + [t.grad for t in fake],
                        [y, st] + [t.grad for t in real]):
            assert (a.shape, a.dtype) == (b.shape, b.dtype)


def test_trace_tp2_decode_collectives_by_hand():
    """A reduced yi-9b decode step at tp = 2 (2 layers, d 128, vocab 512,
    heads and KV heads split whole): the embedding's sum and each layer's
    attention and FFN row sums are all-reduces of [B, 1, d] fp32, the
    logits one all-gather of [B, 1, V] fp32, on each of the two devices;
    the positions handed to shard 1 are free, and nothing else crosses."""
    cfg = get_arch("yi-9b").reduced()
    B, L, d, V = 2, cfg.num_layers, cfg.d_model, cfg.padded_vocab
    trace = D.trace_step(cfg, M.ShapeSpec("t", 64, B, "decode"),
                         _group_mesh(2))
    c = trace.counter
    want = {"all-reduce": (1 + 2 * L) * B * d * 4, "all-gather": B * V * 4}
    assert [dict(x) for x in c.coll] == [want, want]
    assert c.flops[0] >= c.flops[1] > 0
    assert c.peak[0] > 0 and c.peak[1] > 0
    assert trace.args_bytes[0] > trace.args_bytes[1] > 0


def test_trace_tp2_fsdp_moe_decode_prices_the_captured_form():
    """olmoe's experts split over two shards (``"fsdp"``): the eager
    decode reads the routing back to pick each shard's entries, which
    fake tensors cannot trace; the trace prices the captured form, every
    entry on each shard, and shard 1's rows come back to shard 0 as a
    point-to-point transfer of [B * K, d] fp32 a layer."""
    cfg = get_arch("olmoe-1b-7b").reduced()
    B, L, d, K = 2, cfg.num_layers, cfg.d_model, cfg.experts_per_token
    trace = D.trace_step(cfg, M.ShapeSpec("t", 64, B, "decode"),
                         _group_mesh(2))
    assert trace.counter.coll[0]["collective-permute"] == L * B * K * d * 4
    assert D._priced(cfg, M.SHAPES["decode_32k"], 2)["moe_decode"]
    assert not tp.capturing()


def test_trace_tp2_train_step_updates_every_piece():
    cfg = get_arch("yi-9b").reduced()
    trace = D.trace_step(cfg, M.ShapeSpec("t", 32, 2, "train"),
                         _group_mesh(2))
    c = trace.counter
    # the backward adds the all-reduce of every broadcast input's gradient
    fwd = D.trace_step(cfg, M.ShapeSpec("t", 32, 2, "prefill"),
                       _group_mesh(2)).counter
    assert c.coll[0]["all-reduce"] > 2 * fwd.coll[0]["all-reduce"]
    assert trace.output_bytes[1] > 0      # shard 1's new pieces and state


def test_adamw_updates_split_leaves_piece_by_piece():
    cfg = get_arch("yi-9b").reduced()
    params = M.init_params(cfg, device="cpu")
    group = make_serving_mesh(1, tp=2, devices=["cpu"] * 2)
    split = tp.shard_params(params, group)
    g = torch.Generator().manual_seed(1)
    grads = adamw.tree_map(lambda p: torch.randn(p.shape, generator=g),
                           params)
    sgrads = tp.shard_params(grads, group)
    cfg_opt = adamw.AdamWConfig()
    want, wstate, _ = adamw.update(cfg_opt, grads, adamw.init(params),
                                   params)
    got, gstate, _ = adamw.update(cfg_opt, sgrads, adamw.init(split), split)

    def whole(x):
        return torch.cat(x.pieces, x.dim) if tp.is_sharded(x) else x
    for a, b in zip(tp.leaves(want), [whole(x) for x in tp.leaves(got)]):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    assert len(adamw.tree_leaves(gstate.m)) > len(adamw.tree_leaves(
        wstate.m))


# ---------------------------------------------------------- roofline --
def test_roofline_terms_and_dominant():
    """tests/test_launch.py:42-56 at the card's constants."""
    hw = CA.hardware("cpu")
    r = CA.Roofline(flops=hw["peak_flops"], hbm_bytes=hw["hbm_bw"],
                    coll_bytes=0.0, coll_breakdown={})
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(1.0)
    assert r.dominant in ("compute", "memory")
    r2 = CA.Roofline(flops=1.0, hbm_bytes=1.0, coll_bytes=200e9,
                     coll_breakdown={})
    assert r2.dominant == "collective"
    assert r2.collective_s == pytest.approx(200e9 / 450e9)
    assert r2.bound_s == r2.collective_s
    assert set(r2.to_dict()) == {"flops", "hbm_bytes", "coll_bytes",
                                 "coll_breakdown", "compute_s", "memory_s",
                                 "collective_s", "dominant"}


def test_hardware_reads_the_card(monkeypatch):
    hw = CA.hardware("cpu")
    assert (hw["name"], hw["peak_flops"], hw["hbm_bw"], hw["ici_bw"]) == \
        ("NVIDIA H100 80GB HBM3", 989e12, 3.35e12, 450e9)
    assert hw["total_memory"] is None and hw["sm_count"] is None

    class Props:
        name = "NVIDIA H100 80GB HBM3"
        total_memory = 85_000_000_000
        multi_processor_count = 132
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: Props)
    hw = CA.hardware("cuda")
    assert (hw["total_memory"], hw["sm_count"]) == (85_000_000_000, 132)
    Props.name = "NVIDIA A100-SXM4-40GB"
    with pytest.raises(KeyError, match="A100"):
        CA.hardware("cuda")


def test_main_whisper_decode_multi_pod(tmp_path, monkeypatch):
    """The CLI at full width: its trace allocates nothing (device 0's
    caches alone are 805 MB; the process grows by far less)."""
    import resource
    monkeypatch.setattr(D, "REPORT_DIR", tmp_path)
    out = io.StringIO()
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    with contextlib.redirect_stdout(out):
        rc = D.main(["--arch", "whisper-tiny", "--shape", "decode_32k",
                     "--multi-pod", "--roofline", "--device", "cpu"])
    grown = (resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - rss) * 1024
    assert rc == 0 and "1 cells, 0 failures" in out.getvalue()
    rep = json.loads((tmp_path / "whisper-tiny__decode_32k__2x16x16.json")
                     .read_text())
    assert rep["status"] == "ok" and "roofline" not in rep
    assert rep["argument_size_in_bytes"] == 110_436_884
    assert rep["group"] == [1, 16] and rep["local_batch"] == 4
    assert rep["output_size_in_bytes"] > 800e6 > 4 * grown
    assert rep["temp_size_in_bytes"] > 0
    assert rep["hardware"]["name"] == "NVIDIA H100 80GB HBM3"


def test_lower_cell_roofline_and_skip():
    rep = D.lower_cell("whisper-tiny", "decode_32k", roofline=True,
                       device="cpu", verbose=False)
    rf = rep["roofline"]
    assert rf["dominant"] == "memory" and rf["busiest_device"] == 0
    assert rf["model_flops"] == D._model_flops_per_chip(
        get_arch("whisper-tiny"), M.SHAPES["decode_32k"], 256)
    assert 0 < rf["useful_ratio"] < 1
    assert rf["coll_bytes"] == sum(rf["coll_breakdown"].values())
    skip = D.lower_cell("yi-9b", "long_500k", device="cpu")
    assert skip["status"] == "skip" and "sub-quadratic" in skip["reason"]
    assert PS._MOE_MODE == "fsdp" and T._REMAT_POLICY == "full"
