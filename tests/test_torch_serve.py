"""The port's MultiTenantServer against the JAX package's.

Two reduced yi-9b tenants: one resident, one arriving mid-run with a
192-token prompt and a 16-step budget, in a page pool tight enough that
the grants switch between LBM and LWM.  The same with olmoe-1b-7b (an
MoE tenant alone, with int8 and ``auto`` KV), and the reference CLI's
default pool, yi-9b, olmoe-1b-7b and mamba2-370m.  The port is handed
the reference's params (through ``repro_torch.bridge``) and prompt
tokens.  No QoS targets: slack reads the wall clock.

The scheduling side is a copy of the reference's, so its trace must be
exactly equal: per-tenant choices, ``KernelPlan.describe()`` sequences,
prefill chunk lengths, KV reservations and the NEC counters.  The token
streams must be equal too, and the port's serial and pipelined loops
bit-identical.  At full width, grants lower at the reference's width
(the experts' d_ff for olmoe), and the server's CLI prints the
reference's lines.
"""
import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from repro.core.allocator import Selection as RSelection
from repro.core.runtime import TenantModel as RTenantModel
from repro.launch import serve as RS
from repro.models import model as RM
from repro.models.base import get_arch as ref_arch
from repro.sim.driver import TenantSpec as RSpec
from repro_torch.bridge import params_from_numpy
from repro_torch.core.allocator import Selection as PSelection
from repro_torch.core.vmem import LANE, fused_ffn_pages
from repro_torch.launch import serve as PS
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models.base import get_arch as port_arch
from repro_torch.sim.driver import TenantSpec as PSpec

PAGES = 32
STEPS = 24
SERVER = dict(batch=1, max_len=256, epoch_len=4, total_pages=PAGES)
ARRIVAL = dict(arrive_at=4.0, prompt_len=192, n_inferences=16)


def _ref_cfg(cfg):
    return ref_arch(cfg.name.removesuffix("-smoke")).reduced()


_REF_PARAMS = {}


def _ref_params(cfg, pkey):
    key = (cfg.name, pkey)
    if key not in _REF_PARAMS:
        tree = RM.init_params(_ref_cfg(cfg), jax.random.PRNGKey(pkey))
        _REF_PARAMS[key] = jax.tree_util.tree_map(np.asarray, tree)
    return params_from_numpy(_REF_PARAMS[key], cfg, "cpu")


def _ref_prompt(spec, i, cfg, batch):
    return RS._prompt_tokens(RSpec(spec.model, prompt_len=spec.prompt_len), i,
                             _ref_cfg(cfg), batch)


def _port(**kw):
    return PS.MultiTenantServer(["yi-9b"], tenants=[PSpec("yi-9b", **ARRIVAL)],
                                device="cpu", params_fn=_ref_params,
                                prompt_fn=_ref_prompt, **SERVER, **kw)


@pytest.fixture(scope="module")
def runs():
    ref = RS.MultiTenantServer(["yi-9b"], tenants=[RSpec("yi-9b", **ARRIVAL)],
                               **SERVER)
    port, serial = _port(), _port(pipeline=False)
    return ((ref, ref.run(steps=STEPS)), (port, port.run(steps=STEPS)),
            (serial, serial.run(steps=STEPS)))


def test_grant_plan_and_nec_trace_equal_reference(runs):
    (ref, ref_out), (port, port_out), _ = runs
    assert [t.tid for t in ref.tenants] == [t.tid for t in port.tenants]
    kinds = set()
    for r, p in zip(ref.tenants, port.tenants):
        assert p.choices == r.choices
        assert ([x.describe() for x in p.plans]
                == [x.describe() for x in r.plans])
        assert p.chunks == r.chunks
        assert (p.kv_wanted, p.kv_reserved) == (r.kv_wanted, r.kv_reserved)
        kinds |= {x.kind for x in p.plans}
    assert kinds == {"LBM", "LWM"}
    assert (dataclasses.astuple(port.nec.traffic)
            == dataclasses.astuple(ref.nec.traffic))
    assert ({k: dataclasses.astuple(v)
             for k, v in port.nec.ledger.per_tenant.items()}
            == {k: dataclasses.astuple(v)
                for k, v in ref.nec.ledger.per_tenant.items()})
    assert port_out["dram_bytes"] == ref_out["dram_bytes"] > 0
    assert port.cache.free_pages == ref.cache.free_pages


def test_result_keeps_reference_keys_and_values(runs):
    (_, ref_out), (_, port_out), _ = runs
    assert port_out["mode"] == ref_out["mode"] == "pipelined"
    for tid, r in ref_out["tenants"].items():
        p = port_out["tenants"][tid]
        for key in ("tokens", "choices", "prefill_chunks", "lbm_frac"):
            assert p[key] == r[key], key
        assert (p["ttft_s"] is None) == (r["ttft_s"] is None)


def test_token_streams_equal_reference(runs):
    (_, ref_out), (_, port_out), _ = runs
    for tid, r in ref_out["tenants"].items():
        np.testing.assert_array_equal(port_out["tenants"][tid]["output"],
                                      r["output"], err_msg=tid)
    assert port_out["tenants"]["t1:yi-9b"]["output"].shape == (1, 17)


def test_port_serial_and_pipelined_bit_identical(runs):
    """Mirrors test_serve_pipeline.py::
    test_pipelined_outputs_bit_identical_to_serial."""
    _, (_, pipe_out), (_, serial_out) = runs
    assert serial_out["mode"] == "serial"
    for tid, p in pipe_out["tenants"].items():
        s = serial_out["tenants"][tid]
        np.testing.assert_array_equal(s["output"], p["output"], err_msg=tid)
        assert s["tokens"] == p["tokens"]


@pytest.mark.parametrize("option", [dict(device=make_serving_mesh(
    2, tp=1, devices=["cpu"] * 2))])
def test_unported_server_features_raise(option):
    """A replica of more than one device (tp > 1) is served now
    (tests/test_torch_tp.py); a server handed more than one replica row
    of a mesh raises."""
    group = make_serving_mesh(1, tp=2, devices=["cpu"] * 2)
    assert PS.MultiTenantServer(["yi-9b"], device=group).mesh is group
    with pytest.raises(ValueError, match="one mesh row"):
        PS.MultiTenantServer(["yi-9b"], **{"device": "cpu", **option})


def test_unported_families_raise():
    """Every family is served now (tests/test_torch_encdec_serve.py), and
    the fleet too (tests/test_torch_fleet.py), tensor-parallel groups
    included (tests/test_torch_tp_fleet.py); a family outside the
    ported ones raises."""
    fleet = PS.FleetServer(n_replicas=2, tp=2, devices=["cpu"] * 4)
    assert fleet.tp == 2 and len(fleet.replicas) == 2
    from repro_torch.models import transformer as PT
    odd = dataclasses.replace(port_arch("yi-9b").reduced(), family="audio")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        PT.init_lm(torch.Generator().manual_seed(0), odd)


def _candidates(tm):
    return [[(c.kind, c.p_need, c.dram_bytes, c.usage_limit_bytes)
             for c in mct.lwms + ([mct.lbm] if mct.lbm is not None else [])]
            for mct in tm.mapping.mcts]


@pytest.mark.parametrize("arch", ["yi-9b", "granite-3-8b"])
@pytest.mark.parametrize("seq_block", [2, 256, 1024])
@pytest.mark.parametrize("pages", [64, 1800])
def test_full_width_mapping_equals_reference(arch, seq_block, pages):
    """At full width the port's server maps a tenant's FFN graph as the
    reference's server does (``TenantModel`` with the default
    ``LbmConfig``): the same candidates per layer (kind, p_need, DRAM
    bytes, usage limit) and the same LBM blocks, for the decode graph
    (seq_block = batch) and prompt graphs.  Under the reference's 2 ms
    block cap a full-width FFN block gets no LBM candidate."""
    rcfg, pcfg = ref_arch(arch), port_arch(arch)
    assert rcfg.num_layers == pcfg.num_layers > 4          # full width
    ref = RTenantModel(RS._ffn_graph(arch, rcfg, seq_block),
                       RS._vmem_mapper(pages))
    port = PS._tenant_model(PS._ffn_graph(arch, pcfg, seq_block),
                            PS._vmem_mapper(pages))
    assert _candidates(port) == _candidates(ref)
    assert port.mapping.blocks == ref.mapping.blocks
    assert port.layer_t_est == ref.layer_t_est
    assert {k for layer in _candidates(port) for k, *_ in layer} == {"LWM"}


# ------------------------------------------------------------ MoE --
def _pair(arch_ids, tenants, steps=STEPS, serial=True, **kw):
    """(reference, port, port serial) servers with their runs on one
    scenario: ``tenants`` is a list of (arch, TenantSpec kwargs)."""
    server = {**SERVER, **kw}
    ref = RS.MultiTenantServer(
        arch_ids, tenants=[RSpec(a, **t) for a, t in tenants], **server)

    def port(**extra):
        return PS.MultiTenantServer(
            arch_ids, tenants=[PSpec(a, **t) for a, t in tenants],
            device="cpu", params_fn=_ref_params, prompt_fn=_ref_prompt,
            **server, **extra)
    runs = [(ref, ref.run(steps=steps))]
    for extra in ({}, {"pipeline": False})[:2 if serial else 1]:
        srv = port(**extra)
        runs.append((srv, srv.run(steps=steps)))
    return runs


def _assert_same_trace(ref, ref_out, port, port_out):
    assert [t.tid for t in ref.tenants] == [t.tid for t in port.tenants]
    for r, p in zip(ref.tenants, port.tenants):
        assert p.choices == r.choices, p.tid
        assert ([(x.describe(), x.ssm_chunk) for x in p.plans]
                == [(x.describe(), x.ssm_chunk) for x in r.plans]), p.tid
        assert p.chunks == r.chunks, p.tid
        assert (p.kv_dtype, p.kv_wanted, p.kv_reserved) == \
            (r.kv_dtype, r.kv_wanted, r.kv_reserved), p.tid
        rr, pr = ref_out["tenants"][r.tid], port_out["tenants"][p.tid]
        for key in ("tokens", "choices", "prefill_chunks", "lbm_frac",
                    "kv_dtype", "prefill_computed", "departed", "state"):
            assert pr[key] == rr[key], (p.tid, key)
        np.testing.assert_array_equal(pr["output"], rr["output"],
                                      err_msg=p.tid)
        ps = sorted(port.cache.page_scales_of(p.tid + "#kv").items())
        rs = sorted(ref.cache.page_scales_of(r.tid + "#kv").items())
        assert [k for k, _ in ps] == [k for k, _ in rs], p.tid
        np.testing.assert_allclose([v for _, v in ps], [v for _, v in rs],
                                   rtol=1e-5, atol=0)
    assert port_out["dram_bytes"] == ref_out["dram_bytes"] > 0
    assert (dataclasses.astuple(port.nec.traffic)
            == dataclasses.astuple(ref.nec.traffic))
    assert ({k: dataclasses.astuple(v)
             for k, v in port.nec.ledger.per_tenant.items()}
            == {k: dataclasses.astuple(v)
                for k, v in ref.nec.ledger.per_tenant.items()})
    assert port.cache.free_pages == ref.cache.free_pages


def _assert_serial_equals_pipelined(pipe_out, serial_out):
    assert serial_out["mode"] == "serial"
    for tid, p in pipe_out["tenants"].items():
        s = serial_out["tenants"][tid]
        np.testing.assert_array_equal(s["output"], p["output"], err_msg=tid)
        assert s["tokens"] == p["tokens"]


MOE = "olmoe-1b-7b"
MIX = ["yi-9b", MOE, "mamba2-370m"]


@pytest.fixture(scope="module")
def moe_runs():
    return _pair([MOE], [(MOE, ARRIVAL)])


@pytest.fixture(scope="module")
def mix_runs():
    return _pair(MIX, [(MOE, dict(arrive_at=4.0, prompt_len=160,
                                  n_inferences=8)),
                       ("mamba2-370m", dict(arrive_at=8.0, prompt_len=96,
                                            n_inferences=8))],
                 serial=False, total_pages=64)


def test_moe_server_equals_reference(moe_runs):
    """An olmoe resident and an olmoe arrival: grants, plans, chunks,
    reservations, NEC counters and token streams equal the reference's.
    The decode plan binds nothing (``_dec_plan``), and the prompt chunks
    run on the LANE grid."""
    (ref, ref_out), (port, port_out), _ = moe_runs
    _assert_same_trace(ref, ref_out, port, port_out)
    resident, arrival = port.tenants
    assert resident.cfg.family == "moe"
    assert all(port._dec_plan(t, t.plans[-1]) is None for t in port.tenants)
    assert sum(arrival.chunks) == ARRIVAL["prompt_len"]
    assert all(c % LANE == 0 for c in arrival.chunks[:-1])
    assert {x.kind for t in port.tenants for x in t.plans} == {"LBM", "LWM"}
    assert port_out["tenants"][arrival.tid]["output"].shape == (1, 17)
    assert port_out["tenants"][resident.tid]["output"].shape == (1, STEPS)


def test_moe_server_serial_and_pipelined_bit_identical(moe_runs):
    _, (_, pipe_out), (_, serial_out) = moe_runs
    _assert_serial_equals_pipelined(pipe_out, serial_out)


def test_cli_default_pool_equals_reference(mix_runs):
    """The reference CLI's default archs (yi-9b, olmoe-1b-7b,
    mamba2-370m) as residents, with an olmoe and a mamba2 arrival: the
    same trace and tokens in one pool."""
    (ref, ref_out), (port, port_out) = mix_runs
    _assert_same_trace(ref, ref_out, port, port_out)
    assert {t.cfg.family for t in port.tenants} == {"dense", "moe", "ssm"}
    for t in port.tenants:
        assert t.tokens_served > 0, t.tid


@pytest.mark.parametrize("kv_dtype", ["int8", "auto"])
def test_moe_server_quantized_kv_equals_reference(kv_dtype):
    """An MoE tenant's KV is a dense tenant's: a pinned int8 server, and
    the ``auto`` ladder in a pool of one native plus one fp8 reservation
    plus 2 pages, where three 256-token arrivals land on native, a narrow
    rung and int8, as in the reference (page scales too)."""
    cfg = port_arch(MOE).reduced()
    if kv_dtype == "int8":
        runs = _pair([MOE], [(MOE, ARRIVAL)], kv_dtype="int8")
    else:
        pool = (PS._kv_reserve_pages(cfg, 1, 256)
                + PS._kv_reserve_pages(cfg, 1, 256, "fp8_e4m3") + 2)
        spec = dict(prompt_len=256, n_inferences=4, param_seed=5)
        runs = _pair([], [(MOE, spec)] * 3, steps=12, kv_dtype="auto",
                     max_len=512, total_pages=pool, steps_per_s=4.0)
    (ref, ref_out), (port, port_out), (_, serial_out) = runs
    _assert_same_trace(ref, ref_out, port, port_out)
    _assert_serial_equals_pipelined(port_out, serial_out)
    got = [t.kv_dtype for t in port.tenants]
    if kv_dtype == "int8":
        assert got == ["native", "int8"]
    else:
        assert got[0] == "native" and got[1] in ("fp8_e4m3", "int8")
        assert got[2] == "int8"
    for t in port.tenants:
        tags = {p.describe().partition("+kv:")[2] or "native"
                for p in t.plans}
        assert tags == {t.kv_dtype}, t.tid


# -------------------------------------------- lowering width (repair) --
def _lbm_needs(tm):
    return [m.lbm.p_need if m.lbm is not None else None
            for m in tm.mapping.mcts]


def _ffn_fields(plan):
    f = plan.ffn
    tile = lambda t: dataclasses.astuple(t) if t is not None else None  # noqa: E731
    return (plan.describe(), plan.kind, f.fused, f.block_s, f.block_f,
            tile(f.up_tile), tile(f.down_tile), f.vmem_bytes, plan.ssm_chunk)


GRANTS = (192, 1024)        # pages beyond the candidates' own quotes


def _lowered(srv, cfg, cands, block, Selection):
    """``srv._lower_plan`` of a two-layer block granted each candidate, at
    its own quote and at :data:`GRANTS`."""
    tenant = types.SimpleNamespace(cfg=cfg, kv_dtype="native")
    out = []
    for c in cands:
        for pages in (max(c.p_need, 1),) + GRANTS:
            out.append(_ffn_fields(srv._lower_plan(
                tenant, [(Selection(c, pages, 0.0), pages)] * 2,
                seq_block=block)))
    return out


def _cands(tm):
    return [c for m in tm.mapping.mcts
            for c in m.lwms + ([m.lbm] if m.lbm is not None else [])]


@pytest.mark.parametrize("seq_block", [2, 256])
@pytest.mark.parametrize("arch", [MOE, "yi-9b", "mamba2-370m"])
def test_full_width_lowering_width_equals_reference(arch, seq_block):
    """At full width the server lowers every grant, and quotes every LBM
    working set, at the reference's width: ``cfg.d_ff`` (olmoe's experts:
    1024 at d_model 2048), not the scheduling graph's max(d_ff, d_model).
    Each candidate of the tenant's mapped FFN graph, granted its quote and
    larger grants, is lowered by ``_lower_plan`` and held against the
    reference server's (``describe()`` and the FfnPlan fields); the LBM
    ``p_need`` from ``_align_lbm_to_vmem`` likewise.  Lowered at the
    graph's width, olmoe's plans differ at the larger grants (the fault
    this pins; at the candidates' own quotes the two widths agree).
    yi-9b (d_ff > d_model) is unchanged; mamba2 (d_ff = 0) keeps d_model,
    where the reference divides by zero."""
    pcfg, rcfg = port_arch(arch), ref_arch(arch)
    assert pcfg.num_layers == rcfg.num_layers > 4          # full width
    pages, eb = 4096, 2
    block = max(seq_block, LANE)
    port = PS.MultiTenantServer([], device="cpu", batch=2, total_pages=pages,
                                reduced=False)
    ptm = PS._tenant_model(PS._ffn_graph(arch, pcfg, seq_block),
                           PS._vmem_mapper(pages))
    port._align_lbm_to_vmem(ptm, pcfg, block)
    width = pcfg.d_ff or pcfg.d_model
    assert _lbm_needs(ptm) == [
        fused_ffn_pages(block, pcfg.d_model, width, eb) if m.lbm else None
        for m in ptm.mapping.mcts]
    got = _lowered(port, pcfg, _cands(ptm), block, PSelection)
    if pcfg.d_ff > 0:
        ref = RS.MultiTenantServer([], batch=2, total_pages=pages)
        rtm = RTenantModel(RS._ffn_graph(arch, rcfg, seq_block),
                           RS._vmem_mapper(pages))
        ref._align_lbm_to_vmem(rtm, rcfg, block)
        assert _lbm_needs(ptm) == _lbm_needs(rtm)
        assert got == _lowered(ref, rcfg, _cands(rtm), block, RSelection)
    else:
        # the kept deviation: mamba2's grants lower at d_model
        assert _lbm_needs(ptm)[0] is not None
        stale = dataclasses.replace(pcfg, d_ff=pcfg.d_model)
        assert got == _lowered(port, stale, _cands(ptm), block, PSelection)
    graph_width = dataclasses.replace(pcfg, d_ff=PS._ffn_width(pcfg))
    stale = _lowered(port, graph_width, _cands(ptm), block, PSelection)
    if arch == MOE:
        assert PS._ffn_width(pcfg) == 2048 != pcfg.d_ff == 1024
        assert stale != got
        quotes = len(GRANTS) + 1
        assert stale[::quotes] == got[::quotes]
    else:
        assert stale == got


# ------------------------------------------------------------- CLI --
def test_cli_prints_reference_lines(capsys):
    """``python -m repro_torch.launch.serve`` on the CPU with the default
    (reduced) archs, a few steps and one arrival: the reference's
    ``[serve]`` lines, one per tenant, then the totals and host lines."""
    out = PS.main(["--device", "cpu", "--steps", "8", "--arrivals", "1",
                   "--prompt-len", "64", "--decode-budget", "4",
                   "--epoch-len", "4"])
    lines = capsys.readouterr().out.splitlines()
    tids = list(out["tenants"])
    assert len(tids) == 4 and {t.split(":")[1] for t in tids} == set(MIX)
    for tid, ln in zip(tids, lines):
        assert ln.startswith(f"[serve] {tid}: ") and " tokens, LBM " in ln
        assert "plans [" in ln
    arrival = next(ln for ln in lines if ln.startswith(f"[serve] {tids[-1]}"))
    assert "TTFT" in arrival and ", kv " in arrival
    assert lines[len(tids)].startswith("[serve] pipelined/interleaved (K=4): ")
    assert "tok/s total, 64 prompt tokens, p95 TTFT" in lines[len(tids)]
    assert lines[len(tids) + 1].startswith("[serve] host: sched ")
    assert "aot 0 compiled (0 hits)" in lines[len(tids) + 1]
    assert len(lines) == len(tids) + 2


@pytest.mark.parametrize("argv", [["--devices", "2"]])
def test_cli_unported_flags_raise(argv):
    """The one flag the CLI refused, ``--devices``, serves a fleet now
    (tests/test_torch_fleet.py); what stays unported, tensor-parallel
    replica groups, has no flag: the CLI's fleet is an (N, 1) mesh."""
    out = PS.main(["--device", "cpu", "--steps", "1"] + argv)
    assert (out["mode"], out["n_replicas"], out["tp"]) == ("fleet", 2, 1)
