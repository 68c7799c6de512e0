"""Preemption, fault injection and overload admission in the port's
server against the JAX package's.

Mirrors the single-server tests of tests/test_faults.py (not the fleet
ones) at the reduced configs (fp32), the reference's params and prompts
injected (``params_fn`` / ``prompt_fn``), and runs each scenario through
both servers: token streams, per-tenant counters, the ``overload``
result and the fault log must be equal, the log's records with their
wall-time fields (``recovery_s``, ``waited_s``) taken out.  In the port,
a preempted-then-resumed tenant decodes bit for bit as an unfaulted run
of the same server, on mamba2 (the reference's arch), on yi-9b with
native KV and on yi-9b with int8 KV (codes and fp32 scales through the
checkpoint).

Also held against the reference: the checkpoint round trip (exact bytes
for fp32, bf16, fp8, int8 and int64 leaves in nested trees, as
tests/test_fault_tolerance.py::test_checkpoint_roundtrip_is_exact),
``StragglerPolicy``, ``FaultPlan``, ``FaultLog`` and ``BackoffPolicy`` on
the same inputs.
"""
import dataclasses
import json
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as rckpt
from repro.distributed.fault_tolerance import StragglerPolicy as RStraggler
from repro.launch import serve as RS
from repro.models import model as RM
from repro.models.base import get_arch as ref_arch
from repro.sim import driver as RD
from repro.sim import faults as RF
from repro_torch.bridge import params_from_numpy, tensor_from_numpy
from repro_torch.checkpoint import checkpoint as pckpt
from repro_torch.core.policy import QosPreemptionPolicy
from repro_torch.core.runtime import (STATE_PREEMPTED, STATE_RESUMED,
                                      STATE_SHED)
from repro_torch.distributed.fault_tolerance import StragglerPolicy
from repro_torch.launch import serve as PS
from repro_torch.sim import driver as PD
from repro_torch.sim import faults as PF

ARCH = "mamba2-370m"
WALL = ("recovery_s", "waited_s")
_REF_PARAMS = {}


def _ref_cfg(cfg):
    return ref_arch(cfg.name.removesuffix("-smoke")).reduced()


def _ref_params(cfg, pkey):
    key = (cfg.name, pkey)
    if key not in _REF_PARAMS:
        tree = RM.init_params(_ref_cfg(cfg), jax.random.PRNGKey(pkey))
        _REF_PARAMS[key] = jax.tree_util.tree_map(np.asarray, tree)
    return params_from_numpy(_REF_PARAMS[key], cfg, "cpu")


def _ref_prompt(spec, i, cfg, batch):
    rspec = RD.TenantSpec(spec.model, prompt_len=spec.prompt_len,
                          prompt_seed=spec.prompt_seed,
                          prefix_len=spec.prefix_len,
                          prefix_seed=spec.prefix_seed)
    return RS._prompt_tokens(rspec, i, _ref_cfg(cfg), batch)


def _srv(pkg, **kw):
    """The reference's ``_srv`` of tests/test_faults.py, in either
    package (``pkg``: "ref" or "port")."""
    kw.setdefault("total_pages", 64)
    kw.setdefault("epoch_len", 4)
    kw.setdefault("pipeline", True)
    kw.setdefault("max_len", 128)
    if pkg == "ref":
        return RS.MultiTenantServer([], **kw)
    return PS.MultiTenantServer([], device="cpu", params_fn=_ref_params,
                                prompt_fn=_ref_prompt, **kw)


def _pkg(pkg):
    """(TenantSpec, FaultEvent, FaultPlan) of a package."""
    if pkg == "ref":
        return RD.TenantSpec, RF.FaultEvent, RF.FaultPlan
    return PD.TenantSpec, PF.FaultEvent, PF.FaultPlan


def _outputs(res):
    return {tid: info["output"] for tid, info in res["tenants"].items()}


def _log(res):
    return [{k: v for k, v in rec.items() if k not in WALL}
            for rec in res["faults"]["log"]]


def _shed(res):
    return [{k: v for k, v in rec.items() if k not in WALL}
            for rec in res["overload"]["shed"]]


def _same_tokens(a, b):
    assert set(a) == set(b)
    for tid in a:
        np.testing.assert_array_equal(a[tid], b[tid], err_msg=tid)


def _equal_runs(ref, port):
    """The port's run equals the reference's: tokens, counters, the last
    grants and plans, the NEC's modeled DRAM bytes (which every grant
    charges), fault log (wall times out) and overload result."""
    _same_tokens(_outputs(port), _outputs(ref))
    assert port["dram_bytes"] == ref["dram_bytes"]
    for tid, r in ref["tenants"].items():
        p = port["tenants"][tid]
        for key in ("tokens", "state", "preemptions", "prefill_chunks",
                    "kv_reserved", "kv_wanted", "prefix_hit", "choices",
                    "plans"):
            assert p[key] == r[key], (tid, key)
        assert len(p["recovery_s"]) == len(r["recovery_s"])
    assert _log(port) == _log(ref)
    assert port["faults"]["counts"] == ref["faults"]["counts"]
    assert port["faults"]["preemptions"] == ref["faults"]["preemptions"]
    assert _shed(port) == _shed(ref)
    for key in ("deferrals", "shed_count", "queued"):
        assert port["overload"][key] == ref["overload"][key], key


# ---------------------------------------------- victim selection --
def test_qos_policy_prefers_loosest_then_largest_holding():
    p = QosPreemptionPolicy()
    assert p.select([("a", 0.05, 9, 0), ("b", None, 1, 0)]) == "b"
    assert p.select([("a", 0.05, 1, 0), ("c", 0.40, 1, 0)]) == "c"
    assert p.select([("a", 0.05, 2, 0), ("c", 0.05, 7, 0)]) == "c"
    assert p.select([]) is None


# ------------------------------------------ preempt -> resume --
PREEMPT_CASES = [(ARCH, "native"), ("yi-9b", "native"), ("yi-9b", "int8")]


def _preempt_run(pkg, arch, kv, faulted, **kw):
    Spec, Event, Plan = _pkg(pkg)
    plan = (Plan([Event(step=8, kind="preempt", hold_epochs=2)])
            if faulted else None)
    srv = _srv(pkg, faults=plan, kv_dtype=kv, **kw)
    srv.enqueue([Spec(arch, prompt_len=32, n_inferences=24)])
    return srv, srv.run(steps=24)


@pytest.fixture(scope="module", params=PREEMPT_CASES,
                ids=["mamba2", "yi", "yi-int8"])
def preempted(request, tmp_path_factory):
    arch, kv = request.param
    ckpt_dir = str(tmp_path_factory.mktemp("preempt"))
    return {"ref": _preempt_run("ref", arch, kv, True)[1],
            "port_ref": _preempt_run("port", arch, kv, False)[1],
            "port": _preempt_run("port", arch, kv, True,
                                 ckpt_dir=ckpt_dir)}


def test_preempt_resume_is_bit_identical(preempted):
    """test_faults.py::test_preempt_resume_is_bit_identical on the port:
    the resumed stream equals an unfaulted run of the same server."""
    srv, r = preempted["port"]
    assert r["faults"]["preemptions"] == 1
    assert [rec["kind"] for rec in r["faults"]["log"]] == ["preempt",
                                                           "resume"]
    assert r["faults"]["log"][0]["mode"] == "snapshot"
    assert r["faults"]["recovery_s"] and r["faults"]["recovery_s"][0] > 0
    assert r["faults"]["checkpoint_bytes"] > 0
    (tid, a), = _outputs(preempted["port_ref"]).items()
    b = _outputs(r)[tid]
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)
    info = r["tenants"][tid]
    assert info["state"] == STATE_RESUMED
    assert info["preemptions"] == 1
    assert r["host"]["preempt_evictions"] >= 1


def test_preempt_resume_equals_reference(preempted):
    _equal_runs(preempted["ref"], preempted["port"][1])


def test_preempt_resume_serial_loop():
    """The serial (eager) loop preempts and resumes at the same logical
    steps and decodes the same stream as the pipelined one."""
    _, pipe = _preempt_run("port", ARCH, "native", True)
    _, serial = _preempt_run("port", ARCH, "native", True, pipeline=False)
    _, ref = _preempt_run("ref", ARCH, "native", True, pipeline=False)
    _same_tokens(_outputs(serial), _outputs(pipe))
    assert _log(serial) == _log(ref)
    assert serial["faults"]["counts"] == {"preempt": 1, "resume": 1}


def test_aot_warmup_skips_a_preempted_tenant():
    """A mid-run arrival re-runs ``warm_aot`` while the resident is
    preempted: no program is built for the parked tenant (it has no
    caches to bind; its programs are built again at its first dispatch
    after the resume), and the streams equal a run without AOT."""
    Spec, Event, Plan = _pkg("port")
    outs = {}
    for aot in (False, True):
        srv = _srv("port", tenants=[Spec(ARCH)], aot_warmup=aot,
                   faults=Plan([Event(step=8, kind="preempt",
                                      hold_epochs=2)]))
        srv.enqueue([Spec(ARCH, prompt_len=32, n_inferences=4,
                          arrive_at=12.0)])
        outs[aot] = srv.run(steps=24)
        if aot:
            parked = srv.tenants[0].tid
            assert outs[aot]["host"]["aot_compiled"] > 0
            assert not any(parked in key[5] and srv._fused_jits.peek(key).aot
                           for key in srv._fused_jits.keys())
    _same_tokens(_outputs(outs[True]), _outputs(outs[False]))
    assert outs[True]["faults"]["counts"] == {"preempt": 1, "resume": 1}


def _warm_server(pkg, base):
    s = _srv(pkg, prefix_dedup=True)
    s.enqueue([dataclasses.replace(base)])
    s.run(steps=8)   # registers the full-prompt prefix (+ token)
    return s


def test_preempt_resume_prefix_reseed_path():
    """test_faults.py::test_preempt_resume_prefix_reseed_path on the
    port: the resident full-prompt entry is the checkpoint, the resume
    re-seeds from it, bitwise against the control and equal to the
    reference's run."""
    outs = {}
    for pkg in ("ref", "port"):
        Spec = _pkg(pkg)[0]
        base = Spec(ARCH, prompt_len=32, n_inferences=4, param_seed=0,
                    prompt_seed=1)
        follow = dataclasses.replace(base, n_inferences=8)
        ctrl = _warm_server(pkg, base)
        t0 = ctrl.admit_routed(dataclasses.replace(follow)) if pkg == "ref" \
            else ctrl._admit_spec(dataclasses.replace(follow))
        assert t0.prefix_hit == 32
        r_ctrl = ctrl.run(steps=16)
        srv = _warm_server(pkg, base)
        t1 = srv.admit_routed(dataclasses.replace(follow)) if pkg == "ref" \
            else srv._admit_spec(dataclasses.replace(follow))
        assert t1.index == t1.prompt_len
        assert srv.preempt_tenant(t1, resume_after_epochs=1)
        assert t1.state == STATE_PREEMPTED
        assert srv.fault_log.of_kind("preempt")[0]["mode"] == "prefix"
        if pkg == "port":
            assert not t1.fed and t1.caches is None
            assert t1.token is not None and t1.log is not None
        r = srv.run(steps=16)
        assert t1.preemptions == 1 and t1.recovery_s
        a, b = _outputs(r_ctrl)[t0.tid], _outputs(r)[t1.tid]
        assert t0.tid == t1.tid
        assert a.shape == b.shape and np.array_equal(a, b)
        outs[pkg] = (r_ctrl, r)
    for ref, port in zip(outs["ref"], outs["port"]):
        _equal_runs(ref, port)
    assert outs["port"][1]["faults"]["checkpoint_bytes"] == 0


def test_preempted_tenant_frees_pages_and_reacquires():
    Spec, Event, Plan = _pkg("port")
    srv = _srv("port", faults=Plan([Event(step=8, kind="preempt",
                                          hold_epochs=2)]))
    srv.enqueue([Spec(ARCH, prompt_len=32, n_inferences=24)])
    free0 = srv.cache.free_pages
    r = srv.run(steps=24)
    info = next(iter(r["tenants"].values()))
    assert info["kv_reserved"] > 0
    assert info["kv_dtype"] in ("native", "int8", "fp8")
    assert srv.cache.free_pages == free0


def test_preempt_without_ckpt_dir_removes_its_temporary(tmp_path,
                                                        monkeypatch):
    """Without ``ckpt_dir`` the snapshot goes to a temporary root the
    server makes, and the server removes it once the tenant resumed."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    srv, r = _preempt_run("port", ARCH, "native", True)
    assert r["faults"]["log"][0]["mode"] == "snapshot"
    assert r["faults"]["checkpoint_bytes"] > 0
    assert not list(tmp_path.glob("repro_torch-preempt-*"))
    assert srv._ckpt_dir is None


# ------------------------------------ deterministic faulted replay --
def _faulted(pkg):
    Spec, Event, Plan = _pkg(pkg)
    events = [Event(step=4, kind="pool_pressure", pages=48),
              Event(step=12, kind="straggler", hold_epochs=3),
              Event(step=16, kind="preempt", hold_epochs=1)]
    srv = _srv(pkg, faults=Plan(events))
    free0 = srv.cache.free_pages
    srv.enqueue([Spec(ARCH, prompt_len=32, n_inferences=24, arrive_at=0.0),
                 Spec(ARCH, prompt_len=32, n_inferences=24, arrive_at=1.0)])
    res = srv.run(steps=32)
    assert srv.cache.free_pages == free0
    return res


def test_fault_schedule_replays_deterministically():
    a, b, ref = _faulted("port"), _faulted("port"), _faulted("ref")
    assert _log(a) == _log(b)
    _same_tokens(_outputs(a), _outputs(b))
    _equal_runs(ref, a)
    kinds = {rec["kind"] for rec in a["faults"]["log"]}
    assert {"pool_pressure", "straggler", "preempt", "resume"} <= kinds


def test_straggler_trip_preempts_then_recovers():
    res = {}
    for pkg in ("ref", "port"):
        Spec, Event, Plan = _pkg(pkg)
        srv = _srv(pkg, faults=Plan([Event(step=8, kind="straggler",
                                           hold_epochs=3)]))
        srv.enqueue([Spec(ARCH, prompt_len=32, n_inferences=24)])
        res[pkg] = srv.run(steps=32)
    counts = res["port"]["faults"]["counts"]
    assert counts.get("straggler_trip") == 1
    assert counts.get("preempt") == 1 and counts.get("resume") == 1
    _equal_runs(res["ref"], res["port"])


# --------------------------------------- overload admission control --
def _burst(pkg, n, **kw):
    Spec = _pkg(pkg)[0]
    specs = [Spec(ARCH, prompt_len=96, n_inferences=8, arrive_at=0.5,
                  qos_ms=(None if i % 3 == 0 else 50.0 * (i + 1)))
             for i in range(n)]
    srv = _srv(pkg, total_pages=8, queue_deadline_s=24.0, **kw)
    srv.enqueue(specs)
    return srv.run(steps=16)


@pytest.mark.parametrize("n, limit", [(8, 16), (12, 8)])
def test_overload_burst_defers_or_sheds_never_raises(n, limit):
    """test_faults.py::test_overload_burst_defers_or_sheds_never_raises
    (8 arrivals, queue limit 16) and the reference benchmark's burst (12
    arrivals, queue limit 8) on the port, equal to the reference's."""
    res = _burst("port", n, queue_limit=limit)
    ov = res["overload"]
    assert ov["queued"] == 0
    assert ov["deferrals"] > 0
    assert ov["shed_count"] > 0
    for s in ov["shed"]:
        assert s["state"] == STATE_SHED
        assert s["reason"] in ("deadline", "queue_full")
    shed_qos = [s["qos_ms"] for s in ov["shed"] if s["reason"] == "deadline"]
    assert None in shed_qos or max(q for q in shed_qos) >= 300.0
    assert all(info["tokens"] > 0 for info in res["tenants"].values())
    _equal_runs(_burst("ref", n, queue_limit=limit), res)


def test_bounded_queue_sheds_on_overflow():
    res = {}
    for pkg in ("ref", "port"):
        Spec = _pkg(pkg)[0]
        srv = _srv(pkg, queue_limit=2)
        srv.enqueue([Spec(ARCH, prompt_len=64, n_inferences=8, arrive_at=0.5)
                     for _ in range(6)])
        res[pkg] = srv.run(steps=8)
    assert {s["reason"] for s in res["port"]["overload"]["shed"]} == \
        {"queue_full"}
    assert res["port"]["overload"]["shed_count"] == 4
    _equal_runs(res["ref"], res["port"])


def test_malformed_prompts_shed_not_crash():
    res = {}
    for pkg in ("ref", "port"):
        Spec, Event, Plan = _pkg(pkg)
        srv = _srv(pkg, faults=Plan([Event(step=4, kind="bad_prompt")]))
        srv.enqueue([Spec(ARCH, prompt_len=32, n_inferences=16),
                     Spec(ARCH, prompt_len=-3, n_inferences=4,
                          arrive_at=0.5)])
        res[pkg] = srv.run(steps=16)
    reasons = sorted(s["reason"] for s in res["port"]["overload"]["shed"])
    assert reasons == ["negative_prompt", "oversized_prompt"]
    assert sum(i["tokens"] for i in res["port"]["tenants"].values()) > 0
    _equal_runs(res["ref"], res["port"])


def test_pool_pressure_spike_releases_after_hold():
    res = {}
    for pkg in ("ref", "port"):
        Spec, Event, Plan = _pkg(pkg)
        srv = _srv(pkg, faults=Plan([Event(step=4, kind="pool_pressure",
                                           pages=48, hold_epochs=2)]))
        srv.enqueue([Spec(ARCH, prompt_len=32, n_inferences=24)])
        free0 = srv.cache.free_pages
        res[pkg] = srv.run(steps=24)
        assert srv.cache.free_pages == free0
    log = res["port"]["faults"]["log"]
    seize = next(r for r in log if r["kind"] == "pool_pressure")
    release = next(r for r in log if r["kind"] == "pressure_release")
    assert seize["seized"] > 0
    assert release["step"] == seize["step"] + 2 * 4
    _equal_runs(res["ref"], res["port"])


# ---------------------------------------------------- checkpoint --
def test_checkpoint_roundtrip_is_exact(tmp_path):
    """Every leaf comes back with its dtype, shape and bytes, in the
    saved nested structure, on the device asked for."""
    g = torch.Generator().manual_seed(0)
    tree = {"kv": [{"k": torch.randn(2, 3, 4, generator=g) / 7.0,
                    "v": torch.randn(2, 3, 4, generator=g)
                    .to(torch.bfloat16)},
                   {"k": torch.randn(2, 5, generator=g)
                    .to(torch.float8_e4m3fn),
                    "k_scale": torch.rand(2, 5, 1, generator=g)}],
            "q": (torch.arange(12, dtype=torch.int8) - 5).reshape(3, 4),
            "tok": (torch.tensor([[3], [11]]), torch.tensor(7)),
            "empty": torch.zeros(0, 4)}
    step_dir = pckpt.save(str(tmp_path), 7, tree, extra={"index": 7})
    assert (step_dir / "manifest.json").is_file()
    assert pckpt.latest_step(str(tmp_path)) == 7
    assert pckpt.checkpoint_bytes(step_dir) > 0
    back, extra = pckpt.restore(str(tmp_path), step=7, device="cpu")
    assert extra == {"index": 7}
    leaves, structure = pckpt._flatten(tree)
    got, got_structure = pckpt._flatten(back)
    assert got_structure == structure and isinstance(back["tok"], tuple)
    for a, b in zip(leaves, got):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert bytes(a.reshape(-1).view(torch.uint8).numpy()) == \
            bytes(b.reshape(-1).view(torch.uint8).numpy())
    # into a given structure, and from a background save
    like, _ = pckpt.restore(str(tmp_path), tree_like=tree, device="cpu")
    assert pckpt._flatten(like)[1] == structure
    pckpt.save_async(str(tmp_path), 8, tree).join()
    assert pckpt.latest_step(str(tmp_path)) == 8
    with pytest.raises(ValueError):
        pckpt.restore(str(tmp_path), tree_like={"x": torch.zeros(1)},
                      device="cpu")


def test_checkpoint_matches_reference_on_reference_leaves(tmp_path):
    """The reference's round-trip leaves (fp32, int8, int32) through the
    port's checkpoint come back as the reference's restore gives them."""
    tree = {"kv": np.arange(24, dtype=np.float32).reshape(2, 3, 4) / 7.0,
            "q": (np.arange(12, dtype=np.int8) - 5).reshape(3, 4),
            "tok": np.array([[3], [11]], np.int32)}
    rckpt.save(str(tmp_path / "ref"), 7, tree, extra={"index": 7})
    want, _ = rckpt.restore(str(tmp_path / "ref"), tree, step=7)
    pckpt.save(str(tmp_path / "port"), 7, tree, extra={"index": 7})
    back, extra = pckpt.restore(str(tmp_path / "port"), device="cpu")
    assert extra["index"] == 7
    for k in tree:
        w = tensor_from_numpy(np.asarray(want[k]), "cpu")
        assert back[k].dtype == w.dtype and torch.equal(back[k], w), k
    manifest = json.loads((tmp_path / "port" / "step_00000007" /
                           "manifest.json").read_text())
    assert [m["dtype"] for m in manifest["leaves"]] == ["float32", "int8",
                                                        "int32"]


# ----------------------------------- the copied classes, same inputs --
def test_straggler_policy_equals_reference():
    durations = [1.0, 1.0, 8.0, 8.0, 1.0, 8.0, 8.0, 8.0, 1.0, 3.0, 30.0]
    for kw in ({}, dict(threshold=2.0, max_strikes=2, ewma_alpha=0.5)):
        ref, port = RStraggler(**kw), StragglerPolicy(**kw)
        for i, dt in enumerate(durations):
            assert port.observe(i, dt) == ref.observe(i, dt), (kw, i)
            assert (port.ewma, port.strikes) == (ref.ewma, ref.strikes)
        assert port.events == ref.events


def test_fault_plan_and_log_equal_reference():
    for seed in range(4):
        ref = RF.FaultPlan.seeded(seed, horizon=64, epoch_len=4,
                                  n_events=5, n_replicas=seed % 2 * 3)
        port = PF.FaultPlan.seeded(seed, horizon=64, epoch_len=4,
                                   n_events=5, n_replicas=seed % 2 * 3)
        assert ([dataclasses.astuple(e) for e in port.events]
                == [dataclasses.astuple(e) for e in ref.events])
        for clock in (0, 4, 12, 40, 64):
            assert port.peek_step() == ref.peek_step()
            assert ([dataclasses.astuple(e) for e in port.due(clock)]
                    == [dataclasses.astuple(e) for e in ref.due(clock)])
        assert port.exhausted == ref.exhausted
    with pytest.raises(AssertionError):
        PF.FaultEvent(step=0, kind="meteor_strike")
    with pytest.raises(AssertionError):
        PF.FaultEvent(step=-1, kind="preempt")
    ref_log, port_log = RF.FaultLog(), PF.FaultLog()
    for log in (ref_log, port_log):
        log.record(4, "preempt", tid="t0")
        log.record(8, "resume", tid="t0")
        log.record(8, "preempt", tid="t1")
    assert port_log.records == ref_log.records
    assert port_log.counts() == ref_log.counts()
    assert port_log.of_kind("preempt") == ref_log.of_kind("preempt")


def test_backoff_policy_equals_reference():
    for kw in ({}, dict(base_s=0.5, factor=3.0, max_s=5.0, jitter=0.2,
                        seed=4)):
        ref, port = RD.BackoffPolicy(**kw), PD.BackoffPolicy(**kw)
        for attempt in range(6):
            for key in (0, 3, 17):
                assert port.delay_s(attempt, key) == ref.delay_s(attempt,
                                                                 key)


def test_session_arrivals_equal_reference():
    kw = dict(models=["yi-9b", "olmoe-1b-7b"], n_sessions=3, turns=2,
              n_prompts=2, prefix_len=512, turn_tokens=128, gap_s=2.0,
              n_inferences=8, seed=3)
    assert ([dataclasses.astuple(s) for s in PD.SessionArrivals(**kw).specs()]
            == [dataclasses.astuple(s)
                for s in RD.SessionArrivals(**kw).specs()])
