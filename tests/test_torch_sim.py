"""The port's analytic multi-tenant simulator (src/repro_torch/sim/)
against the JAX package's (src/repro/sim/) on the CPU.

Both are the same Python over the same framework-free ``core/``, so the
bar is exact equality: the engine's event order and times, every
scheduler's ``SimResult`` field by field with its ``TrafficLedger`` and
the pages back in the pool, the arrival processes draw for draw, and the
reuse and area models.  The simulator prices the paper's simulated NPU
SoC; nothing here runs on a device."""
import ast

import pytest

from repro.core import mapping as ref_mapping
from repro.core.cache import CacheConfig as RefCacheConfig
from repro.sim import area as ref_area
from repro.sim import driver as ref_driver
from repro.sim import engine as ref_engine
from repro.sim import reuse as ref_reuse
from repro.sim import schedulers as ref_sched
from repro.sim import workloads as ref_workloads
from repro_torch.core import mapping as port_mapping
from repro_torch.core.cache import CacheConfig as PortCacheConfig
from repro_torch.sim import area as port_area
from repro_torch.sim import driver as port_driver
from repro_torch.sim import engine as port_engine
from repro_torch.sim import reuse as port_reuse
from repro_torch.sim import schedulers as port_sched
from repro_torch.sim import workloads as port_workloads
from torch_sim_pairs import COPIES, copy_parts, plain, sim_summary, squeeze

PKGS = {
    "ref": (ref_driver, ref_engine, ref_workloads, RefCacheConfig),
    "port": (port_driver, port_engine, port_workloads, PortCacheConfig),
}
MIX = ["RS", "MB", "BE", "GN"] * 2


# -------------------------------------------------------------- copies --
@pytest.mark.parametrize("ref_rel, port_rel", COPIES,
                         ids=[p for _, p in COPIES])
def test_port_file_is_the_reference_with_its_imports_renamed(ref_rel,
                                                             port_rel):
    ref, port = copy_parts(ref_rel, port_rel)
    assert ast.dump(ast.parse(port)) == ast.dump(ast.parse(ref))
    assert squeeze(port) == squeeze(ref)   # comments too


def test_memos_are_per_package():
    """``_plan_gemm`` / ``map_layer_lwm``'s process-wide memos are the
    port's own: a run of one package never reads the other's."""
    for name in ("_FACTOR_CACHE", "_GEMM_PLAN_CACHE", "_LWM_CACHE"):
        assert getattr(port_mapping, name) is not getattr(ref_mapping, name)
    g = port_workloads.benchmark_models()["MB"]
    port_driver.MultiTenantSim([g], "camdn").run(duration_s=0.01)
    assert port_mapping._LWM_CACHE
    port_types = {type(k[0]).__module__ for k in port_mapping._LWM_CACHE}
    ref_types = {type(k[0]).__module__ for k in ref_mapping._LWM_CACHE}
    assert port_types == {"repro_torch.core.types"}
    assert ref_types <= {"repro.core.types"}


# -------------------------------------------------------------- engine --
def _ordering(E):
    eng = E.Engine()
    seen = []
    for t, tag in ((2.0, "b"), (1.0, "a"), (3.0, "c")):
        eng.schedule(t, lambda tag=tag: seen.append((tag, eng.now)))
    eng.run()
    return seen, eng.now


def _dram_share(E, weights):
    eng = E.Engine()
    dram = E.DramResource(eng, total_bps=100.0)
    done = []
    for tag, w in weights:
        dram.submit(100.0, lambda tag=tag: done.append((tag, eng.now)),
                    weight=w)
    eng.run()
    return done, dram.bytes_served, dram.utilization


def _core_pool(E):
    eng = E.Engine()
    pool = E.CorePool(eng, 2)
    order = []
    pool.acquire(2, lambda: order.append(("first", eng.now, pool.free)))
    pool.acquire(1, lambda: order.append(("second", eng.now, pool.free)))
    eng.run()
    first = list(order)
    pool.release(2)
    eng.run()
    return first, order, pool.free


ENGINE_CASES = {
    "ordering": _ordering,
    "dram_fair": lambda E: _dram_share(E, [("a", 1.0), ("b", 1.0)]),
    "dram_weighted": lambda E: _dram_share(E, [("hi", 3.0), ("lo", 1.0)]),
    "dram_three": lambda E: _dram_share(E, [("x", 1.0), ("y", 2.0),
                                            ("z", 0.5)]),
    "core_pool": _core_pool,
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_event_order_equal_reference(case):
    got = ENGINE_CASES[case](port_engine)
    assert got == ENGINE_CASES[case](ref_engine)
    if case == "ordering":
        assert [t for t, _ in got[0]] == ["a", "b", "c"] and got[1] == 3.0
    if case == "dram_weighted":
        assert got[0][0][0] == "hi"
    if case == "core_pool":
        assert [o[0] for o in got[0]] == ["first"]
        assert [o[0] for o in got[1]] == ["first", "second"]


# ---------------------------------------------------------- schedulers --
def test_scheduler_table_equal_reference():
    assert list(port_sched.SCHEDULERS) == list(ref_sched.SCHEDULERS)
    assert ({k: plain(v) for k, v in port_sched.SCHEDULERS.items()}
            == {k: plain(v) for k, v in ref_sched.SCHEDULERS.items()})
    assert plain(port_sched.TransparentParams()) == plain(
        ref_sched.TransparentParams())


def test_benchmark_models_equal_reference():
    port, ref = (port_workloads.benchmark_models(),
                 ref_workloads.benchmark_models())
    assert list(port) == list(ref)
    for k in ref:
        assert plain(port[k]) == plain(ref[k]), k


def _run(pkg, tenants, sched, dur, cfg=None, **kw):
    D, _, W, CC = PKGS[pkg]
    models = W.benchmark_models()
    config = D.SimConfig(**cfg(CC)) if cfg else None
    sim = D.MultiTenantSim([models[t] for t in tenants], sched, config, **kw)
    return sim_summary(sim, sim.run(duration_s=dur))


@pytest.mark.parametrize("sched", list(ref_sched.SCHEDULERS))
def test_mix_sim_result_equal_reference(sched):
    got = _run("port", MIX, sched, 0.1)
    want = _run("ref", MIX, sched, 0.1)
    assert got == want
    assert got["total_inferences"] > 0
    assert got["free_pages"] == got["num_pages"]


def test_transparent_plan_and_layer_dram_equal_reference():
    port_g = port_workloads.benchmark_models()["BE"]
    ref_g = ref_workloads.benchmark_models()["BE"]
    pp = port_sched.transparent_plan(port_g)
    rp = ref_sched.transparent_plan(ref_g)
    assert plain(pp) == plain(rp)
    pt, rt = port_sched.TransparentParams(), ref_sched.TransparentParams()
    for i in range(len(ref_g.layers)):
        for n_active in (1, 4, 16):
            assert (port_sched.transparent_layer_dram(pp, i, 16 * 2**20,
                                                      n_active, pt)
                    == ref_sched.transparent_layer_dram(rp, i, 16 * 2**20,
                                                        n_active, rt))


def test_no_deadlock_under_page_pressure_equal_reference():
    """16 tenants on a 2 MiB cache (ref tests/test_sim.py:106)."""
    def cfg(CC):
        return {"cache": CC(total_bytes=2 * 2**20, num_slices=2)}
    names = list(ref_workloads.benchmark_models()) * 2
    got = _run("port", names, "camdn", 0.05, cfg)
    assert got == _run("ref", names, "camdn", 0.05, cfg)
    assert got["total_inferences"] > 0


def test_isolated_latencies_equal_reference():
    port = port_workloads.benchmark_models()
    ref = ref_workloads.benchmark_models()
    got = port_driver.isolated_latencies([port["RS"], port["MB"]])
    assert got == ref_driver.isolated_latencies([ref["RS"], ref["MB"]])


# ---------------------------------------------------- dynamic tenancy --
ARRIVALS = dict(rate_per_s=300.0, n_arrivals=6, n_inferences=3, seed=3)


def _arrivals_run(pkg, sched):
    D, _, W, _ = PKGS[pkg]
    models = W.benchmark_models()
    sim = D.MultiTenantSim([models["RS"]], sched,
                           arrivals=D.PoissonArrivals(
                               models=[models["MB"], models["GN"]],
                               **ARRIVALS))
    return sim_summary(sim, sim.run(duration_s=0.04))


@pytest.mark.parametrize("sched", list(ref_sched.SCHEDULERS))
def test_arrival_departure_equal_reference(sched):
    """ref tests/test_policy.py:176: open-loop arrivals and departures."""
    got = _arrivals_run("port", sched)
    assert got == _arrivals_run("ref", sched)
    assert got["free_pages"] == got["num_pages"]
    tasks = got["result"][1][1]
    assert all(t[1][-1] is not None for t in tasks[1:])   # departed_at


def _churn_run(pkg, sched):
    D, _, W, _ = PKGS[pkg]
    models = W.benchmark_models()
    sim = D.MultiTenantSim(
        [models["RS"], models["BE"]], sched,
        arrivals=D.PoissonArrivals(rate_per_s=200.0,
                                   models=[models["MB"], models["GN"]],
                                   n_arrivals=8, n_inferences=4, seed=7))
    return sim_summary(sim, sim.run(duration_s=0.1))


@pytest.mark.parametrize("sched", ["baseline", "camdn"])
def test_churn_equal_reference(sched):
    """ref tests/test_policy.py:197: joins and leaves mid-run."""
    assert _churn_run("port", sched) == _churn_run("ref", sched)


def _qos_run(pkg):
    D, _, W, _ = PKGS[pkg]
    models = W.benchmark_models()
    specs = [D.TenantSpec(models["RS"], qos_ms=1e9),
             D.TenantSpec(models["RS"], qos_ms=1e-9)]
    sim = D.MultiTenantSim(scheduler="camdn", tenants=specs)
    return sim_summary(sim, sim.run(duration_s=0.03))


def test_per_tenant_qos_equal_reference():
    """ref tests/test_policy.py:214: a per-tenant ``qos_ms`` override."""
    got = _qos_run("port")
    assert got == _qos_run("ref")
    assert [t[4] for t in got["per_task"]] == [1.0, 0.0]


@pytest.mark.parametrize("seed", [0, 3, 7, 12345])
def test_arrival_processes_draw_for_draw(seed):
    port_m = port_workloads.benchmark_models()
    ref_m = ref_workloads.benchmark_models()
    kw = dict(rate_per_s=250.0, n_arrivals=9, n_inferences=2, seed=seed,
              prompt_len=16)
    got = port_driver.PoissonArrivals(models=[port_m["MB"], port_m["EF"]],
                                      **kw).specs()
    want = ref_driver.PoissonArrivals(models=[ref_m["MB"], ref_m["EF"]],
                                      **kw).specs()
    assert plain(got) == plain(want)
    skw = dict(models=["yi-9b", "olmoe-1b-7b"], n_sessions=3, turns=2,
               seed=seed)
    got = port_driver.SessionArrivals(**skw).specs()
    want = ref_driver.SessionArrivals(**skw).specs()
    assert plain(got) == plain(want)
    assert plain(port_driver.SimConfig(seed=seed)) == plain(
        ref_driver.SimConfig(seed=seed))


# -------------------------------------------------------- reuse, area --
@pytest.mark.parametrize("co_runners", [1, 4])
def test_reuse_stats_equal_reference(co_runners):
    port_m = port_workloads.benchmark_models()
    ref_m = ref_workloads.benchmark_models()
    for k in ref_m:
        p = port_reuse.model_reuse_stats(port_m[k], co_runners)
        r = ref_reuse.model_reuse_stats(ref_m[k], co_runners)
        assert plain(p) == plain(r), k
        assert p.pct_no_reuse == r.pct_no_reuse
    p = port_reuse.aggregate_reuse_stats(list(port_m.values()), co_runners)
    r = ref_reuse.aggregate_reuse_stats(list(ref_m.values()), co_runners)
    assert plain(p) == plain(r)
    for mb in (1, 2, 4):
        assert p.pct_distance_over(mb * 2**20) == r.pct_distance_over(
            mb * 2**20)


def test_shared_prefix_reuse_equal_reference():
    kw = dict(models=["yi-9b", "mamba2-370m"], n_sessions=4, turns=3,
              seed=5)
    got = port_reuse.shared_prefix_reuse(
        port_driver.SessionArrivals(**kw).specs(), align=16,
        bytes_per_token={"yi-9b": 7})
    want = ref_reuse.shared_prefix_reuse(
        ref_driver.SessionArrivals(**kw).specs(), align=16,
        bytes_per_token={"yi-9b": 7})
    assert got == want


def test_area_model_equal_reference():
    assert port_area.table3() == ref_area.table3()
    assert port_area.npu_area() == ref_area.npu_area()
    for mb, slices in ((4, 4), (16, 8), (64, 8)):
        got = port_area.cache_slice_area(
            PortCacheConfig(total_bytes=mb * 2**20, num_slices=slices))
        want = ref_area.cache_slice_area(
            RefCacheConfig(total_bytes=mb * 2**20, num_slices=slices))
        assert got == want
    assert plain(port_area.NpuAreaConfig()) == plain(ref_area.NpuAreaConfig())
