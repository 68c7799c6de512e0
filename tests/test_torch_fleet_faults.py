"""Fleet failover, forwarded faults and prefix-affine routing in the
port's FleetServer against the JAX package's, in one process.

Mirrors tests/test_faults.py's fleet scenarios at the reduced
mamba2-370m (fp32): a replica kill at step 8 whose live tenants move to
the survivor (:275), a second kill of the last live replica refused and
logged (:299), and a preemption forwarded to its target replica (:315);
and tests/test_prefix_cache.py's prefix-affine routing (:222): a warm
session arrival goes to the replica holding its prefix, past a less
loaded decoy, and attaches there.  Both fleets run as
tests/test_torch_fleet.py's do (``torch_fleet_pairs``), compared
exactly: routes, routed scenarios, traces, tokens, per-replica records
and the failover and fault records.
"""
import functools

import pytest

from torch_fleet_pairs import (ARCH, assert_tokens_equal, port_solo, records,
                               run_pair, scenarios, traces)

FAULTED = dict(n=2, steps=24, max_len=128, pages_per_replica=64)


def _arrivals(n):
    return [dict(model=ARCH, prompt_len=32, n_inferences=24,
                 arrive_at=float(i)) for i in range(n)]


SCENARIOS = {
    "kill": dict(FAULTED, specs=_arrivals(3),
                 faults=[dict(step=8, kind="replica_kill", target="r0")]),
    "kill_last": dict(FAULTED, specs=_arrivals(2),
                      faults=[dict(step=8, kind="replica_kill", target="r0"),
                              dict(step=12, kind="replica_kill",
                                   target="r1")]),
    "forwarded": dict(FAULTED, specs=_arrivals(2),
                      faults=[dict(step=8, kind="preempt", target="r1",
                                   hold_epochs=1)]),
    "prefix_affine": dict(
        n=2, steps=16, pages_per_replica=64, prefix_dedup=True, max_len=512,
        specs=[dict(model=ARCH, arrive_at=0.0, n_inferences=24,
                    prompt_len=256, param_seed=5, prompt_seed=1,
                    prefix_len=256, prefix_seed=3),
               # promptless decoy: its replica stays the least loaded
               dict(model=ARCH, arrive_at=0.0, n_inferences=24),
               dict(model=ARCH, arrive_at=10.0, n_inferences=4,
                    prompt_len=384, param_seed=5, prompt_seed=2,
                    prefix_len=256, prefix_seed=3)]),
}


@functools.lru_cache(maxsize=None)
def _run(name):
    sc = dict(SCENARIOS[name])
    n, steps, specs = sc.pop("n"), sc.pop("steps"), sc.pop("specs")
    return run_pair(n, specs, steps, **sc)


@pytest.fixture(scope="module", params=sorted(SCENARIOS))
def pair(request):
    return _run(request.param)


def test_routes_and_scenarios_equal_reference(pair):
    (ref, ref_out), (port, port_out) = pair
    assert port_out["routes"] == ref_out["routes"]
    assert scenarios(port) == scenarios(ref)


def test_replica_traces_equal_reference(pair):
    (ref, _), (port, _) = pair
    assert traces(port) == traces(ref)


def test_tokens_failover_and_fault_records_equal_reference(pair):
    (_, ref_out), (_, port_out) = pair
    assert records(port_out) == records(ref_out)
    assert_tokens_equal(ref_out, port_out)


def test_replica_kill_fails_over_to_survivors():
    """tests/test_faults.py::test_replica_kill_fails_over_to_survivors on
    the port: every moved tenant completes on r1, its record the
    survivor's, with a recovery time."""
    _, (fleet, out) = _run("kill")
    fo = out["failover"]
    assert fo["killed"] == ["r0"] and fo["moved"]
    respecs = {f"t{s.seed}:{ARCH}": s for s in fleet.replica_scenarios()[1]}
    for m in fo["moved"]:
        assert (m["from"], m["to"], m["step"]) == ("r0", "r1", 8)
        info = out["tenants"][m["tid"]]
        assert info["replica"] == "r1" and info["departed"]
        # the survivor re-prefills and decodes the remaining budget
        assert info["output"].shape == (1, 1 + respecs[m["tid"]].n_inferences)
        assert fo["recovery_s"][m["tid"]] > 0
    assert fo["recovery_p95_s"] is not None
    dead = fleet.replicas[0]
    assert all(t.departed and t.caches is None for t in dead.tenants)
    assert dead.cache.free_pages == 64
    assert next(rep for rep in out["replicas"]
                if rep["replica"] == "r0")["dead"]


def test_kill_last_live_replica_is_refused():
    _, (_, out) = _run("kill_last")
    assert out["failover"]["killed"] == ["r0"]
    skipped = [r for r in out["faults"]["log"]
               if r["kind"] == "replica_kill" and "skipped" in r]
    assert len(skipped) == 1 and skipped[0]["target"] == "r1"
    assert skipped[0]["skipped"] == "last live replica"


def test_forwarded_faults_reach_target_replica():
    _, (_, out) = _run("forwarded")
    per_replica = out["faults"]["replica_counts"]
    assert per_replica[1].get("preempt", 0) == 1
    assert per_replica[0].get("preempt", 0) == 0


def test_forwarded_preemption_replays_bitwise_per_replica():
    """A forwarded preemption stays inside its replica: the replica that
    was not preempted replays bit for bit on a fresh server."""
    _, (fleet, out) = _run("forwarded")
    (routed,) = [s for s in fleet.replica_scenarios()[:1]]
    solo = port_solo(routed, pages=64, max_len=128).run(24)
    for tid, info in solo["tenants"].items():
        assert (out["tenants"][tid]["output"] == info["output"]).all(), tid


def test_fleet_prefix_affine_routing():
    """tests/test_prefix_cache.py::test_fleet_prefix_affine_routing on the
    port: the warm arrival follows its prefix, attaches it and prefills
    only its private suffix."""
    _, (_, out) = _run("prefix_affine")
    routes = dict(out["routes"])
    assert routes["t0:" + ARCH] != routes["t1:" + ARCH]
    assert routes["t2:" + ARCH] == routes["t0:" + ARCH]
    info = out["tenants"]["t2:" + ARCH]
    assert info["prefix_hit"] == 256
    assert sum(info["prefill_chunks"]) == 384 - 256
