"""The port's FleetServer against the JAX package's, in one process.

Mirrors tests/test_fleet.py's fleet scenarios at the reduced mamba2-370m
(fp32): 8 identical specs round-robin over 4 replicas (:94), prompts on
every other tenant over 2 replicas of 64 pages, replayed replica by
replica on fresh single-device servers (:126), independent per-replica
control stacks (:151), and a late arrival routed to the least-loaded
replica (:185).  The reference runs on a mesh that repeats the one CPU
device, the port on ``devices=["cpu"] * n`` with the reference's params
and prompts injected (``torch_fleet_pairs``); routes, routed scenarios,
every replica's traces, tokens and records must be equal.  Also: the
serving mesh (its assertion, repeated devices, the default CUDA device
list), tp > 1 groups built (a multi-row mesh raising), the CLI's
``--devices``, and chip_smoke.py's two fleet phases scheduled at full
width without weights
(``torch_dry_run``).
"""
import contextlib
import functools
import importlib.util
import io
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.launch import serve as RS
from repro.sim.driver import TenantSpec as RSpec
from repro_torch.launch import mesh as PMesh
from repro_torch.launch import serve as PS
from repro_torch.sim.driver import FleetScenario
from repro_torch.sim.driver import TenantSpec as PSpec
from repro_torch.sim.faults import FaultEvent, FaultPlan
from torch_dry_run import dry_fleet
from torch_fleet_pairs import (ARCH, FLEET, assert_tokens_equal, port_fleet,
                               port_solo, records, ref_mesh, run_pair,
                               scenarios, traces)

SCENARIOS = {
    "round_robin": dict(n=4, steps=4,
                        specs=[dict(model=ARCH, n_inferences=4)] * 8),
    "replay": dict(n=2, steps=6, pages_per_replica=64,
                   specs=[dict(model=ARCH, n_inferences=6,
                               prompt_len=64 if i % 2 else 0)
                          for i in range(4)]),
    "late_arrival": dict(n=2, steps=6, pages_per_replica=64,
                         specs=[dict(model=ARCH, n_inferences=16,
                                     prompt_len=128)] * 2
                         + [dict(model=ARCH, n_inferences=2),
                            dict(model=ARCH, arrive_at=2.0, n_inferences=2)]),
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
    assert port.scenario.routes == ref.scenario.routes
    assert scenarios(port) == scenarios(ref)


def test_replica_traces_equal_reference(pair):
    (ref, _), (port, _) = pair
    assert traces(port) == traces(ref)


def test_tokens_and_records_equal_reference(pair):
    (_, ref_out), (_, port_out) = pair
    assert records(port_out) == records(ref_out)
    assert_tokens_equal(ref_out, port_out)


def test_routing_round_robins_identical_specs():
    """tests/test_fleet.py::test_routing_round_robins_identical_specs on
    the port."""
    _, (fleet, out) = _run("round_robin")
    assert sorted(len(s) for s in fleet.replica_scenarios()) == [2, 2, 2, 2]
    tids = [tid for tid, _ in fleet.scenario.routes]
    assert len(tids) == len(set(tids)) == 8
    assert out["mode"] == "fleet" and out["n_replicas"] == 4
    assert all(rep["tokens_served"] > 0 for rep in out["replicas"])


def test_per_replica_streams_replay_bitwise():
    """The fleet's contract on the port: replaying replica r's routed
    specs on a fresh single-device port server reproduces its decode
    streams bit for bit (and the reference's, by the parity above)."""
    _, (fleet, out) = _run("replay")
    scen = fleet.replica_scenarios()
    assert sum(len(s) for s in scen) == 4
    for r, routed in enumerate(scen):
        solo = port_solo(routed, pages=64).run(6)
        assert solo["tenants"]
        for tid, info in solo["tenants"].items():
            assert out["tenants"][tid]["replica"] == f"r{r}"
            np.testing.assert_array_equal(out["tenants"][tid]["output"],
                                          info["output"], err_msg=tid)


def test_late_arrival_routes_to_least_loaded():
    _, (fleet, _) = _run("late_arrival")
    routes = dict(fleet.scenario.routes)
    assert [r for _, r in fleet.scenario.routes[:3]] == [0, 1, 0]
    assert routes[fleet.scenario.routes[-1][0]] == 1


def test_per_replica_allocators_are_independent():
    """tests/test_fleet.py::test_per_chip_allocators_are_independent: one
    tenant loads one replica's pool; the others' pools, loads and
    ledgers are untouched, as in the reference."""
    ref = RS.FleetServer(mesh=ref_mesh(4), pages_per_replica=32,
                         tenants=[RSpec(ARCH, n_inferences=2)], **FLEET)
    port = port_fleet(4, [dict(model=ARCH, n_inferences=2)],
                      pages_per_replica=32)
    assert traces(port) == traces(ref)
    assert [srv.cache.free_pages for srv in port.replicas] == [32] * 4
    loaded = [r for r, srv in enumerate(port.replicas) if srv.tenants]
    assert loaded == [0]
    assert all(port.replicas[r].load() == 0 for r in (1, 2, 3))
    assert len({id(srv.control) for srv in port.replicas}) == 4
    assert [srv.control.replica for srv in port.replicas] == [
        "r0", "r1", "r2", "r3"]


def test_tenants_placed_on_replica_devices():
    fleet = port_fleet(2, [dict(model=ARCH, n_inferences=2,
                                prompt_len=32)] * 2)
    devs = PMesh.replica_devices(fleet.mesh)
    for r, srv in enumerate(fleet.replicas):
        assert srv.device == devs[r] == torch.device("cpu")
        (t,) = srv.tenants
        leaves = [x for layer in t.caches for x in layer.values()]
        leaves += [t.token, t.index_dev, t.log, t.prompt_dev]
        assert all(x.device == srv.device for x in leaves)
        assert t.task.replica == t.ptask.replica == f"r{r}"


def test_fleet_scenario_shape():
    sc = FleetScenario(2, [[], []])
    assert sc.routes == [] and len(sc.per_replica) == 2


# ------------------------------------------------------------ mesh --
def test_serving_mesh_repeats_devices_like_the_reference():
    mesh = PMesh.make_serving_mesh(2, devices=["cpu", "cpu"])
    assert mesh.devices.shape == ref_mesh(2).devices.shape == (2, 1)
    assert mesh.axis_names == ("data", "model")
    assert PMesh.replica_devices(mesh) == [torch.device("cpu")] * 2
    assert PMesh.chips(mesh) == 2
    subs = PMesh.replica_submeshes(mesh)
    assert [s.devices.shape for s in subs] == [(1, 1), (1, 1)]
    grid = PMesh.make_serving_mesh(tp=2, devices=["cpu"] * 5)
    assert grid.devices.shape == (2, 2)


@pytest.mark.parametrize("n, tp, have", [(3, 1, 2), (1, 3, 2), (2, 2, 3)])
def test_serving_mesh_asserts_enough_devices(n, tp, have):
    with pytest.raises(AssertionError):
        PMesh.make_serving_mesh(n, tp=tp, devices=["cpu"] * have)


def test_serving_mesh_defaults_to_every_cuda_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    mesh = PMesh.make_serving_mesh()
    assert PMesh.replica_devices(mesh) == [torch.device("cuda", i)
                                           for i in range(3)]


def test_tensor_parallel_replica_groups_raise():
    """tp > 1 groups are served (tests/test_torch_tp*.py hold them against
    the reference); what still raises is a server handed more than one
    replica row."""
    fleet = PS.FleetServer(n_replicas=1, tp=2, devices=["cpu"] * 2)
    assert fleet.tp == 2 and fleet.replicas[0].group == [torch.device("cpu")] * 2
    wide = PMesh.make_serving_mesh(1, tp=2, devices=["cpu"] * 2)
    srv = PS.MultiTenantServer([ARCH], device=wide)
    assert srv.mesh is wide and srv.device == torch.device("cpu")
    rows = PMesh.make_serving_mesh(2, tp=1, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="one mesh row"):
        PS.MultiTenantServer([ARCH], device=rows)
    # a 1 x 1 submesh is its device
    one = PMesh.make_serving_mesh(1, devices=["cpu"])
    assert PS.MultiTenantServer([], device=one).device == torch.device("cpu")


# ------------------------------------------------------------- CLI --
def test_cli_devices_serves_a_fleet():
    """``--devices 2 --device cpu``: each placement on its own line, then
    the reference's ``[fleet]`` lines; the merged result returned."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = PS.main(["--device", "cpu", "--devices", "2", "--steps", "4",
                       "--archs", ARCH, "yi-9b", "--max-len", "128"])
    lines = buf.getvalue().splitlines()
    assert lines[:2] == ["[fleet] r0 on cpu", "[fleet] r1 on cpu"]
    assert lines[2].startswith("[fleet] r0: ") and "tokens" in lines[2]
    assert lines[3].startswith("[fleet] r1: ")
    assert lines[4].startswith("[fleet] 2 replicas (tp=1): ")
    assert len(lines) == 5
    assert out["mode"] == "fleet" and out["routes"] == [
        (f"t0:{ARCH}", 0), ("t1:yi-9b", 1)]
    assert all(rep["tokens_served"] == 2 * 4 for rep in out["replicas"])  # batch 2


def test_cli_devices_place_replicas_round_robin_on_cards(monkeypatch):
    """On the card, replica r goes to card r % device_count: recorded
    here by a stand-in FleetServer (no card is touched)."""
    seen = {}

    class Stop(Exception):
        pass

    def fleet(**kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(PS, "FleetServer", fleet)
    with pytest.raises(Stop):
        PS.main(["--devices", "3", "--full-width"])
    assert seen["devices"] == [torch.device("cuda", i) for i in (0, 1, 0)]
    assert seen["n_replicas"] == 3 and seen["reduced"] is False


# --------------------------------------- chip_smoke.py's schedules --
def _chip_smoke():
    """chip_smoke.py's phase constants and pool sizes (the module imports
    no torch at load time)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_consts", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serve_fleet_schedule_at_full_width(monkeypatch):
    """serve_fleet's scenario at full width, scheduled without weights:
    2,649 pages a replica (768 + 1,557 + 324), one yi-9b and one mamba2
    tenant routed to each replica, every tenant served its budget and
    departed, the pools whole again; the warm round's residents route
    the same way."""
    cs = _chip_smoke()
    sf = cs.SERVE_FLEET
    pages = cs.serve_fleet_pages(sf["archs"])
    assert pages == 768 + 1557 + 324
    kw = dict(devices=["cpu"] * sf["replicas"], pages_per_replica=pages,
              batch=sf["batch"], max_len=sf["max_len"],
              epoch_len=sf["epoch_len"], reduced=False)
    fleet = dry_fleet(monkeypatch, [
        PSpec(a, prompt_len=sf["prompt_len"], n_inferences=sf["n_inferences"])
        for a in sf["archs"]], **kw)
    mix = sorted(set(sf["archs"]))
    assert [sorted(s.model for s in r)
            for r in fleet.replica_scenarios()] == [mix] * 2
    out = fleet.run(sf["steps"])
    assert all(info["departed"] and info["tokens"] == 1 + sf["n_inferences"]
               for info in out["tenants"].values())
    assert [srv.cache.free_pages for srv in fleet.replicas] == [pages] * 2
    residents = dry_fleet(monkeypatch, [PSpec(a) for a in sf["archs"]], **kw)
    assert residents.scenario.routes == fleet.scenario.routes


@pytest.mark.parametrize("kills", [1, 2])
def test_fleet_failover_schedule_at_full_width(monkeypatch, kills):
    """fleet_failover's scenario at full width, scheduled without weights:
    4,671 pages a replica (3 x 1,557), r0's live tenants move to r1 at
    step 8 and complete there; a second kill, of r1 at step 12, is
    skipped."""
    cs = _chip_smoke()
    ff = cs.FLEET_FAILOVER
    pages = cs.fleet_failover_pages(ff["arch"])
    assert pages == 3 * 1557
    events = (ff["kill"], ff["last_kill"])[:kills]
    fleet = dry_fleet(
        monkeypatch,
        [PSpec(ff["arch"], prompt_len=ff["prompt_len"],
               n_inferences=ff["n_inferences"], arrive_at=float(i))
         for i in range(ff["tenants"])],
        devices=["cpu"] * 2, pages_per_replica=pages, batch=ff["batch"],
        max_len=ff["max_len"], epoch_len=ff["epoch_len"], reduced=False,
        faults=FaultPlan([FaultEvent(step=s, kind="replica_kill", target=t)
                          for s, t in events]))
    out = fleet.run(ff["steps"])
    fo = out["failover"]
    assert fo["killed"] == ["r0"] and fo["moved"]
    assert {(m["from"], m["to"], m["step"]) for m in fo["moved"]} == {
        ("r0", "r1", 8)}
    assert all(info["departed"] for info in out["tenants"].values())
    assert all(out["tenants"][m["tid"]]["replica"] == "r1"
               for m in fo["moved"])
    skipped = [r for r in out["faults"]["log"] if "skipped" in r]
    assert len(skipped) == kills - 1
