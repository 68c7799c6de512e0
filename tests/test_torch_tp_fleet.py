"""The port's tensor-parallel fleet against the reference's, on the CPU.

The reference's ``FleetServer(n_replicas=2, tp=2)`` needs four distinct
JAX devices (it does not run on a mesh that repeats the one CPU device),
so it runs in a subprocess that forces four host devices before JAX is
imported (``tests/torch_tp_fleet_ref.py``), with a timeout of its own.
It pickles its tenants' params and prompts, routes, traces, record and
tokens.  The port's ``FleetServer(n_replicas=2, tp=2,
devices=["cpu"] * 4)`` runs here with those params and prompts injected
(``params_fn`` / ``prompt_fn``).  Scenarios: tests/test_fleet.py:166's
(two yi-9b tenants at the reduced width, four steps) and the same with
the second tenant prefilling a 64-token prompt.  Routes, routed
scenarios, every replica's grant, plan, chunk and NEC traces and the
merged record must be equal, and the tokens too.
"""
import functools
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.bridge import params_from_numpy
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.launch import serve as PS
from repro_torch.sim.driver import TenantSpec
from torch_fleet_pairs import records, scenarios, traces

ROOT = Path(__file__).resolve().parents[1]
FLEET = dict(batch=1, max_len=256, epoch_len=4)
SCENARIOS = {
    "smoke": dict(steps=4, specs=[dict(model="yi-9b", n_inferences=2),
                                  dict(model="yi-9b", n_inferences=2)]),
    "prefill": dict(steps=6, specs=[dict(model="yi-9b", n_inferences=4),
                                    dict(model="yi-9b", n_inferences=4,
                                         prompt_len=64)]),
}


@functools.lru_cache(maxsize=None)
def _reference(name, tmp):
    sc = dict(SCENARIOS[name], fleet=FLEET)
    path = Path(tmp) / f"{name}.json"
    path.write_text(json.dumps(sc))
    out = Path(tmp) / f"{name}.pkl"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests"), env.get("PYTHONPATH", "")])
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_tp_fleet_ref.py"),
         str(path), str(out)], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("tp_fleet"))


def _port(name, ref):
    def params_fn(cfg, pkey):
        return params_from_numpy(ref["params"][pkey], cfg, "cpu")

    def prompt_fn(spec, i, cfg, batch):
        return ref["prompts"][i]

    fleet = PS.FleetServer(
        n_replicas=2, tp=2, devices=["cpu"] * 4,
        tenants=[TenantSpec(**s) for s in SCENARIOS[name]["specs"]],
        params_fn=params_fn, prompt_fn=prompt_fn, **FLEET)
    placed = [(any(tp.is_sharded(x) for x in tp.leaves(t.params)),
               all(d in srv.group for x in tp.leaves(t.params)
                   for d in (x.devices if tp.is_sharded(x) else [x.device])))
              for srv in fleet.replicas for t in srv.tenants]
    return fleet, fleet.run(SCENARIOS[name]["steps"]), placed


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_tp2_fleet_equals_reference(name, tmp):
    ref = _reference(name, tmp)
    fleet, out, placed = _port(name, ref)
    assert fleet.mesh.devices.shape == (2, 2)
    assert out["tp"] == 2 and out["tokens_served"] > 0
    # test_fleet.py:166's placement, on both sides
    assert placed == ref["placed"] == [(True, True)] * 2
    assert list(fleet.scenario.routes) == ref["routes"]
    assert scenarios(fleet) == ref["scenarios"]
    assert traces(fleet) == ref["traces"]
    assert records(out) == ref["records"]
    assert set(out["tenants"]) == set(ref["tokens"])
    for tid, want in ref["tokens"].items():
        np.testing.assert_array_equal(out["tenants"][tid]["output"], want,
                                      err_msg=tid)


def test_tp2_fleet_replica_replays_bitwise(tmp):
    """The fleet's contract at tp = 2: replica r's routed specs replayed
    on a fresh tp = 2 group reproduce its streams bit for bit."""
    ref = _reference("prefill", tmp)
    fleet, out, _ = _port("prefill", ref)
    for r, routed in enumerate(fleet.replica_scenarios()):
        solo = PS.MultiTenantServer(
            [], tenants=routed, device=PS.replica_submeshes(fleet.mesh)[r],
            params_fn=lambda cfg, k: params_from_numpy(ref["params"][k], cfg,
                                                       "cpu"),
            prompt_fn=lambda spec, i, cfg, b: ref["prompts"][i], **FLEET)
        got = solo.run(SCENARIOS["prefill"]["steps"])
        for tid, info in got["tenants"].items():
            assert out["tenants"][tid]["replica"] == f"r{r}"
            np.testing.assert_array_equal(out["tenants"][tid]["output"],
                                          info["output"], err_msg=tid)
