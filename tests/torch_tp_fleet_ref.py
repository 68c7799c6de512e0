"""The reference's tensor-parallel fleet, run alone for
tests/test_torch_tp_fleet.py.

``python tests/torch_tp_fleet_ref.py SCENARIO.json OUT.pkl`` forces four
host devices (``XLA_FLAGS``) before JAX is imported, builds the
reference's ``FleetServer(n_replicas=2, tp=2, ...)`` on the scenario
(``specs``: TenantSpec keyword dicts; ``steps``; the fleet's keywords),
checks the placement tests/test_fleet.py:166 checks, runs it, and
pickles what the port is held to: every tenant's params (numpy, by
param seed) and prompt (by admission index), the routes, the routed
scenarios, every replica's traces (``torch_fleet_pairs.traces``), the
merged record less its wall-clock fields, and the tokens.
"""
import json
import os
import pickle
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.launch import serve as RS  # noqa: E402
from repro.sim.driver import TenantSpec  # noqa: E402
from torch_fleet_pairs import records, scenarios, traces  # noqa: E402


def main(scenario_path: str, out_path: str) -> None:
    with open(scenario_path) as f:
        sc = json.load(f)
    assert jax.device_count() >= 4, jax.devices()
    fleet = RS.FleetServer(n_replicas=2, tp=2,
                           tenants=[TenantSpec(**s) for s in sc["specs"]],
                           **sc["fleet"])
    params, prompts, placed = {}, {}, []
    for srv in fleet.replicas:
        group = set(srv.mesh.devices.flat)
        for t in srv.tenants:
            i = int(t.tid.split(":")[0][1:])
            leaves = jax.tree_util.tree_leaves(t.params)
            placed.append((any(len(x.devices()) == 2 for x in leaves),
                           all(x.devices() <= group for x in leaves)))
            params[i] = jax.tree_util.tree_map(np.asarray, t.params)
            if t.prompt is not None:
                prompts[i] = np.asarray(t.prompt)
    out = fleet.run(sc["steps"])
    dump = {"params": params, "prompts": prompts, "placed": placed,
            "routes": list(fleet.scenario.routes),
            "scenarios": scenarios(fleet), "traces": traces(fleet),
            "records": records(out),
            "tokens": {tid: info["output"]
                       for tid, info in out["tenants"].items()}}
    with open(out_path, "wb") as f:
        pickle.dump(dump, f)


if __name__ == "__main__":
    main(*sys.argv[1:3])
