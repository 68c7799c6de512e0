"""The reference's fleet and the port's on one scenario, for
tests/test_torch_fleet.py and tests/test_torch_fleet_faults.py.

The reference's ``FleetServer`` runs in this process, at the reduced
configs, on a JAX mesh that repeats the one CPU device (a ``Mesh``
accepts a device more than once, so no forced host devices and no
subprocess are needed).  The port's runs on ``devices=["cpu"] * n``
with the reference's params and prompts injected (``params_fn`` /
``prompt_fn``).  A scenario is plain data: ``specs`` (TenantSpec
keyword dicts, ``model`` included), ``faults`` (FaultEvent keyword
dicts) and the fleet's keywords, so each side builds its own specs and
fault plans (a plan is consumed as it fires).

The scheduling side of the port is a copy of the reference's, so the
comparison is exact: routes, routed scenarios, every replica's grant,
plan, prefill-chunk and NEC traces, tokens, per-replica records, and
failover and fault records (less their wall-clock fields).
"""
import dataclasses

import jax
import numpy as np
from jax.sharding import Mesh

from repro.launch import serve as RS
from repro.models import model as RM
from repro.models.base import get_arch as ref_arch
from repro.sim.driver import TenantSpec as RSpec
from repro.sim.faults import FaultEvent as RFaultEvent
from repro.sim.faults import FaultPlan as RFaultPlan
from repro_torch.bridge import params_from_numpy
from repro_torch.launch import serve as PS
from repro_torch.sim.driver import TenantSpec as PSpec
from repro_torch.sim.faults import FaultEvent as PFaultEvent
from repro_torch.sim.faults import FaultPlan as PFaultPlan

ARCH = "mamba2-370m"   # the reference fleet tests' arch
FLEET = dict(batch=1, max_len=256, epoch_len=4)
_REF_PARAMS = {}


def _ref_cfg(cfg):
    return ref_arch(cfg.name.removesuffix("-smoke")).reduced()


def ref_params(cfg, pkey):
    key = (cfg.name, pkey)
    if key not in _REF_PARAMS:
        tree = RM.init_params(_ref_cfg(cfg), jax.random.PRNGKey(pkey))
        _REF_PARAMS[key] = jax.tree_util.tree_map(np.asarray, tree)
    return params_from_numpy(_REF_PARAMS[key], cfg, "cpu")


def ref_prompt(spec, i, cfg, batch):
    """The reference's prompt tokens for a port spec, session fields
    included."""
    rspec = RSpec(spec.model, prompt_len=spec.prompt_len,
                  prompt_seed=spec.prompt_seed, prefix_len=spec.prefix_len,
                  prefix_seed=spec.prefix_seed)
    return RS._prompt_tokens(rspec, i, _ref_cfg(cfg), batch)


def ref_mesh(n):
    """An (n, 1) reference serving mesh over the one CPU device."""
    d = jax.devices("cpu")[0]
    return Mesh(np.array([[d]] * n), ("data", "model"))


def _plan(faults, event, plan):
    return plan([event(**e) for e in faults]) if faults else None


def ref_fleet(n, specs, faults=(), **kw):
    return RS.FleetServer(mesh=ref_mesh(n), tenants=[RSpec(**s) for s in specs],
                          faults=_plan(faults, RFaultEvent, RFaultPlan),
                          **{**FLEET, **kw})


def port_fleet(n, specs, faults=(), **kw):
    return PS.FleetServer(devices=["cpu"] * n,
                          tenants=[PSpec(**s) for s in specs],
                          faults=_plan(faults, PFaultEvent, PFaultPlan),
                          params_fn=ref_params, prompt_fn=ref_prompt,
                          **{**FLEET, **kw})


def run_pair(n, specs, steps, faults=(), **kw):
    """((reference fleet, its result), (port fleet, its result))."""
    ref, port = ref_fleet(n, specs, faults, **kw), port_fleet(n, specs,
                                                              faults, **kw)
    return (ref, ref.run(steps)), (port, port.run(steps))


def port_solo(routed, pages, **kw):
    """A fresh single-device port server replaying one replica's routed
    specs."""
    return PS.MultiTenantServer([], tenants=routed, total_pages=pages,
                                device="cpu", params_fn=ref_params,
                                prompt_fn=ref_prompt, **{**FLEET, **kw})


def scenarios(fleet):
    return [[dataclasses.asdict(s) for s in r]
            for r in fleet.replica_scenarios()]


def traces(fleet):
    """Per replica: each tenant's grant, plan, chunk, KV, prefix and
    preemption trace, the NEC traffic and ledger, the pool's free pages,
    the router's load and the logical clock."""
    return [({t.tid: (t.choices, [p.describe() for p in t.plans], t.chunks,
                      t.kv_wanted, t.kv_reserved, t.kv_dtype, t.prefix_hit,
                      t.pf_computed, t.state, t.preemptions, t.departed,
                      t.tokens_served)
              for t in srv.tenants},
             dataclasses.astuple(srv.nec.traffic),
             {k: dataclasses.astuple(v)
              for k, v in srv.nec.ledger.per_tenant.items()},
             srv.cache.free_pages, srv.load(), srv.active_count(),
             srv._clock, srv.prefix.stats())
            for srv in fleet.replicas]


def _wall_free(log):
    return [{k: v for k, v in rec.items()
             if k not in ("recovery_s", "waited_s")} for rec in log]


def records(out):
    """A merged fleet result less its wall-clock fields and token arrays."""
    fo, faults = out["failover"], out["faults"]
    return {
        "tenants": {tid: {k: v for k, v in info.items()
                          if k not in ("output", "ttft_s", "recovery_s")}
                    for tid, info in out["tenants"].items()},
        "ttft_stamped": sorted(tid for tid, info in out["tenants"].items()
                               if info["ttft_s"] is not None),
        **{k: out[k] for k in ("mode", "n_replicas", "tp", "epoch_len",
                               "tokens_served", "dram_bytes", "replicas",
                               "routes", "page_util_balance")},
        "failover": (fo["killed"], fo["moved"], sorted(fo["recovery_s"]),
                     fo["recovery_p95_s"] is None),
        "faults": (faults["counts"], _wall_free(faults["log"]),
                   faults["replica_counts"]),
    }


def assert_tokens_equal(a, b):
    assert set(a["tenants"]) == set(b["tenants"])
    for tid, info in a["tenants"].items():
        np.testing.assert_array_equal(b["tenants"][tid]["output"],
                                      info["output"], err_msg=tid)
