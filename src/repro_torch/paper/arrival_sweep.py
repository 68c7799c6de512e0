# Verbatim copy of benchmarks/arrival_sweep.py (lines 1-71: the open-loop
# arrival sweep; run :28, main :61); only its imports differ: repro. becomes
# repro_torch. and benchmarks.common becomes repro_torch.paper.common. Run
# it as `python -m repro_torch.paper.arrival_sweep`; it prints what `python
# benchmarks/arrival_sweep.py` prints. It imports no framework.
"""Arrival sweep: open-loop dynamic tenancy through the unified
CachePolicy runtime.

A resident tenant mix serves continuously while open-loop Poisson
arrivals join mid-run, execute a bounded number of inferences, and
depart (pages reclaimed).  Sweeping the arrival rate shows how each
policy degrades under tenancy churn: transparent LLCs lose hit rate to
the newcomers' footprints, while CaMDN's exclusive regions contain the
blast radius and the dynamic allocator re-balances after departures —
the open-loop setting MoCA [arXiv:2305.05843] and GACER
[arXiv:2304.11745] evaluate.

  PYTHONPATH=src python benchmarks/arrival_sweep.py
"""
from __future__ import annotations

from typing import Dict

from repro_torch.sim.driver import MultiTenantSim, PoissonArrivals, SimConfig
from repro_torch.sim.workloads import benchmark_models
from repro_torch.paper.common import emit, timed

RATES = (50.0, 200.0, 800.0)          # arrivals per second
SCHEDULERS = ("baseline", "moca", "camdn_hw", "camdn")
DUR = 0.15


def run(verbose: bool = True) -> Dict:
    models = benchmark_models()
    resident = [models["RS"], models["BE"]]
    churn_pool = [models["MB"], models["GN"], models["EF"]]
    out: Dict = {}
    for rate in RATES:
        row = {}
        for sched in SCHEDULERS:
            sim = MultiTenantSim(resident, sched, SimConfig(),
                                 arrivals=PoissonArrivals(
                                     rate_per_s=rate, models=churn_pool,
                                     n_arrivals=max(2, int(rate * DUR)),
                                     n_inferences=4, seed=7))
            res = sim.run(duration_s=DUR)
            departed = sum(1 for t in res.tasks if t.departed_at is not None)
            row[sched] = {
                "throughput": res.throughput,
                "avg_latency_ms": res.avg_latency * 1e3,
                "dram_per_inf_mb": res.dram_bytes_per_inference / 2**20,
                "tenants": len(res.tasks),
                "departed": departed,
            }
            if verbose:
                m = row[sched]
                print(f"  [rate {rate:5.0f}/s] {sched:9s} "
                      f"{m['throughput']:7.0f} inf/s  "
                      f"lat {m['avg_latency_ms']:6.2f} ms  "
                      f"dram {m['dram_per_inf_mb']:6.1f} MB/inf  "
                      f"({m['departed']}/{m['tenants']} departed)")
        out[f"{rate:.0f}"] = row
    return out


def main() -> None:
    us, r = timed(lambda: run())
    mid = r[f"{RATES[1]:.0f}"]
    gain = mid["camdn"]["throughput"] / max(mid["baseline"]["throughput"], 1e-9)
    emit("arrival_sweep", us,
         f"camdn/baseline throughput x{gain:.2f} at {RATES[1]:.0f}/s churn|"
         f"camdn lat {mid['camdn']['avg_latency_ms']:.2f}ms")


if __name__ == "__main__":
    main()
