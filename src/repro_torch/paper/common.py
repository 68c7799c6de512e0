# Verbatim copy of benchmarks/common.py (lines 1-52: the figure drivers'
# shared helpers; mixed_tenants :16, run_sim :24, latency_by_model :30,
# dram_by_model :34, timed :42, emit :48); only the package name in its
# imports differs. It imports no framework, and nothing in repro_torch.paper
# writes a file: emit() prints the CSV line and fills RESULTS.
"""Shared helpers for the benchmark harness."""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.sim.driver import MultiTenantSim, SimConfig, SimResult
from repro_torch.sim.workloads import benchmark_models

# every emit() lands here so the harness can dump a machine-readable
# BENCH_nec.json next to the human-readable CSV (perf trajectory,
# CI regression gate) — see benchmarks/run.py
RESULTS: Dict[str, Dict] = {}


def mixed_tenants(n: int) -> list:
    """n tenants cycling through the 8 paper models (paper IV-A4:
    random dispatch over the model mix)."""
    models = benchmark_models()
    names = list(models)
    return [models[names[i % len(names)]] for i in range(n)]


def run_sim(tenants, sched: str, cfg: SimConfig = None,
            dur: float = 0.25) -> SimResult:
    sim = MultiTenantSim(tenants, sched, cfg)
    return sim.run(duration_s=dur)


def latency_by_model(res: SimResult) -> Dict[str, float]:
    return res.avg_latency_by_model()


def dram_by_model(res: SimResult) -> Dict[str, float]:
    out: Dict[str, list] = {}
    for t in res.tasks:
        if t.inferences:
            out.setdefault(t.model, []).append(t.dram_per_inference)
    return {m: sum(v) / len(v) for m, v in out.items()}


def timed(fn: Callable) -> Tuple[float, object]:
    t0 = time.time()
    out = fn()
    return (time.time() - t0) * 1e6, out


def emit(name: str, us: float, derived: str,
         extra: Optional[Dict] = None) -> None:
    RESULTS[name] = {"us_per_call": round(us, 1), "derived": derived,
                     **(extra or {})}
    print(f"{name},{us:.0f},{derived}", flush=True)
