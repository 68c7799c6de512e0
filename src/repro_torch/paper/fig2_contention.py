# Verbatim copy of benchmarks/fig2_contention.py (lines 1-91: Fig. 2;
# distinct_tenants :23, run :45, main :81); only its imports differ: repro.
# becomes repro_torch. and benchmarks.common becomes
# repro_torch.paper.common. Run it as `python -m
# repro_torch.paper.fig2_contention`; it prints what `python
# benchmarks/fig2_contention.py` prints. It imports no framework.
"""Fig. 2 reproduction: cache hit rate, memory access, and average
latency vs number of co-located DNNs and cache capacity, transparent
baseline.

x-axis = number of distinct co-located DNN tasks.  Metrics are
per-model normalized against that model's own single-task run (full
cache + bandwidth), then averaged — isolating contention from
workload-mix shifts.

Paper claims (1 -> 32 DNNs): hit rate -18.9%..-59.7%, memory access
+32.7%..+64.1%, avg latency 3.46x..5.65x.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core.cache import CacheConfig
from repro_torch.sim.driver import SimConfig
from repro_torch.sim.workloads import benchmark_models
from repro_torch.paper.common import emit, run_sim, timed


def distinct_tenants(n_distinct: int):
    models = benchmark_models()
    names = list(models)
    picks = [names[i % len(names)] for i in range(n_distinct)]
    tasks = max(16, n_distinct)
    return [models[picks[i % n_distinct]] for i in range(tasks)]


def _per_model(res):
    dram, lat, hits, acc = {}, {}, {}, {}
    for t in res.tasks:
        if not t.inferences:
            continue
        dram.setdefault(t.model, []).append(t.dram_per_inference)
        lat.setdefault(t.model, []).append(t.avg_latency)
        hits.setdefault(t.model, []).append(t.traffic.hits)
        acc.setdefault(t.model, []).append(t.traffic.accesses)
    avg = lambda d: {m: sum(v) / len(v) for m, v in d.items()}
    hr = {m: sum(hits[m]) / max(sum(acc[m]), 1) for m in hits}
    return avg(dram), avg(lat), hr


def run(verbose: bool = True) -> Dict:
    models = benchmark_models()
    out = {}
    for cache_mb in (8, 16, 32):
        cfg = SimConfig(cache=CacheConfig(total_bytes=cache_mb * 2**20))
        # single-DNN reference per model: ONE task alone (full cache + BW)
        ref_d, ref_l, ref_h = {}, {}, {}
        for name, g in models.items():
            res = run_sim([g], "baseline", cfg, dur=0.06)
            d, l, h = _per_model(res)
            ref_d.update(d), ref_l.update(l), ref_h.update(h)
        series = {1: {"mem_x": 1.0, "lat_x": 1.0, "hit_x": 1.0,
                      "hit_abs": sum(ref_h.values()) / len(ref_h)}}
        for n in (4, 8, 16, 32):
            res = run_sim(distinct_tenants(n), "baseline", cfg,
                          dur=0.1 if n <= 16 else 0.15)
            d, l, h = _per_model(res)
            common = [m for m in d if m in ref_d]
            # aggregate-byte ratio (the paper's "memory access" metric)
            memx_w = sum(d[m] for m in common) / sum(ref_d[m] for m in common)
            latx = [l[m] / ref_l[m] for m in l if m in ref_l]
            hitx = [h[m] / ref_h[m] for m in h if ref_h.get(m)]
            series[n] = {
                "mem_x": memx_w,
                "lat_x": sum(latx) / len(latx),
                "hit_x": sum(hitx) / len(hitx),
                "hit_abs": sum(h.values()) / len(h),
            }
        out[cache_mb] = series
        if verbose:
            w = series[32]
            print(f"  [{cache_mb}MB] 32 DNNs: mem x{w['mem_x']:.2f}, "
                  f"lat x{w['lat_x']:.2f}, hit {100 * (w['hit_x'] - 1):+.1f}%")
    return out


def main() -> None:
    us, out = timed(lambda: run())
    s = out[16][32]
    emit("fig2_contention", us,
         f"mem+{(s['mem_x'] - 1) * 100:.1f}%|lat x{s['lat_x']:.2f}|"
         f"hit{(s['hit_x'] - 1) * 100:+.1f}% "
         f"(paper: mem +32.7..64.1% lat x3.46..5.65 hit -18.9..-59.7%)")


if __name__ == "__main__":
    main()
