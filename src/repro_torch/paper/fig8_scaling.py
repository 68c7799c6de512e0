# Verbatim copy of benchmarks/fig8_scaling.py (lines 1-51: Fig. 8; run :16,
# main :41); only its imports differ: repro. becomes repro_torch. and
# benchmarks.common becomes repro_torch.paper.common. Run it as `python -m
# repro_torch.paper.fig8_scaling`; it prints what `python
# benchmarks/fig8_scaling.py` prints. It imports no framework.
"""Fig. 8 reproduction: average latency and memory access vs system
scale (cache 4..64MB, 1..16 co-located DNNs), CaMDN(Full) vs baseline.

Paper claims: 34.3%..42.3% latency reduction, 16.0%..37.7% memory-access
reduction across scales.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core.cache import CacheConfig
from repro_torch.sim.driver import SimConfig
from repro_torch.paper.common import emit, mixed_tenants, run_sim, timed


def run(verbose: bool = True) -> Dict:
    out = {}
    lat_reds, mem_reds = [], []
    for cache_mb in (4, 16, 64):
        for n in (4, 8, 16):
            cfg = SimConfig(cache=CacheConfig(
                total_bytes=cache_mb * 2**20,
                num_slices=4 if cache_mb == 4 else 8))
            tenants = mixed_tenants(n)
            base = run_sim(tenants, "baseline", cfg, dur=0.2)
            full = run_sim(tenants, "camdn", cfg, dur=0.2)
            lat_red = 1 - full.avg_latency / base.avg_latency
            mem_red = 1 - (full.traffic.dram_total / full.total_inferences) / \
                (base.traffic.dram_total / base.total_inferences)
            out[(cache_mb, n)] = (lat_red, mem_red)
            lat_reds.append(lat_red)
            mem_reds.append(mem_red)
            if verbose:
                print(f"  [{cache_mb}MB, {n} DNNs] latency -{lat_red * 100:.1f}%, "
                      f"mem -{mem_red * 100:.1f}%")
    out["lat_range"] = (min(lat_reds), max(lat_reds))
    out["mem_range"] = (min(mem_reds), max(mem_reds))
    return out


def main() -> None:
    us, r = timed(lambda: run())
    lo, hi = r["lat_range"]
    mlo, mhi = r["mem_range"]
    emit("fig8_scaling", us,
         f"lat -{lo * 100:.1f}..-{hi * 100:.1f}% (paper 34.3..42.3)|"
         f"mem -{mlo * 100:.1f}..-{mhi * 100:.1f}% (paper 16.0..37.7)")


if __name__ == "__main__":
    main()
