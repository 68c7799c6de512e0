# Verbatim copy of benchmarks/fig3_reuse.py (lines 1-35: Fig. 3; run :14,
# main :26); only its imports differ: repro. becomes repro_torch. and
# benchmarks.common becomes repro_torch.paper.common. Run it as `python -m
# repro_torch.paper.fig3_reuse`; it prints what `python
# benchmarks/fig3_reuse.py` prints. It imports no framework.
"""Fig. 3 reproduction: reuse-count and reuse-distance statistics of the
benchmark DNNs on shared cache.

Paper claims: 68.0% of data has no future reuse; 61.8% of intermediates
have reuse distance > 1MB, 47.9% > 2MB.
"""
from __future__ import annotations

from repro_torch.sim.reuse import aggregate_reuse_stats, model_reuse_stats
from repro_torch.sim.workloads import benchmark_models
from repro_torch.paper.common import emit, timed


def run(verbose: bool = True):
    models = benchmark_models()
    agg = aggregate_reuse_stats(list(models.values()), co_runners=1)
    if verbose:
        for name, g in models.items():
            s = model_reuse_stats(g, co_runners=1)
            print(f"  {name}: no-reuse {s.pct_no_reuse:.1f}%, "
                  f">1MB {s.pct_distance_over(2**20):.1f}%, "
                  f">2MB {s.pct_distance_over(2 * 2**20):.1f}%")
    return agg


def main() -> None:
    us, agg = timed(lambda: run())
    emit("fig3_reuse", us,
         f"no-reuse {agg.pct_no_reuse:.1f}% (paper 68.0)|"
         f">1MB {agg.pct_distance_over(2**20):.1f}% (paper 61.8)|"
         f">2MB {agg.pct_distance_over(2 * 2**20):.1f}% (paper 47.9)")


if __name__ == "__main__":
    main()
