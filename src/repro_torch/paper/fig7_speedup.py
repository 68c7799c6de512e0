# Verbatim copy of benchmarks/fig7_speedup.py (lines 1-46: Fig. 7; run :15,
# main :37); only its imports differ: repro. becomes repro_torch. and
# benchmarks.common becomes repro_torch.paper.common. Run it as `python -m
# repro_torch.paper.fig7_speedup`; it prints what `python
# benchmarks/fig7_speedup.py` prints. It imports no framework.
"""Fig. 7 reproduction: model-wise speedup of CaMDN at 16 busy NPUs.

Paper claims: CaMDN(Full) 1.88x average (up to 2.56x, highest on
MobileNet-v2 / EfficientNet-b0); Full surpasses HW-only by ~1.18x.
The baseline stands in for MoCA/AuRORA, which 'are essentially for
improving QoS rather than speedup and show similar results here'
(paper IV-B1) — their bandwidth reallocation is exercised in fig9.
"""
from __future__ import annotations

from repro_torch.paper.common import (dram_by_model, emit, latency_by_model,
                                      mixed_tenants, run_sim, timed)


def run(verbose: bool = True):
    tenants = mixed_tenants(16)
    base = run_sim(tenants, "baseline", dur=0.4)
    hw = run_sim(tenants, "camdn_hw", dur=0.4)
    full = run_sim(tenants, "camdn", dur=0.4)
    bl = latency_by_model(base)
    sp_full = {m: bl[m] / v for m, v in latency_by_model(full).items()}
    sp_hw = {m: bl[m] / v for m, v in latency_by_model(hw).items()}
    if verbose:
        for m in sorted(sp_full):
            print(f"  {m:16s} full {sp_full[m]:.2f}x  hw-only {sp_hw[m]:.2f}x")
    avg_full = sum(sp_full.values()) / len(sp_full)
    avg_hw = sum(sp_hw.values()) / len(sp_hw)
    db, dc = dram_by_model(base), dram_by_model(full)
    reds = [1 - dc[m] / db[m] for m in db if m in dc]
    return {
        "avg_full": avg_full, "max_full": max(sp_full.values()),
        "avg_hw": avg_hw, "full_over_hw": avg_full / avg_hw,
        "mem_reduction": sum(reds) / len(reds),
    }


def main() -> None:
    us, r = timed(lambda: run())
    emit("fig7_speedup", us,
         f"avg {r['avg_full']:.2f}x (paper 1.88)|max {r['max_full']:.2f}x "
         f"(paper 2.56)|full/hw {r['full_over_hw']:.2f}x (paper 1.18)|"
         f"memred {r['mem_reduction'] * 100:.1f}% (paper 33.4)")


if __name__ == "__main__":
    main()
