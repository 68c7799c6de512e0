# Verbatim copy of benchmarks/table3_area.py (lines 1-30: Table III; run :9,
# main :20); only its imports differ: repro. becomes repro_torch. and
# benchmarks.common becomes repro_torch.paper.common. Run it as `python -m
# repro_torch.paper.table3_area`; it prints what `python
# benchmarks/table3_area.py` prints. It imports no framework.
"""Table III reproduction: area breakdown of CaMDN's hardware additions
(45nm analytic model; paper: CPT = 0.9% of NPU, NEC = 0.3% of slice)."""
from __future__ import annotations

from repro_torch.sim.area import table3
from repro_torch.paper.common import emit, timed


def run(verbose: bool = True):
    t = table3()
    if verbose:
        for part, label in (("npu", "NPU"), ("slice", "Cache Slice")):
            print(f"  {label}:")
            for k, v in t[part].items():
                print(f"    {k:12s} {v / 1e3:8.0f}k um^2  "
                      f"({t[part + '_pct'][k]:5.1f}%)")
    return t


def main() -> None:
    us, t = timed(lambda: run())
    emit("table3_area", us,
         f"CPT {t['npu_pct']['CPT']:.1f}% of NPU (paper 0.9)|"
         f"NEC {t['slice_pct']['NEC']:.1f}% of slice (paper 0.3)|"
         f"NPU {t['npu']['NPU'] / 1e3:.0f}k um2 (paper 7905k)|"
         f"slice {t['slice']['Cache Slice'] / 1e3:.0f}k um2 (paper 24676k)")


if __name__ == "__main__":
    main()
