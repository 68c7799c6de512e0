"""Readings that set a cell's limit: the program's widest logit gap and
the control's, seed by seed, on the chip.

    python3 perfbench/control.py --workload <name> --seconds <s> --seeds 11 12 13

Each seed is one run of the cell as ``run.py`` makes it (set-up, window,
drain), in one process, followed by the comparison of the same sampled
rows twice: the served tokens against the float32 reference (the
program's reading) and, at the same positions, the token the fp8
reference puts first (the control's), each held to the cell's limits
(``correct`` and ``control_correct``: the control must come out not
correct).  The benchmark's own runs never compute the control.  One
JSON line per seed, then a summary.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch
    from perfbench import harness
    if not torch.cuda.is_available():
        print("[control] needs a CUDA device", file=sys.stderr)
        return 1
    cell = harness.load_cell(args.workload, ROOT / "BENCHMARK.json")
    rows = []
    t0 = T_PROCESS
    for seed in args.seeds:
        out = harness.run_cell(cell, seed, args.seconds, False, "cuda:0", t0,
                               control=True)
        info = out["info"]
        row = {"seed": seed, "program": info["readings"],
               "control": info["control"], "correct": out["result"]["correct"],
               "control_correct": info["control_correct"],
               "control_checks": info["control_checks"],
               "tokens": info["tokens_compared"],
               "requests": [{k: r.get(k) for k in (
                   "kind", "prompt_len", "served", "tokens", "gap", "missed",
                   "control_gap", "control_missed", "where")}
                   for r in info["reference"]]}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
    summary = {"workload": args.workload,
               "program_correct_on_every_seed": all(r["correct"] for r in rows),
               "control_correct_on_no_seed": not any(r["control_correct"]
                                                     for r in rows)}
    for side in ("program", "control"):
        for k in rows[0][side]:
            vals = [r[side][k] for r in rows]
            summary[f"{side}.{k}"] = [min(vals), max(vals)]
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
