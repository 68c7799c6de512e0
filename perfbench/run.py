"""Run one cell of the benchmark once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (``BENCHMARK.json`` names the cells).  The
last line of standard output is the result, one JSON object; with
``--trace 0`` its metrics are the cell's end-to-end ones, with
``--trace 1`` its per-layer ones.  The numbers the correctness check
compared are the last lines of standard error.  Exits non-zero, with no
result, without the CUDA devices the cell needs or where anything of
JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    import torch
    from perfbench import harness
    cell = harness.load_cell(args.workload, ROOT / "BENCHMARK.json")
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"[perfbench] {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda:0", T_PROCESS)
    found = harness.forbidden_modules()
    if found:
        print(f"[perfbench] JAX or the JAX package was loaded: {found}",
              file=sys.stderr)
        return 2
    result, info = out["result"], out["info"]
    print(json.dumps({"info": info}, default=str))
    print(json.dumps(result))
    for name, c in result["checks"].items():
        side = "at least" if c.get("min") else "at most"
        print(f"check {name}: {c['value']} ({side} {c['limit']})",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
