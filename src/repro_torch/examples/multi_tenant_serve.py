"""End-to-end serving driver: multi-tenant inference with CaMDN (port of
examples/multi_tenant_serve.py).

Continuous-batching serving: resident tenants decode while new tenants
arrive mid-run with prompts, each prompt prefilled as a sequence of
cache-aware chunks.  The CaMDN allocator arbitrates the shared page pool
per chunk, and the granted Selection lowers to both the kernel variant
(LBM fused FFN or LWM tiles) and the chunk length, so the chunk sizes
follow the grants as tenants come and go.

    python -m repro_torch.examples.multi_tenant_serve [--pages 48]

With a tight pool (``--pages 24``) arrivals get starved grants: prefill
degrades to one-LANE chunks and decode drops from LBM to small LWM
candidates.  ``--admission sequential`` is the static-batching baseline
(arrivals wait for the batch to drain, then prefill the whole prompt):
decode outputs are bit-identical, TTFT is not.

Fleet mode: ``--devices N`` serves the same workload over N replicas
behind the least-loaded admission router, each with its own CaMDN
allocator; replica r runs on card ``r % device_count`` (every replica on
the CPU under ``--device cpu``), where the reference splits the host
into N XLA devices.

    python -m repro_torch.examples.multi_tenant_serve --devices 2

Added to the reference's flags: ``--device`` (default ``cuda``) and
``--full-width`` (serve the full-width configs; default: the reduced
ones, as the reference always serves).  :func:`main` takes the argument
list and the servers' injection hooks (``params_fn`` / ``prompt_fn``,
as tests pass the reference's), and returns each run's result.
"""
from __future__ import annotations

import argparse
import gc
from typing import Any, List, Optional, Tuple

import torch

from repro_torch.launch.serve import FleetServer, MultiTenantServer
from repro_torch.sim.driver import TenantSpec


def _report(out):
    for tid, info in out["tenants"].items():
        line = (f"  {tid}: {info['tokens']} tokens | "
                f"LBM {info['lbm_frac'] * 100:.0f}% | "
                f"last grants {info['choices']}")
        if info["prompt_len"]:
            ttft = info["ttft_s"]
            line += (f" | prompt {info['prompt_len']} in chunks "
                     f"{info['prefill_chunks']} | "
                     + (f"TTFT {ttft * 1e3:.0f}ms" if ttft is not None
                        else "TTFT -"))
            # best-effort KV reservation: flag admissions the pool
            # could only partially back (kv_reserved < kv_wanted)
            line += f" | kv {info['kv_reserved']}/{info['kv_wanted']}p"
            if info["kv_reserved"] < info["kv_wanted"]:
                line += " (degraded)"
        if info["departed"]:
            line += " | departed (pages reclaimed)"
        print(line)
    p95 = (f", p95 TTFT {out['p95_ttft_s'] * 1e3:.0f}ms"
           if out["p95_ttft_s"] is not None else "")
    print(f"  throughput {out['tokens_per_s']:.1f} tok/s{p95}; "
          f"modeled DRAM {out['dram_bytes'] / 2**20:.1f} MB")


def _release(device: torch.device) -> None:
    """Free a finished server's tensors before the next one is built (at
    full width two servers' weights need not fit together)."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def main(argv: Optional[List[str]] = None,
         **server_kw: Any) -> List[Tuple[str, dict]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", nargs="+",
                    default=["granite-3-8b", "olmoe-1b-7b", "mamba2-370m"])
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--pages", type=int, default=48)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--admission", default="interleaved",
                    choices=["interleaved", "sequential"])
    ap.add_argument("--devices", type=int, default=0,
                    help="fleet mode: serve the workload over N replicas, "
                         "replica r on card r %% device_count (every "
                         "replica on the CPU under --device cpu), each "
                         "with its own CaMDN allocator")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on")
    ap.add_argument("--full-width", action="store_true",
                    help="serve the full-width configs (default: reduced)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    kw = dict(reduced=not args.full_width, **server_kw)

    arrivals = [
        TenantSpec("olmoe-1b-7b", arrive_at=4.0, n_inferences=16,
                   prompt_len=args.prompt_len),
        TenantSpec("mamba2-370m", arrive_at=8.0, n_inferences=16,
                   prompt_len=args.prompt_len),
    ]

    if args.devices > 0:
        cards = max(1, torch.cuda.device_count())
        devices = [torch.device("cuda", r % cards) if device.type == "cuda"
                   else device for r in range(args.devices)]
        print(f"fleet: {args.devices} replica chips x {args.pages} pages, "
              f"least-loaded admission of {len(args.archs)} resident + "
              f"{len(arrivals)} arriving tenants "
              f"(on {', '.join(map(str, devices))})")
        fleet = FleetServer(n_replicas=args.devices, devices=devices,
                            arch_ids=args.archs,
                            pages_per_replica=args.pages,
                            max_len=2 * args.prompt_len, tenants=arrivals,
                            **kw)
        out = fleet.run(args.steps)
        for rep in out["replicas"]:
            print(f"  {rep['replica']}: {rep['tokens_served']} tokens | "
                  f"page util {rep['page_util_mean'] * 100:.0f}% | "
                  f"tenants {rep['tenants']}")
        print("  routed: " + ", ".join(
            f"{tid}->r{r}" for tid, r in out["routes"]))
        p95 = (f", p95 TTFT {out['p95_ttft_s'] * 1e3:.0f}ms"
               if out["p95_ttft_s"] is not None else "")
        print(f"  fleet throughput {out['tokens_per_s']:.1f} tok/s, "
              f"page-util balance {out['page_util_balance']:.2f}{p95}")
        return [("fleet", out)]

    print(f"serving {args.archs} with a {args.pages}-page shared pool; "
          f"2 tenants arrive mid-run with {args.prompt_len}-token prompts "
          f"({args.admission} admission)")
    srv = MultiTenantServer(args.archs, total_pages=args.pages,
                            max_len=2 * args.prompt_len,
                            tenants=arrivals, admission=args.admission,
                            device=device, **kw)
    out = srv.run(args.steps)
    _report(out)
    del srv
    _release(device)

    print("\ncontended pool (a third of the pages): chunk sizes and "
          "kernel grants shrink, and grow back when a tenant departs")
    srv2 = MultiTenantServer(args.archs,
                             total_pages=max(args.pages // 3, 8),
                             max_len=2 * args.prompt_len,
                             tenants=[TenantSpec(
                                 "olmoe-1b-7b", arrive_at=2.0,
                                 n_inferences=8,
                                 prompt_len=args.prompt_len)],
                             admission=args.admission, device=device, **kw)
    out2 = srv2.run(args.steps)
    _report(out2)
    del srv2
    _release(device)
    return [("serve", out), ("contended", out2)]


if __name__ == "__main__":
    main()
