"""Roofline table and the quantized-KV roofline gate (counterpart of
benchmarks/roofline.py, kept in the package: the benchmark folder is the
reference's).

Reads the port's dry-run reports (experiments/dryrun_torch/*.json,
``launch/dryrun.py``) and prints the per-(arch x shape) roofline terms,
dominant bottleneck, and MODEL_FLOPS / traced FLOPs useful-compute
ratio.  The terms divide by the card's peaks (``cost_analysis.HARDWARE``):
they are predictions at those constants, not measurements.

  PYTHONPATH=src python -m repro_torch.launch.roofline            # table
  PYTHONPATH=src python -m repro_torch.launch.roofline --csv      # csv
  PYTHONPATH=src python -m repro_torch.launch.roofline --quant    # gate
"""
from __future__ import annotations

import argparse
import json
import pathlib
from typing import Dict, List, Optional

from repro_torch.launch.cost_analysis import CPU_STAND_IN, HARDWARE

REPORT_DIR = (pathlib.Path(__file__).resolve().parents[3] / "experiments"
              / "dryrun_torch")


def load_reports(mesh: str = "16x16", opt: Optional[str] = None) -> List[Dict]:
    out = []
    for f in sorted(REPORT_DIR.glob("*.json")):
        rep = json.loads(f.read_text())
        if rep.get("mesh") != mesh:
            continue
        stem_opt = f.stem.split("__")[3] if f.stem.count("__") >= 3 else "base"
        if (opt or "base") != stem_opt:
            continue
        out.append(rep)
    return out


def fmt_row(rep: Dict) -> str:
    a, s = rep["arch"], rep["shape"]
    if rep.get("status") == "skip":
        return f"{a:24s} {s:12s} SKIP ({rep.get('reason', '')[:40]})"
    if rep.get("status") == "fail":
        return f"{a:24s} {s:12s} FAIL"
    rf = rep.get("roofline")
    if not rf:
        return f"{a:24s} {s:12s} ok (no roofline)"
    dom = rf["dominant"]
    bound = max(rf["compute_s"], rf["memory_s"], rf["collective_s"])
    frac = rf["compute_s"] / bound if bound else 0.0
    return (f"{a:24s} {s:12s} C={rf['compute_s'] * 1e3:9.2f}ms "
            f"M={rf['memory_s'] * 1e3:9.2f}ms "
            f"X={rf['collective_s'] * 1e3:9.2f}ms "
            f"dom={dom:10s} roofline-frac={frac:5.2f} "
            f"useful={rf.get('useful_ratio', 0):.2f}")


# ------------------------------------------------------ quantized KV --
# Tensor-core-to-HBM balance point (FLOPs per HBM byte) below which a
# kernel is memory-bound: the H100's dense bf16 rate over its HBM rate,
# about 295 (the v5e's MXU ridge was 240).  Serving-shape attention sits
# far under it, which is why narrowing the KV stream converts directly
# into step-time headroom.
RIDGE_FLOPS_PER_BYTE = (HARDWARE[CPU_STAND_IN]["peak_flops"]
                        / HARDWARE[CPU_STAND_IN]["hbm_bw"])
KV_SCALE_BYTES = 4


def flash_traffic_bytes(B: int, H: int, S: int, Sk: int, hd: int, *,
                        q_bytes: int, kv_bytes: int, block_q: int = 128,
                        scaled: bool = False) -> int:
    """HBM bytes one ``flash_attention`` / ``flash_attention_quantized``
    call moves, derived from the reference kernel's BlockSpec fetch
    pattern (src/repro/kernels/flash_attention.py): the q block is
    fetched once per (head, q-block) grid step (index map ``(h, i,
    0)``), K and V stream fully once per q block (map ``(h//groups, j,
    0)``), a quantized cache's per-row fp32 scale stripes ride the same
    kv map at ``KV_SCALE_BYTES``/row, and the output writes once.  The
    dequant is in-register, so the quantized variant's K/V term is
    priced at the storage width — no materialized fp copy ever hits
    HBM."""
    bq = min(block_q, S)
    passes = B * H * ((S + bq - 1) // bq)       # kv streams per q block
    q = B * H * S * hd * q_bytes
    kv = 2 * passes * Sk * hd * kv_bytes
    scale = 2 * passes * Sk * KV_SCALE_BYTES if scaled else 0
    out = B * H * S * hd * q_bytes
    return q + kv + scale + out


def flash_flops(B: int, H: int, S: int, Sk: int, hd: int) -> int:
    """QK^T + PV dominant FLOPs (2 MACs per element per contraction)."""
    return 4 * B * H * S * Sk * hd


def quant_attention_roofline(B: int = 1, H: int = 4, S: int = 128,
                             Sk: int = 1024, hd: int = 32,
                             native_bytes: int = 4) -> Dict[str, float]:
    """Analytic roofline comparison of the native vs dequant-fused
    quantized flash kernel at one serving shape.  ``materialized`` is
    the traffic of the fallback a fused kernel avoids: a separate
    dequant pass (read quantized + write fp) followed by the native
    kernel reading the fp copy."""
    kw = dict(q_bytes=native_bytes, block_q=128)
    native = flash_traffic_bytes(B, H, S, Sk, hd, kv_bytes=native_bytes,
                                 **kw)
    quant = flash_traffic_bytes(B, H, S, Sk, hd, kv_bytes=1, scaled=True,
                                **kw)
    kv_rows = 2 * B * H * Sk * hd
    materialized = (kv_rows * (1 + native_bytes)   # dequant pass: r q, w fp
                    + native)                      # then the fp kernel
    flops = flash_flops(B, H, S, Sk, hd)
    return {
        "flops": float(flops),
        "native_bytes": float(native),
        "quant_bytes": float(quant),
        "ai_native": flops / native,
        "ai_quant": flops / quant,
        "ai_gain": native / quant,
        "traffic_ratio": native / quant,
        "fused_vs_materialized": materialized / quant,
    }


def check_quant_rooflines(verbose: bool = True) -> int:
    """Gate for the dequant-fused kernels (``--quant``).

    1. **Pricing consistency**: the BlockSpec-derived KV stream ratio
       (native width vs quantized width + scale stripe) must agree with
       the allocator's per-row page pricing (core.vmem.kv_row_bytes) to
       within 1% — the grant accounting and the kernel's actual HBM
       stream are two independent derivations of the same bytes.
    2. **Residency gain**: traffic/AI gain >= 1.8x at the reduced
       serving config (fp32 activations, hd=32 — analytically ~3.56x).
    3. **Memory-bound-optimal**: both kernels sit below the ridge at
       serving shapes (narrower KV converts to time), and the fused
       kernel moves less than the materialize-then-flash fallback.
    Returns the number of failed checks."""
    from repro_torch.core.vmem import kv_row_bytes

    failures = []
    hd, eb, kvh = 32, 4, 4                    # reduced() serving config
    row_ratio = (kv_row_bytes(kvh, hd, eb, scaled=False)
                 / kv_row_bytes(kvh, hd, 1, scaled=True))
    stream_ratio = (hd * eb) / (hd * 1 + KV_SCALE_BYTES)
    if abs(row_ratio - stream_ratio) / stream_ratio > 0.01:
        failures.append(
            f"page pricing ({row_ratio:.3f}x) disagrees with the BlockSpec "
            f"stream model ({stream_ratio:.3f}x)")
    shapes = [("decode-window", dict(B=1, H=4, S=128, Sk=1024)),
              ("prefill", dict(B=1, H=4, S=1024, Sk=1024))]
    rows = []
    for name, kw in shapes:
        r = quant_attention_roofline(hd=hd, native_bytes=eb, **kw)
        rows.append((name, r))
        if r["ai_gain"] < 1.8:
            failures.append(f"{name}: AI gain {r['ai_gain']:.2f}x below the "
                            f"1.8x floor")
        if r["ai_quant"] >= RIDGE_FLOPS_PER_BYTE:
            failures.append(f"{name}: quant AI {r['ai_quant']:.1f} is not "
                            f"memory-bound (ridge {RIDGE_FLOPS_PER_BYTE})")
        if r["fused_vs_materialized"] < 1.5:
            failures.append(f"{name}: fused kernel saves only "
                            f"{r['fused_vs_materialized']:.2f}x vs a "
                            f"materialized dequant pass")
    if verbose:
        for name, r in rows:
            print(f"[roofline] quant {name}: AI {r['ai_native']:.1f} -> "
                  f"{r['ai_quant']:.1f} FLOPs/B ({r['ai_gain']:.2f}x), "
                  f"fused saves {r['fused_vs_materialized']:.2f}x vs "
                  f"materialized dequant")
        for f in failures:
            print(f"[roofline] FAIL {f}")
    return len(failures)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--opt", default=None)
    ap.add_argument("--csv", action="store_true")
    ap.add_argument("--quant", action="store_true",
                    help="print + gate the quantized-kernel rooflines")
    args = ap.parse_args(argv)
    if args.quant:
        return 1 if check_quant_rooflines() else 0
    reps = load_reports(args.mesh, args.opt)
    if args.csv:
        print("arch,shape,compute_s,memory_s,collective_s,dominant,"
              "useful_ratio,status")
        for r in reps:
            rf = r.get("roofline") or {}
            print(f"{r['arch']},{r['shape']},{rf.get('compute_s', '')},"
                  f"{rf.get('memory_s', '')},{rf.get('collective_s', '')},"
                  f"{rf.get('dominant', '')},{rf.get('useful_ratio', '')},"
                  f"{r['status']}")
        return 0
    print(f"Roofline table (mesh {args.mesh}, opt {args.opt or 'base'}) — "
          f"C=compute, M=memory(HBM), X=collective(NVLink):")
    for r in reps:
        print("  " + fmt_row(r))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
