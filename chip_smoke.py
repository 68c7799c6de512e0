#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON object with its seconds:

* ``device``: the card (``nvidia-smi`` name and power limit, SMs, shared
  memory per block, L2).
* ``build``: compiles the port's CUDA kernels from ``src/repro_torch/csrc``
  (cache_matmul, cache_matmul_quant, block_fused_ffn, flash_attention,
  ssd_chunk) with ``nvcc`` for ``sm_90a``, one compiler per source, all
  at once; records each gemv / wgmma kernel's registers and spills and
  each library's wgmma (HGMMA) and TMA load instructions.
* ``kernels``: holds each kernel against its plain PyTorch version on the
  card, in bf16 and fp32 (TF32 off): the matmul and FFN kernels at
  full-width yi-9b decode shapes, a 256-row prefill-sized shape and a
  ragged one; flash attention native and quantized (int8, fp8) at the
  prefill path's shape, the MoE prefill's (olmoe: 16 K/V heads for 16
  query heads), non-causal, ragged and at hd 32, with the fp32
  quantized kernel bitwise equal to the native one on dequantized K/V;
  tiles and blocks lowered from full-width plans under several grants;
  cache_matmul_quant with int8 and fp8 codes at every compiled tile of
  the dtype, at the decode shapes, 256 and 2048 rows and ragged shapes
  (its gemv tile at up to 8 rows, its wgmma tile above); the fused FFN
  also at ragged rows, d_model and d_ff (its wgmma tile above 8 bf16
  rows, the 8-row simt tile below); ssd_chunk at
  full-width mamba2 heads (B/C per batch row) for chunks of 256, 128,
  64, a 44-token tail and 1, and at the reduced shape.  Then times each
  kernel at the shape of each path that runs it (the FFN kernels at
  decode and at the prefill's 2048 rows, ssd_chunk at the prefill's and
  a serving chunk's), checked against its plain version on the timed
  inputs.  Every row names its tile's kind: bf16 ``cache_matmul`` runs
  the gemv tile at up to 8 rows and a wgmma tile above (also at ragged
  rows, N and K), bf16 flash attention at hd 128 the wgmma kernel of
  its K/V storage (native, or int8 / fp8 codes), the bf16 fused FFN at
  the prefill's rows its cluster-reduced wgmma tile (beside its partial
  bytes and, as a yardstick of several calls, the unfused bf16 chain),
  bf16 ``ssd_chunk`` its wgmma kind, the rest the simt tiles; the gemv /
  wgmma tiles must repeat bitwise and are timed in turns against the
  simt tile of the same plan (``simt_ms``).
* ``e2e``: full-width yi-9b cut to 4 layers, random weights from one
  seed: prefill, then two teacher-forced decode epochs (an LBM plan and an
  LWM plan) with a native, an int8 and an fp8 KV cache, and
  ``make_prefill`` under an LBM plan with native KV and an LWM plan with
  int8 KV, on the card with the kernels, against the same entry points
  on the CPU with the same weights.
* ``serve``: slice 1's path.  ``MultiTenantServer`` serves two full-width,
  full-depth (48-layer) yi-9b tenants, one resident and one arriving with
  a 256-token prompt, for 32 steps.  The plan kinds must be those the
  scheduler (the reference's, copied) can grant at full width.  The
  kernels' launch counters are zeroed just before the run and read just
  after it; every cache_matmul launch must be of the gemv kind (so for
  e2e, self and prefill: no simt launch on the bf16 path).  The
  pipelined server dispatches every decode item and prompt chunk as a
  captured CUDA graph; the record holds its captures, capture seconds,
  graph pool bytes and program-cache counters.  Then three warm
  ``run()`` calls of the same server (the resident alone), each of which
  must build nothing (no capture, no LRU miss, ``epoch_compiles`` all
  0), with their median tokens/s and spread; then one replayed decode
  epoch is profiled for where the time goes.
* ``self``: serial (eager) against pipelined (graphs) serving on the
  card, token streams bitwise equal: full width (4 layers) in a starved
  pool, granted LWM, its two residents one bucket, and the reduced width
  in a pool where the scheduler grants LBM.
* ``graphs``: graph replay against eager dispatch at full width cut to
  4 layers: a yi-9b prompt tenant's chunks and epochs (native, then int8
  KV), a resident alone and two as a bucket, a mamba2 prompt's chunk and
  tail and its epochs; the eager run goes straight through the epoch /
  prefill core on cloned caches, tokens and positions.  Tokens and every
  cache buffer bitwise, the replay's launch counts equal the eager
  run's, and each decode item's second replay captures nothing.
* ``prefill``: slice 2's path.  ``make_prefill`` of full-width,
  full-depth yi-9b (2 prompts of 1024 tokens) plain, under the smallest
  LBM grant that lowers fused with native KV, and under 32-page LWM
  grants with int8 and fp8 KV; counters zeroed just before and read just
  after one pass of the four (every block_fused_ffn launch and every
  quantized flash launch of the wgmma kind); gated against the plain
  path on the card (int8 and fp8 also by cosine and against a control
  with the plain attention, traced layer by layer); timed, and profiled
  once per plan kind (LBM/native, LWM/int8, LWM/fp8).
* ``serve_kv``: slice 3's serving path.  ``MultiTenantServer(kv_dtype=
  "auto")`` serves full-width, full-depth yi-9b: a resident tenant and
  three 256-token prompt tenants arriving at distinct steps on one
  weight set, in a pool where the precision ladder must place them on
  native, fp8_e4m3 and (partially reserved) int8; rungs, reservations,
  cache dtypes and page scales are gated.  Three warm runs (as serve's)
  and a replayed decode epoch of the resident profiled; one decode epoch
  is profiled eagerly with a native and an int8 cache.
* ``ffn_quant``: slice 3's kernel path.  ``ops.planned_ffn_quant`` over
  the 48 layers' FFN weights quantized to int8 and to fp8, at 2 and 2048
  rows, under the serve_kv decode plan, the LWM@32p prefill plan and a
  fused plan (the fallback tile); the launches of the gemv kind (2 rows)
  and the wgmma kind (2048 rows) counted, none of the simt kind; gated
  against the plain chain and against ``planned_ffn`` on the bf16
  weights, timed per pass, and cache_matmul_quant timed per GEMM, in
  turns against the simt tile of the same plan.
* ``e2e_ssm``: slice 4.  Full-width mamba2-370m cut to 4 layers, random
  weights from one seed: ``make_prefill`` of a 300-token prompt (a
  256-token chunk and a 44-token tail segment) under grants of 32, 16
  and 4 pages (SSD chunks 256, 128, 64), then a prefill and two
  teacher-forced decode epochs, on the card with ssd_chunk against the
  CPU with its plain version.  Records whether a chunked prefill
  (256 + 44) equals the one-shot one bitwise on the card.
* ``prefill_ssm``: ``make_prefill`` of full-depth (48-layer) mamba2 on 2
  prompts of 1024 tokens under the three grants; counters zeroed just
  before and read just after one pass of the three (every ssd_chunk
  launch of the wgmma kind, as in serve_ssm and self_ssm); the plans' logits
  gated against each other on an fp32 copy of the weights (SSD is exact
  under any chunking), and in bf16 relative to a plain-version control;
  timed warm, and profiled once.
* ``serve_ssm``: ``MultiTenantServer(["mamba2-370m"], reduced=False)``,
  full depth, batch 2, max_len 1024, a 6500-page pool: a resident and
  two arrivals at steps 4 and 8 with 512- and 300-token prompts and
  16-step budgets, whose 3113-page state reservations both fit whole;
  free pages at each admission, tokens/s, TTFT per arrival and peak
  memory reported; counters zeroed just before the run and read just
  after; three warm runs (as serve's); one replayed decode epoch and one
  prefill chunk profiled.
* ``self_ssm``: serial against pipelined serving of full-width,
  full-depth mamba2 on the card: two residents and a 300-token arrival
  whose prompt chunks run ssd_chunk; token streams bitwise equal,
  choices and prefill chunks equal, ssd_chunk launched.

* ``e2e_moe``: the MoE slice.  Full-width olmoe-1b-7b (64 experts of
  d_ff 1024, top-8) cut to 4 layers, random weights from one seed:
  ``make_prefill`` of a 40-token prompt under an LBM plan, an LWM native
  plan and an LWM int8 plan (each expert's FFN through the plan's
  kernels, every launch of the wgmma kind), then a teacher-forced decode
  epoch (the gathered-expert path), on the card against the CPU with the
  plain versions.
* ``prefill_moe``: ``make_prefill`` of full-depth olmoe on 2 prompts of
  1024 tokens (328 bucket rows an expert) plain, under the smallest LBM
  grant that lowers fused at d_ff 1024, and 32-page LWM grants with
  native and int8 KV, then ``make_prefill(cfg, serve=True)`` (2048
  drop-free rows an expert) under the LWM plan; counters zeroed just
  before and read just after the five calls (3,072 cache_matmul launches
  under LWM, 1,024 block_fused_ffn under LBM, 16 flash), every launch of
  the wgmma kind; each plan gated against the plain path (the int8 plan
  also as the prefill phase's, its run and the control's compared layer
  by layer: relative drift, routing flips, displaced tokens); timed warm
  and profiled.  ``prefill`` and ``prefill_moe`` run one function.  The
  kernels phase times cache_matmul at one expert's 328 and 2048 rows and
  block_fused_ffn at its 328 rows.
* ``serve_moe``: ``MultiTenantServer(["olmoe-1b-7b"], reduced=False)``,
  full depth, batch 2, max_len 512, 32 steps: a resident and a
  256-token arrival at step 8, in a 2600-page pool that holds the
  arrival's 2048-page reservation.  The server's MoE path runs no
  hand-written kernel (as the reference's: decode gathers the experts,
  prompt chunks run the plain buckets), so its counters must stay 0.
  Three warm runs and a replayed decode epoch profiled, with the expert
  gather's share: ``serve``'s function with these arguments.
* ``self_moe``: serial (eager) against pipelined (graphs) serving of two
  olmoe residents at full width cut to 4 layers, bitwise, as a bucket.
  The ``graphs`` phase holds an olmoe prompt tenant's chunks (256 + 128)
  and epochs, a resident alone and two as a bucket, replay == eager.
* ``serve_mix``: the reference CLI's default pool, yi-9b, olmoe-1b-7b
  and mamba2-370m at full width, through ``repro_torch.launch.serve
  .main`` in this process (``--full-width --arrivals 2 --prompt-len
  256``, a pool that holds each arch's native reservation); its printed
  lines, tokens/s, TTFTs and grant trace kept.

Then it prints the card's ``nvidia-smi`` line, the ``{"kernels": [...]}``
line, and last ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero.  With no CUDA device, or without the port's sources beside this
file, it exits non-zero and prints no result.  A fuller report goes to
``build/chip_smoke/`` (``chip_smoke.json``, the kernel cases, the
compiler logs).
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT_DIR = ROOT / "build" / "chip_smoke"

# H100 SXM data sheet: HBM3 bandwidth and dense bf16 tensor-core peak.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"bfloat16": 2e-2, "float32": 2e-3}     # tests/test_kernels.py::tol

SERVE_PAGES = 1800     # an LBM grant (324 pages, where one exists) fits
#                        before the arrival's KV reservation (1536 pages)
SERVE_STEPS = 32
# warm runs: more run() calls of a served server, each building nothing
# (its programs were captured in the first run); their steps keep the
# resident inside the 128-token window the cold run used, so every
# program key repeats
WARM_RUNS = 3
ARRIVAL = dict(arrive_at=8.0, prompt_len=256, n_inferences=16)
# serial vs pipelined: (width, pages).  Full width is granted LWM only, so
# the starved full-width pool holds cache_matmul; block_fused_ffn's
# bitwise contract is held at the reduced width, where the scheduler
# grants LBM.
SELF_POOLS = (("full", 16), ("reduced", 64))
# prefill and prefill_moe: make_prefill at 2 x 1024 tokens, full depth
PREFILL = dict(batch=2, prompt_len=1024, lwm_pages=32)
# quantized-KV serving: batch 2, three 256-token arrivals with a 16-step
# budget at distinct steps, beside a resident decoding for `steps` steps
SERVE_KV = dict(batch=2, max_len=512, prompt_len=256, budget=16, steps=40,
                warm_steps=24, arrive_at=(4.0, 8.0, 12.0))
# Cosine bars of the quantized-KV prefill against the plain path.  int8:
# tests/test_quant_decode.py's 0.999.  fp8_e4m3 keeps 3 mantissa bits, a
# per-element error about three times int8's at hd 128; over 48 layers
# of random weights it reaches 0.9989 with the plain attention as well
# as with the kernel (the control in prefill_main_path, PERF.md), so its
# bar is 0.998.
PREFILL_COSINE = {"int8": 0.999, "fp8_e4m3": 0.998}
KV_CACHES = ("int8", "fp8_e4m3")
ATTN_GRANTS = (9, 32, 60)                   # pages; lower_attn -> blocks
# cache_matmul parity at ragged rows (gemv at 1, 2, 7; wgmma above), N and
# K not multiples of the tiles; K = 333 sends bf16 at 37 rows to simt
MM_RAGGED = ((1, 333, 1000), (2, 520, 1000), (7, 333, 1000), (37, 333, 1000),
             (37, 520, 1000), (65, 4096, 1000), (300, 520, 1000),
             (300, 1000, 4104))
# cache_matmul_quant's ragged (M, K, N): gemv rows with K, N off the tile;
# wgmma rows with K % 8 == 0 and N % 16 == 0 (TMA) off the 64 x 256 tile
MQ_RAGGED = ((1, 333, 1000), (2, 520, 1000), (7, 333, 1000), (37, 520, 1008),
             (65, 4096, 1008), (300, 1000, 4112))
SSM_ARCH = "mamba2-370m"
# ssd_chunk cases: the chunks the plans lower (256, 128, 64), a prompt's
# tail segment (44) and one token, each over three chunks
SSD_CHUNKS = (256, 128, 64, 44, 1)
# grants whose SSD chunk lowers to 256, 128 and 64
# (core/plan.py::lower_ssm_chunk: the thresholds are 24 and 6 pages)
SSM_GRANTS = (32, 16, 4)
SSM_E2E = dict(layers=4, batch=2, prompt_len=300)   # 256 + a 44-token tail
SSM_PREFILL = dict(batch=2, prompt_len=1024)
# two arrivals (step, prompt tokens) beside a resident; the pool holds
# both 3113-page state reservations whole
SERVE_SSM = dict(batch=2, max_len=1024, pages=6500, steps=32, budget=16,
                 arrivals=((4.0, 512), (8.0, 300)))
# serial == pipelined: two residents and an arrival (step, prompt tokens)
SELF_SSM = dict(batch=2, max_len=512, steps=16, budget=8, arrival=(4.0, 300))
# graph replay against eager dispatch, full width cut to 4 layers: yi-9b
# residents (one alone, two as a bucket) and a prompt tenant per KV rung,
# a mamba2 prompt tenant whose 300 tokens make a 256-token chunk and a
# 44-token tail; each decode item is checked at two positions (capture,
# then a replay of the same graph)
GRAPHS = dict(layers=4, batch=2, max_len=512, prompt_len=384,
              ssm_prompt_len=300, lwm_pages=32, k=4)
# bf16 agreement of the chunk plans at full depth: each plan's 1 - cosine
# against the 256-chunk plan within SSM_BF16_SPREAD times the control's
# (the plain version vs the kernel at chunk 256; first readings on the
# H100: 0.0065 and 0.0107 against 0.0057), or SSM_BF16_FLOOR where the
# control agrees closer, and the control's cosine at least SSM_BF16_COSINE
SSM_BF16_SPREAD = 3.0
SSM_BF16_FLOOR = 1e-3
SSM_BF16_COSINE = 0.98
MOE_ARCH = "olmoe-1b-7b"
# e2e_moe: 4 layers, a 40-token prompt (8 slots an expert: 16 bucket rows)
MOE_E2E = dict(layers=4, batch=2, prompt_len=40, lwm_pages=32)
# serve_moe (serve_main_path's arguments): a resident and an arrival at
# step 8; the pool holds the arrival's native KV reservation (2048
# pages) beside the grants
SERVE_MOE = dict(batch=2, max_len=512, pages=2600, steps=32, arrival=ARRIVAL)
SELF_MOE = dict(layers=4, batch=2, max_len=64, pages=1024, steps=12)
# serve_mix: the reference CLI's default pool at full width; the pool
# holds every arch's native reservation of one prompt beside the grants
SERVE_MIX = dict(archs=("yi-9b", MOE_ARCH, "mamba2-370m"), arrivals=2,
                 prompt_len=256, headroom=600)
# the kernel of a decode step's expert-weight gather
# (``params["gate"][top_e]``, PyTorch's indexing on dim 0)
GATHER_KERNEL = "vectorized_gather_kernel"


def _phase(name, fn, *args, **kwargs):
    """Run one phase and print its record; the record is also appended
    to ``phases.jsonl`` in :data:`OUT_DIR`, so a run that fails later
    keeps the records of the phases before."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    rec = {"phase": name, **out, "seconds": round(time.perf_counter() - t0, 3)}
    line = json.dumps(rec)
    print(line, flush=True)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    with open(OUT_DIR / "phases.jsonl", "a") as f:
        f.write(line + "\n")
    return rec


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


# ------------------------------------------------------------- device --
def device_info():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    p = torch.cuda.get_device_properties(0)
    return {"nvidia_smi": smi, "name": p.name, "sms": p.multi_processor_count,
            "smem_per_block_optin": p.shared_memory_per_block_optin,
            "l2_bytes": getattr(p, "L2_cache_size", None),
            "memory_bytes": p.total_memory, "torch": torch.__version__,
            "cuda": torch.version.cuda, "count": torch.cuda.device_count()}


# -------------------------------------------------------------- build --
def build_kernels():
    from repro_torch.kernels import build
    report = build.build()
    out = {}
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    for name, rep in report.items():
        (OUT_DIR / f"nvcc_{name}.log").write_text(rep["log"])
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", rep["log"])]
        spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores",
                                             rep["log"])]
        out[name] = {"seconds": round(rep["seconds"], 3),
                     "max_registers": max(regs, default=None),
                     "max_spill_store_bytes": max(spills, default=None),
                     "tensor_core_kernels": _ptxas_entries(rep["log"]),
                     "sass": _sass_counts(build.library_path(name))}
    return {"nvcc": build.nvcc(), "sources": out}


def _sass_counts(lib):
    """How many wgmma (HGMMA) and TMA load (UTMALDG) instructions the
    library's machine code holds, by ``cuobjdump -sass`` (the toolkit's,
    beside ``nvcc``)."""
    from repro_torch.kernels import build
    tool = Path(build.nvcc()).parent / "cuobjdump"
    if not tool.is_file():
        return "cuobjdump not found"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300).stdout
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "UTMALDG")}


def _ptxas_entries(log: str):
    """Registers, spill bytes and static shared memory that ``-Xptxas -v``
    reports for each gemv / wgmma kernel of one library (their dynamic
    shared memory is the menu's ``smem_bytes``)."""
    out = {}
    for block in log.split("Compiling entry function '")[1:]:
        name = block.split("'", 1)[0]
        if not re.search(r"gemv|wgmma", name):
            continue
        num = lambda pat: int(m.group(1)) if (m := re.search(pat, block)) else 0  # noqa: E731
        out[name] = {"registers": num(r"Used (\d+) registers"),
                     "spill_store_bytes": num(r"(\d+) bytes spill stores"),
                     "spill_load_bytes": num(r"(\d+) bytes spill loads"),
                     "static_smem_bytes": num(r"(\d+) bytes smem")}
    return out


# ------------------------------------------------------------ kernels --
def _randn(gen, shape, dtype, scale=1.0):
    import torch
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (x * scale).to(dtype)


def _close(got, want, dtype_name):
    import torch
    tol = TOL[dtype_name]
    err = float((got.float() - want.float()).abs().max())
    ok = bool(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol))
    return err, ok


def kernel_cases(cfg, dev):
    """Every kernel against its plain version: decode and prefill-sized
    rows, a ragged shape, tiles from full-width plans under several
    grants; bf16 and fp32."""
    import torch
    from repro_torch.core.plan import lower_ffn
    from repro_torch.core.vmem import LANE, fused_ffn_pages
    from repro_torch.kernels import block_fused_ffn as kffn
    from repro_torch.kernels import cache_matmul as kmm
    from repro_torch.kernels import ops
    d, f = cfg.d_model, cfg.d_ff
    limit = ops.smem_limit(torch.device(dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        dn = _dtype_name(dtype)
        eb = torch.tensor([], dtype=dtype).element_size()
        mm = []
        for pages in (32, 64, 300):
            plan = lower_ffn(LANE, d, f, eb, pages, want_fused=False)
            for m in (2, 256):
                mm.append((f"lwm@{pages}p up", m, d, f, plan.up_tile))
                mm.append((f"lwm@{pages}p down", m, f, d, plan.down_tile))
        ragged = lower_ffn(LANE, 333, 1000, eb, 64, want_fused=False)
        mm.append(("ragged", 37, 333, 1000, ragged.up_tile))
        # ragged rows, N and K under the path's smallest plan tile
        path_tile = lower_ffn(LANE, d, f, eb, 32, want_fused=False).up_tile
        mm += [(f"ragged m{m}", m, k, n, path_tile) for m, k, n in MM_RAGGED]
        for label, m, k, n, tile in mm:
            a = _randn(gen, (m, k), dtype)
            b = _randn(gen, (k, n), dtype, 1 / math.sqrt(k))
            got = ops.planned_matmul(a, b, tile)
            err, ok = _close(got, kmm.cache_matmul_plain(a, b), dn)
            hop = ops.legalize_matmul_tile(tile, m, limit, dtype, k, n)
            row = {"kernel": "cache_matmul", "case": label, "dtype": dn,
                   "shape": [m, k, n], "plan_tile": [tile.bm, tile.bn, tile.bk],
                   "kind": hop.kind, "hopper_tile": [hop.bm, hop.bn, hop.bk]}
            if hop.kind != "simt":       # two launches are bit-identical
                row["bitwise_repeat"] = bool(torch.equal(
                    got, ops.planned_matmul(a, b, tile)))
                ok = ok and row["bitwise_repeat"]
            rows.append({**row, "max_abs_err": err, "tol": TOL[dn], "ok": ok})
        ffn = []
        # the smallest LBM grant, and two that widen block_f
        for pages in (fused_ffn_pages(LANE, d, f, eb), 300 * eb, 600 * eb):
            plan = lower_ffn(LANE, d, f, eb, pages, want_fused=True)
            for s in (2, 256):
                ffn.append((f"lbm@{pages}p", s, d, f, plan))
        ffn.append(("ragged", 37, 333, 1000,
                    lower_ffn(LANE, 333, 1000, eb, 4096, want_fused=True)))
        # ragged rows with d_model and d_ff off the wgmma tile and its
        # cluster (d_ff 1000: 8 tiles of 128, the last one partial)
        ragged_ffn = lower_ffn(LANE, 520, 1000, eb, 4096, want_fused=True)
        ffn += [(f"ragged s{s}", s, 520, 1000, ragged_ffn)
                for s in (1, 2, 7, 37, 65, 300)]
        for label, s, dd, ff, plan in ffn:
            if not plan.fused:
                raise AssertionError(f"{label}: plan {plan} is not fused")
            x = _randn(gen, (s, dd), dtype)
            wg = _randn(gen, (dd, ff), dtype, 1 / math.sqrt(dd))
            wu = _randn(gen, (dd, ff), dtype, 1 / math.sqrt(dd))
            wd = _randn(gen, (ff, dd), dtype, 1 / math.sqrt(ff))
            got = ops.fused_ffn(x, wg, wu, wd, block_s=plan.block_s,
                                block_f=plan.block_f)
            err, ok = _close(got, kffn.block_fused_ffn_plain(x, wg, wu, wd), dn)
            hop = ops.legalize_ffn_tile(plan.block_s, min(plan.block_f, ff), s,
                                        limit, dtype, dd, ff)
            row = {"kernel": "block_fused_ffn", "case": label, "dtype": dn,
                   "shape": [s, dd, ff],
                   "plan_block": [plan.block_s, plan.block_f],
                   "kind": hop.kind, "hopper_tile": [hop.bs, hop.bf, hop.bk]}
            if hop.kind != "simt":       # two launches are bit-identical
                row["bitwise_repeat"] = bool(torch.equal(got, ops.fused_ffn(
                    x, wg, wu, wd, block_s=plan.block_s, block_f=plan.block_f)))
                ok = ok and row["bitwise_repeat"]
            rows.append({**row, "max_abs_err": err, "tol": TOL[dn], "ok": ok})
    return rows


def flash_cases(cfg, moe_cfg, dev):
    """flash_attention and flash_attention_quantized (int8, fp8) against
    their plain versions: the prefill path's shape, the MoE prefill's
    (olmoe: as many K/V heads as query heads), a non-causal one,
    ragged S and Sk (also S != Sk), a short prompt and hd 32, with the
    tiles that plans under several grants legalize to (bf16 at hd 128:
    the wgmma kernels, native and quantized, bitwise on a repeat); bf16
    and fp32.  In fp32 the quantized kernel must equal the native kernel
    on the dequantized K/V bitwise."""
    import torch
    from repro_torch.core.plan import lower_attn
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant
    limit = ops.smem_limit(torch.device(dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    B, S = PREFILL["batch"], PREFILL["prompt_len"]
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    # (label, B, H, Hkv, S, hd, causal, Sk)
    shapes = (("path", B, H, Hkv, S, hd, True, S),
              ("moe path", B, moe_cfg.num_heads, moe_cfg.num_kv_heads, S,
               moe_cfg.hd, True, S),
              ("non-causal", 1, H, Hkv, 512, hd, False, 512),
              ("ragged", 1, 8, 2, 333, 64, True, 333),
              ("ragged non-causal", 1, 8, 2, 333, 64, False, 333),
              ("ragged hd128", 1, 8, 2, 333, hd, True, 333),
              ("ragged hd128 non-causal", 1, 8, 2, 333, hd, False, 333),
              ("ragged Sk hd128", 1, 8, 2, 200, hd, False, 520),
              ("short hd128", 1, 8, 2, 40, hd, True, 40),
              ("hd32", 1, 4, 2, 256, 32, True, 256))
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        dn = _dtype_name(dtype)
        eb = torch.tensor([], dtype=dtype).element_size()
        for label, b, h, hkv, s, d, causal, sk in shapes:
            q = _randn(gen, (b, h, s, d), dtype)
            k = _randn(gen, (b, hkv, sk, d), dtype)
            v = _randn(gen, (b, hkv, sk, d), dtype)
            for kv in ("native", "int8", "fp8_e4m3"):
                plans = {lower_attn(d, eb, p, kv, eb if kv == "native" else 1)
                         for p in ATTN_GRANTS}
                tiles = {ops.legalize_attn_tile(p.block_q, p.block_kv, d, s,
                                                limit, dtype, kv != "native"): p
                         for p in plans}
                for tile, plan in tiles.items():
                    row = {"kernel": "flash_attention", "case": label,
                           "dtype": dn, "kv": kv, "causal": causal,
                           "shape": [b, h, hkv, s, d], "sk": sk,
                           "plan_block": [plan.block_q, plan.block_kv],
                           "kind": tile.kind, "hopper_tile": [tile.bq, tile.bkv]}
                    if kv == "native":
                        got = kfa.flash_attention(q, k, v, causal, tile)
                        want = kfa.flash_attention_plain(q, k, v, causal)
                        if tile.kind != "simt":
                            row["bitwise_repeat"] = bool(torch.equal(
                                got, kfa.flash_attention(q, k, v, causal, tile)))
                    else:
                        row["kernel"] = "flash_attention_quantized"
                        kq, ks = quant.quantize_rows(k, kv)
                        vq, vs = quant.quantize_rows(v, kv)
                        ks, vs = ks[..., 0], vs[..., 0]
                        got = kfa.flash_attention_quantized(q, kq, vq, ks, vs,
                                                            causal, tile)
                        want = kfa.flash_attention_quantized_plain(
                            q, kq, vq, ks, vs, causal)
                        if tile.kind != "simt":
                            row["bitwise_repeat"] = bool(torch.equal(
                                got, kfa.flash_attention_quantized(
                                    q, kq, vq, ks, vs, causal, tile)))
                        if dtype == torch.float32:
                            native = kfa.flash_attention(
                                q, quant.dequantize_rows(kq, ks[..., None]),
                                quant.dequantize_rows(vq, vs[..., None]),
                                causal, tile)
                            row["bitwise_vs_native_on_dequantized"] = bool(
                                torch.equal(got, native))
                    err, ok = _close(got, want, dn)
                    ok = ok and row.get("bitwise_vs_native_on_dequantized",
                                        True) and row.get("bitwise_repeat", True)
                    rows.append({**row, "max_abs_err": err, "tol": TOL[dn],
                                 "ok": ok})
    return rows


def quant_cases(cfg, dev):
    """cache_matmul_quant against its plain version: int8 and fp8 codes,
    bf16 and fp32 activations, every compiled tile of the dtype at the
    shapes its kind takes: the full-width decode shapes (M = 2, gate/up
    and down), 256 and 2048 rows, and ragged shapes (rows 1, 2, 7, 37,
    65, 300 with K and N off the tiles); the gemv and wgmma tiles bitwise
    on a repeat."""
    import torch
    from repro_torch.kernels import cache_matmul as kmm
    from repro_torch.kernels import quant
    d, f = cfg.d_model, cfg.d_ff
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    shapes = (("decode up", 2, d, f), ("decode down", 2, f, d),
              ("256 up", 256, d, f), ("2048 up", 2048, d, f),
              ("2048 down", 2048, f, d), ("ragged", 37, 333, 1000),
              *((f"ragged m{m}", m, k, n) for m, k, n in MQ_RAGGED))

    def takes(tile, m, k, n):
        if tile.kind == "gemv":
            return m <= tile.bm
        if tile.kind == "wgmma":
            return m > 8 and k % 8 == 0 and n % 16 == 0
        return m in (2, 256, 2048) or (m, k, n) == (37, 333, 1000)

    rows = []
    for label, m, k, n in shapes:
        w = _randn(gen, (k, n), torch.float32, 1 / math.sqrt(k))
        for kv in KV_CACHES:
            q, sc = quant.quantize_cols(w, kv)
            for dtype in (torch.bfloat16, torch.float32):
                dn = _dtype_name(dtype)
                a = _randn(gen, (m, k), dtype)
                want = kmm.cache_matmul_quant_plain(a, q, sc)
                for tile in kmm.QUANT_TILES:
                    if dtype not in tile.dtypes or not takes(tile, m, k, n):
                        continue
                    got = kmm.cache_matmul_quant(a, q, sc, tile)
                    err, ok = _close(got, want, dn)
                    row = {"kernel": "cache_matmul_quant", "case": label,
                           "dtype": dn, "kv": kv, "shape": [m, k, n],
                           "kind": tile.kind,
                           "hopper_tile": [tile.bm, tile.bn, tile.bk]}
                    if tile.kind != "simt":
                        row["bitwise_repeat"] = bool(torch.equal(
                            got, kmm.cache_matmul_quant(a, q, sc, tile)))
                        ok = ok and row["bitwise_repeat"]
                    rows.append({**row, "max_abs_err": err, "tol": TOL[dn],
                                 "ok": ok})
            del q, sc
    return rows


def _median_ms(fn, reps: int = 30) -> float:
    """Median device time of one call: CUDA events around each call, the
    queue kept ahead of the host by a sleep kernel so that host overhead
    is not timed."""
    import torch
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(100_000_000)
    for s, e in ev:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    ts = sorted(s.elapsed_time(e) for s, e in ev)
    return ts[len(ts) // 2]


def _turns_ms(fns, reps: int = 30):
    """:func:`_median_ms` of each callable in ``fns`` (name -> fn),
    measured in turns, a b .. b a, so that a drift of the card's clock
    within the call falls on each alike: the mean of each one's two
    medians, by name."""
    order = list(fns) + list(fns)[::-1]
    got = {k: [] for k in fns}
    for k in order:
        got[k].append(_median_ms(fns[k], reps))
    return {k: sum(v) / len(v) for k, v in got.items()}


def _bound(nbytes: int, flops: int, dtype_name: str):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


def _matmul_timing(a, b, tile, limit, reps: int):
    """cache_matmul at one of the path's shapes (bf16) with the tile the
    plan legalizes to, against the simt tile the fp32 rule picks at the
    same plan (the one every bf16 call ran before the gemv and wgmma
    kinds), timed in turns in this call, beside the plain version and
    ``torch.matmul``; the kernel held against the plain version."""
    import torch
    from repro_torch.kernels import cache_matmul as kmm
    from repro_torch.kernels import ops
    m, k = a.shape
    n = b.shape[1]
    hop = ops.legalize_matmul_tile(tile, m, limit, a.dtype, k, n)
    simt = ops.legalize_matmul_tile(tile, m, limit, torch.float32, k, n)
    bound, by = _bound(2 * (m * k + k * n + m * n), 2 * m * k * n, "bfloat16")
    got = kmm.cache_matmul(a, b, hop)
    err, ok = _close(got, kmm.cache_matmul_plain(a, b), "bfloat16")
    repeat = bool(torch.equal(got, kmm.cache_matmul(a, b, hop)))
    t = _turns_ms({"ms": lambda: kmm.cache_matmul(a, b, hop),
                   "simt_ms": lambda: kmm.cache_matmul(a, b, simt)}, reps)
    out = {"shape": [m, k, n], "plan_tile": [tile.bm, tile.bn, tile.bk],
           "kind": hop.kind, "hopper_tile": [hop.bm, hop.bn, hop.bk],
           "simt_tile": [simt.bm, simt.bn, simt.bk], **t,
           "plain_ms": _median_ms(lambda: kmm.cache_matmul_plain(a, b), reps),
           "library_ms": _median_ms(lambda: torch.matmul(a, b), reps),
           "bound_ms": bound, "bound_by": by, "max_abs_err": err,
           "bitwise_repeat": repeat, "ok": ok and repeat}
    if hop.kind == "gemv":
        out["gemv_split"] = list(kmm.gemv_split(n, k, torch.cuda.get_device_properties(
            a.device).multi_processor_count))
    if hop.kind == "wgmma":
        out["output_tiles"] = -(-m // hop.bm) * -(-n // hop.bn)
    out["speedup_vs_simt"] = out["simt_ms"] / out["ms"]
    out["vs_library"] = out["ms"] / out["library_ms"]
    return out


def kernel_timings(cfg, dev, batch: int, lwm_pages: int, lbm_pages: int):
    """Kernel, plain and library times at the serving path's decode
    shapes (bf16, M = batch rows), with the tiles the serve's plans
    lower to."""
    import torch
    from repro_torch.core.plan import lower_ffn
    from repro_torch.core.vmem import LANE
    from repro_torch.kernels import block_fused_ffn as kffn
    from repro_torch.kernels import ops
    d, f = cfg.d_model, cfg.d_ff
    dt = torch.bfloat16
    dn, eb = "bfloat16", 2
    limit = ops.smem_limit(torch.device(dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    lwm = lower_ffn(LANE, d, f, eb, lwm_pages, want_fused=False)
    lbm = lower_ffn(LANE, d, f, eb, lbm_pages, want_fused=True)
    x = _randn(gen, (batch, d), dt)
    wg = _randn(gen, (d, f), dt, 1 / math.sqrt(d))
    wu = _randn(gen, (d, f), dt, 1 / math.sqrt(d))
    wd = _randn(gen, (f, d), dt, 1 / math.sqrt(f))
    h = _randn(gen, (batch, f), dt)
    out = {}
    for label, a, b, tile in (("up", x, wg, lwm.up_tile),
                              ("down", h, wd, lwm.down_tile)):
        out[f"cache_matmul.{label}"] = _matmul_timing(a, b, tile, limit, 30)
    hop = ops.legalize_ffn_tile(lbm.block_s, lbm.block_f, batch, limit, dt,
                                d, f)
    bound, by = _bound(eb * (2 * batch * d + 3 * d * f), 6 * batch * d * f, dn)
    err, ok = _close(kffn.block_fused_ffn(x, wg, wu, wd, hop),
                     kffn.block_fused_ffn_plain(x, wg, wu, wd), dn)
    out["block_fused_ffn.decode"] = {
        "shape": [batch, d, f], "plan_block": [lbm.block_s, lbm.block_f],
        "kind": hop.kind, "hopper_tile": [hop.bs, hop.bf, hop.bk],
        "ms": _median_ms(lambda: kffn.block_fused_ffn(x, wg, wu, wd, hop)),
        "plain_ms": _median_ms(lambda: kffn.block_fused_ffn_plain(x, wg, wu, wd)),
        "library_ms": None, "bound_ms": bound, "bound_by": by,
        "partial_bytes": kffn.partial_bytes(hop, batch, d, f),
        "max_abs_err": err, "ok": ok}
    return out


def _plan(cfg, kind: str, pages: int, seq_block: int,
          kv_dtype: str = "native"):
    """The KernelPlan a ``kind`` grant of ``pages`` lowers to, as the
    server lowers a Selection (core/plan.py::lower_selection)."""
    import torch
    from repro_torch.core.allocator import Selection
    from repro_torch.core.mct import MappingCandidate
    from repro_torch.core.plan import lower_selection
    from repro_torch.launch.serve import _lower_width
    cand = MappingCandidate(kind=kind, p_need=pages, dram_bytes=0, flops=0,
                            loops=(), cache_map=(), usage_limit_bytes=0)
    eb = torch.tensor([], dtype=cfg.torch_dtype).element_size()
    plan = lower_selection(Selection(cand, pages, 0.0), pages,
                           seq_block=seq_block, d_model=cfg.d_model,
                           d_ff=_lower_width(cfg), dtype_bytes=eb,
                           head_dim=cfg.hd, ssm_chunk=cfg.ssm_chunk,
                           kv_dtype=kv_dtype)
    if plan.kind != kind:
        raise AssertionError(f"{kind}@{pages}p lowers to {plan.describe()}")
    return plan


def prefill_plans(cfg):
    """The prefill phase's settings: plain, the smallest LBM grant that
    lowers fused at seq_block = prompt_len (native KV), and LWM grants
    with int8 and fp8 KV."""
    from repro_torch.core.vmem import fused_ffn_pages
    s, lwm = PREFILL["prompt_len"], PREFILL["lwm_pages"]
    lbm = fused_ffn_pages(s, cfg.d_model, cfg.d_ff, 2)
    return {"plain": None,
            "LBM/native": _plan(cfg, "LBM", lbm, s),
            "LWM/int8": _plan(cfg, "LWM", lwm, s, "int8"),
            "LWM/fp8_e4m3": _plan(cfg, "LWM", lwm, s, "fp8_e4m3")}


def _ffn_timing(x, wg, wu, wd, plan, limit, reps: int):
    """block_fused_ffn at one of the path's shapes (bf16) with the tile
    ``plan``'s fused blocks legalize to, against the simt tile the fp32
    rule picks at the same plan, timed in turns in this call, beside the
    plain version and the unfused bf16 chain (a yardstick of several
    calls); the kernel held against the plain version."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import block_fused_ffn as kffn
    from repro_torch.kernels import ops
    (s, d), f = x.shape, wg.shape[1]
    ffn = plan.ffn
    hop = ops.legalize_ffn_tile(ffn.block_s, ffn.block_f, s, limit, x.dtype,
                                d, f)
    # the simt tile the same plan gives fp32 (every bf16 call's before)
    simt = ops.legalize_ffn_tile(ffn.block_s, ffn.block_f, s, limit,
                                 torch.float32, d, f)
    bound, by = _bound(2 * (2 * s * d + 3 * d * f), 6 * s * d * f, "bfloat16")
    got = kffn.block_fused_ffn(x, wg, wu, wd, hop)
    err, ok = _close(got, kffn.block_fused_ffn_plain(x, wg, wu, wd),
                     "bfloat16")
    repeat = bool(torch.equal(got, kffn.block_fused_ffn(x, wg, wu, wd, hop)))
    del got
    t = _turns_ms({"ms": lambda: kffn.block_fused_ffn(x, wg, wu, wd, hop),
                   "simt_ms": lambda: kffn.block_fused_ffn(x, wg, wu, wd,
                                                           simt)}, reps)

    def chain():         # several PyTorch calls: a yardstick, not a library
        return torch.matmul(F.silu(torch.matmul(x, wg)) * torch.matmul(x, wu),
                            wd)

    return {
        "shape": [s, d, f], "plan": plan.describe(), "kind": hop.kind,
        "hopper_tile": [hop.bs, hop.bf, hop.bk],
        "simt_tile": [simt.bs, simt.bf, simt.bk], **t,
        "tflops": 6 * s * d * f / t["ms"] / 1e9,
        "plain_ms": _median_ms(
            lambda: kffn.block_fused_ffn_plain(x, wg, wu, wd), reps),
        "library_ms": None,
        "chain_ms": _median_ms(chain, reps),
        "chain": "yardstick, several calls: torch.matmul x3 with silu * mul, "
                 "bf16, the hidden tensors through device memory",
        "bound_ms": bound, "bound_by": by,
        "partial_bytes": kffn.partial_bytes(hop, s, d, f),
        "simt_partial_bytes": kffn.partial_bytes(simt, s, d, f),
        "max_abs_err": err, "bitwise_repeat": repeat, "ok": ok and repeat,
        "speedup_vs_simt": t["simt_ms"] / t["ms"]}


def prefill_timings(cfg, dev):
    """block_fused_ffn (LBM plan), cache_matmul's up and down GEMMs (LWM
    plan) and both flash kernels (the quantized one under the int8 and
    the fp8 plan) at the prefill path's shapes (bf16, B x prompt_len
    rows), with the tiles the prefill phase's plans lower to, each held
    against its plain version on the same inputs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant
    dt, dn, eb = torch.bfloat16, "bfloat16", 2
    limit = ops.smem_limit(torch.device(dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    plans = prefill_plans(cfg)
    lbm, lwm = plans["LBM/native"], plans["LWM/int8"]
    B, S = PREFILL["batch"], PREFILL["prompt_len"]
    d, f = cfg.d_model, cfg.d_ff
    out = {}
    x = _randn(gen, (B * S, d), dt)
    wg = _randn(gen, (d, f), dt, 1 / math.sqrt(d))
    wu = _randn(gen, (d, f), dt, 1 / math.sqrt(d))
    wd = _randn(gen, (f, d), dt, 1 / math.sqrt(f))
    out["block_fused_ffn.prefill"] = _ffn_timing(x, wg, wu, wd, lbm, limit,
                                                  10)
    h = _randn(gen, (B * S, f), dt)
    for label, a, b, tile in (("up", x, wg, lwm.ffn.up_tile),
                              ("down", h, wd, lwm.ffn.down_tile)):
        out[f"cache_matmul.prefill.{label}"] = {
            "plan": lwm.describe(), **_matmul_timing(a, b, tile, limit, 10)}
    del x, h, wg, wu, wd
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = _randn(gen, (B, H, S, hd), dt)
    k = _randn(gen, (B, Hkv, S, hd), dt)
    v = _randn(gen, (B, Hkv, S, hd), dt)
    flops = 2 * B * H * S * S * hd               # causal: half of 4*B*H*S*Sk*hd
    qo_bytes = 2 * eb * B * H * S * hd           # q read, O written
    tile = ops.legalize_attn_tile(lbm.attn.block_q, lbm.attn.block_kv, hd, S,
                                  limit, dt)
    # the simt tile the same plan gives fp32 (every bf16 call's before)
    simt = ops.legalize_attn_tile(lbm.attn.block_q, lbm.attn.block_kv, hd, S,
                                  limit, torch.float32)
    bound, by = _bound(qo_bytes + 2 * eb * B * Hkv * S * hd, flops, dn)
    got = kfa.flash_attention(q, k, v, True, tile)
    err, ok = _close(got, kfa.flash_attention_plain(q, k, v, True), dn)
    repeat = bool(torch.equal(got, kfa.flash_attention(q, k, v, True, tile)))
    t = _turns_ms({"ms": lambda: kfa.flash_attention(q, k, v, True, tile),
                   "simt_ms": lambda: kfa.flash_attention(q, k, v, True, simt)})
    out["flash_attention"] = {
        "shape": [B, H, Hkv, S, hd], "plan": [lbm.attn.block_q,
                                               lbm.attn.block_kv],
        "kind": tile.kind, "hopper_tile": [tile.bq, tile.bkv],
        "simt_tile": [simt.bq, simt.bkv], **t,
        "tflops": flops / t["ms"] / 1e9,
        "plain_ms": _median_ms(lambda: kfa.flash_attention_plain(q, k, v, True)),
        "library_ms": _median_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)),
        "bound_ms": bound, "bound_by": by, "max_abs_err": err,
        "bitwise_repeat": repeat, "ok": ok and repeat}
    out["flash_attention"]["speedup_vs_simt"] = t["simt_ms"] / t["ms"]
    out["flash_attention"]["vs_library"] = (t["ms"] /
                                            out["flash_attention"]["library_ms"])
    # the quantized kernel under the LWM/int8 and LWM/fp8 plans: the tile
    # they legalize to in turns against the simt tile the same plan gives
    # fp32 (every quantized call's before the quantized wgmma kernel)
    for name in ("LWM/int8", "LWM/fp8_e4m3"):
        plan = plans[name]
        kq, ks = quant.quantize_rows(k, plan.kv_dtype)
        vq, vs = quant.quantize_rows(v, plan.kv_dtype)
        ks, vs = ks[..., 0], vs[..., 0]
        tile = ops.legalize_attn_tile(plan.attn.block_q, plan.attn.block_kv,
                                      hd, S, limit, dt, True)
        simt = ops.legalize_attn_tile(plan.attn.block_q, plan.attn.block_kv,
                                      hd, S, limit, torch.float32, True)
        bound, by = _bound(qo_bytes + 2 * B * Hkv * S * (hd + 4), flops, dn)
        got = kfa.flash_attention_quantized(q, kq, vq, ks, vs, True, tile)
        err, ok = _close(got, kfa.flash_attention_quantized_plain(
            q, kq, vq, ks, vs, True), dn)
        repeat = bool(torch.equal(got, kfa.flash_attention_quantized(
            q, kq, vq, ks, vs, True, tile)))
        del got
        t = _turns_ms({"ms": lambda: kfa.flash_attention_quantized(
                           q, kq, vq, ks, vs, True, tile),
                       "simt_ms": lambda: kfa.flash_attention_quantized(
                           q, kq, vq, ks, vs, True, simt)})
        key = "flash_attention_quantized" + (
            "" if plan.kv_dtype == "int8" else f".{plan.kv_dtype}")
        out[key] = {
            "shape": [B, H, Hkv, S, hd], "kv": plan.kv_dtype,
            "kind": tile.kind, "plan": [plan.attn.block_q, plan.attn.block_kv],
            "hopper_tile": [tile.bq, tile.bkv],
            "simt_tile": [simt.bq, simt.bkv], **t,
            "tflops": flops / t["ms"] / 1e9,
            "plain_ms": _median_ms(lambda: kfa.flash_attention_quantized_plain(
                q, kq, vq, ks, vs, True)),
            "library_ms": None, "bound_ms": bound, "bound_by": by,
            "max_abs_err": err, "bitwise_repeat": repeat, "ok": ok and repeat,
            "speedup_vs_simt": t["simt_ms"] / t["ms"]}
    return out


def _ssd_inputs(gen, b, h, s, p, n, dtype):
    """ssd_chunk operands as tests/test_kernels.py::test_ssd_chunk draws
    them (dt softplus of a normal, A = |normal| + 0.1), with B and C per
    batch row [b, s, n], the model's layout."""
    import torch
    x = _randn(gen, (b * h, s, p), dtype)
    dt = torch.nn.functional.softplus(_randn(gen, (b * h, s), torch.float32))
    A = _randn(gen, (b * h,), torch.float32).abs() + 0.1
    return (x, dt, A, _randn(gen, (b, s, n), dtype),
            _randn(gen, (b, s, n), dtype))


def _ssd_plain(x, dt, A, Bm, Cm, chunk, kind=None):
    """The plain version on the reference's broadcast [BH, S, N] B/C
    (``kind``, the kernel's, is ignored)."""
    from repro_torch.kernels import ssd_scan as kssd
    h = x.shape[0] // Bm.shape[0]
    return kssd.ssd_chunk_plain(x, dt, A, Bm.repeat_interleave(h, 0),
                                Cm.repeat_interleave(h, 0), chunk)


def ssd_cases(ssm_cfg, dev):
    """ssd_chunk against its plain version: full-width mamba2 heads (B 2
    x 32 heads, P 64, N 128, B/C per batch row) at each chunk of
    :data:`SSD_CHUNKS` over three chunks, and the reduced shape (P 32,
    N 16); bf16 and fp32 inputs, both at the fp32 tolerance (the
    arithmetic and the outputs are fp32).  bf16 runs the kind
    ``ops.ssd_kind`` routes (wgmma) and the simt kind, fp32 the simt
    kind; every case bitwise on a repeat."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as kssd
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    red = ssm_cfg.reduced()
    b, h, p, n = 2, ssm_cfg.ssm_heads, ssm_cfg.ssm_head_dim, ssm_cfg.ssm_state
    shapes = [("full", b, h, p, n, q, 3 * q) for q in SSD_CHUNKS]
    shapes.append(("reduced", b, red.ssm_heads, red.ssm_head_dim,
                   red.ssm_state, red.ssm_chunk, 3 * red.ssm_chunk))
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for label, b, h, p, n, q, s in shapes:
            ops_in = _ssd_inputs(gen, b, h, s, p, n, dtype)
            want_y, want_st = _ssd_plain(*ops_in, q)
            for kind in dict.fromkeys((ops.ssd_kind(dtype, n, p), "simt")):
                y, st = kssd.ssd_chunk(*ops_in, q, kind=kind)
                ey, oky = _close(y, want_y, "float32")
                es, oks = _close(st, want_st, "float32")
                y2, st2 = kssd.ssd_chunk(*ops_in, q, kind=kind)
                repeat = bool(torch.equal(y, y2) and torch.equal(st, st2))
                rows.append({"kernel": "ssd_chunk", "case": f"{label} Q{q}",
                             "dtype": _dtype_name(dtype), "kind": kind,
                             "shape": [b * h, s, p, n], "chunk": q,
                             "max_abs_err": max(ey, es),
                             "tol": TOL["float32"], "bitwise_repeat": repeat,
                             "ok": oky and oks and repeat})
    return rows


def ssd_work(b, h, s, p, n, q, eb):
    """(bytes, operations) of one ssd_chunk call: x at ``eb`` bytes, dt
    and A fp32, B and C once per batch row, y and the states fp32
    written; the causal half of the [Q x Q] score and weight products,
    and the states, at 2 operations a multiply-add."""
    bh, n_c = b * h, s // q
    nbytes = (bh * s * p * eb + bh * s * 4 + bh * 4 + 2 * b * s * n * eb
              + bh * s * p * 4 + bh * n_c * n * p * 4)
    flops = (2 * bh * n_c * (q * (q + 1) // 2) * (n + p)
             + 2 * bh * n_c * q * n * p)
    return nbytes, flops


def ssd_timings(ssm_cfg, dev):
    """ssd_chunk at the SSM paths' shapes (bf16, full-width mamba2, B/C
    per batch row): the prefill phase's (B 2, S 1024) at each chunk its
    grants lower, and a serving prompt chunk (B 2, S 256); the routed
    kind (wgmma) timed in turns against the simt kind (``simt_ms``),
    plain and bound, checked against the plain version and bitwise on a
    repeat."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as kssd
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    b, h = SSM_PREFILL["batch"], ssm_cfg.ssm_heads
    p, n = ssm_cfg.ssm_head_dim, ssm_cfg.ssm_state
    out = {}
    for label, s, q in (("prefill", SSM_PREFILL["prompt_len"], 256),
                        ("prefill.q128", SSM_PREFILL["prompt_len"], 128),
                        ("prefill.q64", SSM_PREFILL["prompt_len"], 64),
                        ("serve_chunk", 256, 256)):
        ops_in = _ssd_inputs(gen, b, h, s, p, n, torch.bfloat16)
        kind = ops.ssd_kind(torch.bfloat16, n, p)
        y, st = kssd.ssd_chunk(*ops_in, q, kind=kind)
        want_y, want_st = _ssd_plain(*ops_in, q)
        ey, oky = _close(y, want_y, "float32")
        es, oks = _close(st, want_st, "float32")
        y2, st2 = kssd.ssd_chunk(*ops_in, q, kind=kind)
        repeat = bool(torch.equal(y, y2) and torch.equal(st, st2))
        del y, st, y2, st2
        bound, by = _bound(*ssd_work(b, h, s, p, n, q, 2), "bfloat16")
        x, dt, A, Bm, Cm = ops_in
        Bw, Cw = Bm.repeat_interleave(h, 0), Cm.repeat_interleave(h, 0)
        t = _turns_ms({"ms": lambda: kssd.ssd_chunk(*ops_in, q, kind=kind),
                       "simt_ms": lambda: kssd.ssd_chunk(*ops_in, q,
                                                         kind="simt")})
        out[f"ssd_chunk.{label}"] = {
            "shape": [b, h, s, p, n], "chunk": q, "kind": kind, **t,
            "plain_ms": _median_ms(
                lambda: kssd.ssd_chunk_plain(x, dt, A, Bw, Cw, q)),
            "library_ms": None, "bound_ms": bound, "bound_by": by,
            "max_abs_err": max(ey, es), "bitwise_repeat": repeat,
            "ok": oky and oks and repeat,
            "speedup_vs_simt": t["simt_ms"] / t["ms"]}
    return out


def moe_timings(moe_cfg, dev):
    """cache_matmul and block_fused_ffn at olmoe-1b-7b's expert shapes:
    one expert's bucket of ``make_prefill`` at 2 x 1024 tokens (G*C = 328
    rows) and of ``make_prefill(cfg, serve=True)`` (2048 drop-free rows),
    gate/up [rows, 2048] @ [2048, 1024] and down [rows, 1024] @ [1024,
    2048] under the 32-page LWM plan (which both calls run), and the fused
    FFN at 328 rows under the smallest fused LBM plan, both lowered at
    d_ff 1024; the unfused bf16 chain as the fused FFN's yardstick."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.moe import capacity
    dt = torch.bfloat16
    limit = ops.smem_limit(torch.device(dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    plans = moe_prefill_plans(moe_cfg)
    lwm = plans["LWM/native"].ffn
    B, S = PREFILL["batch"], PREFILL["prompt_len"]
    d, f = moe_cfg.d_model, moe_cfg.d_ff
    wg = _randn(gen, (d, f), dt, 1 / math.sqrt(d))
    wu = _randn(gen, (d, f), dt, 1 / math.sqrt(d))
    wd = _randn(gen, (f, d), dt, 1 / math.sqrt(f))
    out = {}
    for call, rows in (("moe", B * capacity(S, moe_cfg)),
                       ("moe.serve", B * S)):
        x = _randn(gen, (rows, d), dt)
        h = _randn(gen, (rows, f), dt)
        for label, a, b, tile in (("up", x, wg, lwm.up_tile),
                                  ("down", h, wd, lwm.down_tile)):
            out[f"cache_matmul.{call}.{label}"] = {
                "plan": plans["LWM/native"].describe(),
                **_matmul_timing(a, b, tile, limit, 30)}
        if call == "moe":
            out["block_fused_ffn.moe"] = _ffn_timing(
                x, wg, wu, wd, plans["LBM/native"], limit, 30)
    return out


def check_kernels(cfg, ssm_cfg, moe_cfg, dev):
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = (kernel_cases(cfg, dev) + flash_cases(cfg, moe_cfg, dev)
            + quant_cases(cfg, dev) + ssd_cases(ssm_cfg, dev))
    bad = [r for r in rows if not r["ok"]]
    timings = kernel_timings(cfg, dev, batch=2, lwm_pages=32, lbm_pages=324)
    timings.update(prefill_timings(cfg, dev))
    timings.update(ssd_timings(ssm_cfg, dev))
    timings.update(moe_timings(moe_cfg, dev))
    bad += [k for k, v in timings.items() if not v["ok"]]
    worst = {}
    for r in rows:
        key = f"{r['kernel']}.{r['dtype']}"
        worst[key] = max(worst.get(key, 0.0), r["max_abs_err"])
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "kernel_cases.json").write_text(json.dumps(rows, indent=1))
    return {"allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                           "cudnn": torch.backends.cudnn.allow_tf32},
            "cases": len(rows), "failed": bad, "worst_abs_err": worst,
            "tolerance": TOL, "timings": timings}


# ---------------------------------------------------------------- e2e --
def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _to_dtype(tree, dtype):
    """A copy of a params tree with every floating leaf in ``dtype``."""
    if isinstance(tree, dict):
        return {k: _to_dtype(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_dtype(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


class _Forced:
    """Teacher forcing for decode_epoch: records each step's logits and
    feeds the next preset token instead of the greedy one."""

    def __init__(self, tokens):
        self.tokens, self.i, self.logits = tokens, 0, []

    def __call__(self, logits):
        self.logits.append(logits[:, -1].float())
        self.i += 1
        return self.tokens[:, self.i]


def _e2e_run(cfg, params, dev, prompt, forced, plans, kv_dtype="native"):
    import torch
    from repro_torch.models.transformer import (decode_epoch, init_caches,
                                                prefill_chunk)
    caches = init_caches(params, cfg, prompt.shape[0], 64, kv_dtype=kv_dtype,
                         device=dev)
    toks = torch.from_numpy(prompt).long().to(dev)
    forced_t = torch.from_numpy(forced).long().to(dev)
    logits, caches = prefill_chunk(params, toks, caches, 0, cfg)
    out = [logits[:, -1].float()]
    feed = _Forced(forced_t)
    index, k = prompt.shape[1], 4
    for plan in plans:
        _, caches = decode_epoch(params, forced_t[:, feed.i:feed.i + 1], caches,
                                 index, cfg, k, next_token_fn=feed, plan=plan)
        index += k
    out += feed.logits
    return torch.stack(out, 1).cpu()


def _gate(got, want, label: str):
    """Card against reference logits [..., V]: max |difference| <= 2e-2
    of the largest reference logit; a greedy token may differ only where
    the reference's own margin is within twice that."""
    import torch
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    tol = 2e-2 * scale
    g_arg, w_arg = got.argmax(-1), want.argmax(-1)
    margin = want.max(-1).values - want.gather(-1, g_arg[..., None])[..., 0]
    agree = float((g_arg == w_arg).float().mean())
    bad_tokens = int(((g_arg != w_arg) & (margin > 2 * tol)).sum())
    if not (bool(torch.isfinite(got).all()) and err <= tol and bad_tokens == 0):
        raise AssertionError(f"{label}: err {err} tol {tol} agree {agree} "
                             f"bad_tokens {bad_tokens}")
    return {"max_abs_err": err, "max_abs_logit": scale, "tol": tol,
            "greedy_agreement": agree}


# the kernels that the plan-lowered prefill (and the e2e phase) launch
PREFILL_KERNELS = ("cache_matmul", "block_fused_ffn", "flash_attention",
                   "flash_attention_quantized")


def _counters():
    """The six kernels' launch counters, by kernel name, and each split
    by tile kind (``cache_matmul.gemv``, ``ssd_chunk.wgmma`` etc.); a
    replayed graph adds the launches its capture recorded."""
    from repro_torch.kernels import counters as kcount
    return kcount.snapshot()


def _gate_kinds(counters, label: str, matmul=(), flash=(), ffn=(), quant=(),
                flash_quantized=(), ssd=()):
    """Every bf16 launch of the path ran the new kinds: no cache_matmul
    launch of the ``simt`` kind, each kind of ``matmul`` launched; where
    ``flash`` names ``wgmma``, no native flash launch of the simt kind
    and some of the wgmma kernel; likewise ``ffn`` for block_fused_ffn,
    ``quant`` for cache_matmul_quant, ``flash_quantized`` for
    flash_attention_quantized and ``ssd`` for ssd_chunk (each kind named
    launched, none of the simt kind)."""
    bad = [k for k in matmul if counters[f"cache_matmul.{k}"] <= 0]
    if counters["cache_matmul.simt"]:
        bad.append("cache_matmul.simt")
    for name, kinds in (("flash_attention", flash), ("block_fused_ffn", ffn),
                        ("cache_matmul_quant", quant),
                        ("flash_attention_quantized", flash_quantized),
                        ("ssd_chunk", ssd)):
        bad += [f"{name}.{k}" for k in kinds if counters[f"{name}.{k}"] <= 0]
        if kinds and counters[f"{name}.simt"]:
            bad.append(f"{name}.simt")
    if bad:
        raise AssertionError(f"{label}: kinds {bad} wrong: {counters}")


def _zero_counters():
    from repro_torch.kernels import counters as kcount
    kcount.zero()


def check_e2e(cfg, dev, layers: int = 4, lbm_pages: int = 324,
              lwm_pages: int = 32):
    """The card with kernels against the CPU with the plain versions,
    same weights and tokens: prefill and two teacher-forced decode epochs
    (LBM, LWM) with a native cache, and again with an int8 and an fp8
    cache; then make_prefill of a ragged prompt under an LBM plan with
    native KV and an LWM plan with int8 KV.  Tolerance (bf16 activations
    rounded at different points over 4 layers): see :func:`_gate`; with
    a quantized cache the greedy tokens must also be equal, and its
    logits on the card reach :data:`PREFILL_COSINE` against the native
    cache's."""
    import torch
    from repro_torch.core.vmem import LANE
    from repro_torch.models import model as M
    cfg = dataclasses.replace(cfg, num_layers=layers)
    plans = [_plan(cfg, "LBM", lbm_pages, LANE),
             _plan(cfg, "LWM", lwm_pages, LANE)]
    pf_plans = [plans[0], _plan(cfg, "LWM", lwm_pages, LANE, "int8")]
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, (2, 8))
    forced = rng.integers(0, cfg.vocab_size, (2, 9))
    prompt_len = 40              # ragged against every flash tile
    long_prompt = rng.integers(0, cfg.vocab_size, (2, prompt_len))
    prefill = M.make_prefill(cfg)

    def run(params, device):
        toks = torch.from_numpy(long_prompt).long().to(device)
        pf = [prefill(params, {"tokens": toks}, p).float().cpu()
              for p in pf_plans]
        kv = {name: _e2e_run(cfg, params, device, prompt, forced, plans, name)
              for name in KV_CACHES}
        return _e2e_run(cfg, params, device, prompt, forced, plans), pf, kv

    params = M.init_params(cfg, seed=1, device=dev)
    l0 = _counters()
    got, got_pf, got_kv = run(params, dev)
    launches = {k: v - l0[k] for k, v in _counters().items()}
    want, want_pf, want_kv = run(_to(params, "cpu"), "cpu")
    del params
    V = cfg.vocab_size
    quantized = {}
    for name in KV_CACHES:
        g, w = got_kv[name][..., :V], want_kv[name][..., :V]
        gate = _gate(g, w, f"e2e decode {name} cache")
        cos = float(torch.nn.functional.cosine_similarity(
            g, got[..., :V], dim=-1).min())
        if gate["greedy_agreement"] != 1.0 or cos < PREFILL_COSINE[name]:
            raise AssertionError(f"e2e {name} cache: greedy "
                                 f"{gate['greedy_agreement']}, cosine {cos}")
        quantized[name] = {**gate, "min_cosine_vs_native": cos,
                           "min_cosine_bar": PREFILL_COSINE[name]}
    res = {"layers": layers, "positions": int(got.shape[1]),
           "decode": _gate(got[..., :V], want[..., :V], "e2e decode"),
           "decode_quantized_kv": quantized,
           "prefill": {p.describe(): _gate(g[..., :V], w[..., :V],
                                           f"e2e prefill {p.describe()}")
                       for p, g, w in zip(pf_plans, got_pf, want_pf)},
           "prompt_len": prompt_len, "launches": launches,
           "plans": [p.describe() for p in plans]}
    if min(launches[k] for k in PREFILL_KERNELS) <= 0:
        raise AssertionError(f"e2e: a kernel never launched: {launches}")
    # the LBM decode epochs run block_fused_ffn's simt decode tile (2
    # rows), make_prefill's 80 rows its wgmma tile
    _gate_kinds(launches, "e2e", ("gemv", "wgmma"), ("wgmma",))
    if launches["block_fused_ffn.wgmma"] <= 0:
        raise AssertionError(f"e2e: no wgmma block_fused_ffn launch: "
                             f"{launches}")
    return res


# -------------------------------------------------------------- serve --
def _profile(run, annotations=(), shares=()):
    """Device time by kernel of one call of ``run`` (warm, synchronised),
    under ``torch.profiler``, and the device's idle share against the
    same call timed on the host clock without the profiler.  Each name in
    ``annotations`` (a ``record_function`` range inside ``run``) gets the
    device time of the kernels launched inside it (``kernel_ms``, from
    the range's host-side row) and the device span of the range
    (``span_ms``, which also holds the idle gaps while the host launches
    its kernels); both are kept out of the kernel rows.  Each name in
    ``shares`` gets the share of device time of every kernel whose name
    holds it (``shares``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    run()                                   # warm
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()

    def dev_us(e):
        for a in ("self_device_time_total", "self_cuda_time_total"):
            v = getattr(e, a, None)
            if v is not None:
                return float(v)
        return 0.0

    events = prof.key_averages()
    annotated = {n: {} for n in annotations}
    for e in events:
        if e.key in annotations:
            on_device = str(getattr(e, "device_type", "")).endswith("CUDA")
            total = max(float(getattr(e, a, 0) or 0) for a in (
                "device_time_total", "cuda_time_total"))
            annotated[e.key]["span_ms" if on_device else "kernel_ms"] = \
                total / 1e3
    rows = [(e.key, dev_us(e), e.count,
             str(getattr(e, "device_type", "")).endswith("CUDA"))
            for e in events if e.key not in annotations]
    rows = [r for r in rows if r[1] > 0]
    # kernels only, where the profiler tags them: an op and its kernel
    # would otherwise count twice
    kernels_only = any(r[3] for r in rows)
    if kernels_only:
        rows = [r for r in rows if r[3]]
    total_us = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    top = [{"name": n[:80], "device_ms": us / 1e3, "calls": c,
            "share": us / total_us} for n, us, c, _ in rows[:12]]
    out = {"wall_ms": wall_ms, "kernels_only": kernels_only,
           "kernel_launches": sum(r[2] for r in rows) if kernels_only
           else "not measured",
           "device_ms": total_us / 1e3 if total_us else "not measured",
           "idle_share": (1 - total_us / 1e3 / wall_ms) if total_us else
           "not measured", "top": top}
    if shares:
        out["shares"] = {n: (sum(r[1] for r in rows if n in r[0]) / total_us
                             if total_us else "not measured")
                         for n in shares}
    if annotations:
        out["annotated"] = {
            n: {**a, "kernel_share": a["kernel_ms"] * 1e3 / total_us}
            if a.get("kernel_ms") and total_us else (a or "not measured")
            for n, a in annotated.items()}
    return out


def _profile_replay(srv, t, k: int = 4, shares=()):
    """:func:`_profile` of one decode epoch of tenant ``t`` as the server
    dispatches it warm: one replay of its program for the item at its
    position (a program not cached yet is captured in ``_profile``'s
    warm-up call).  Each call puts the device position and the feedback
    token back (two small copies), so every call replays the same
    epoch.  ``shares`` as :func:`_profile`'s."""
    import torch
    plan = srv._dec_plan(t, t.plans[-1])
    item = ("single", t, plan, k)
    token = t.token.clone()
    host_ms = []

    def run():
        t0 = time.perf_counter()
        srv._fused_epoch_fn(item)()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        t.index_dev.sub_(k)
        t.token.copy_(token)
        torch.cuda.synchronize()

    out = _profile(run, shares=shares)
    # the host's part of a replayed epoch: the lookup and the replay call
    # (the graph's launch), last of the three calls
    return {"plan": plan.describe() if plan is not None else None,
            "steps": k, "position": t.index, "replay_host_ms": host_ms[-1],
            **out}


def _warm_runs(srv, steps: int):
    """:data:`WARM_RUNS` more ``run()`` calls of a served server (only its
    residents are left): each must build nothing (``epoch_compiles`` all
    0, no capture, no LRU miss or eviction).  Returns each run's
    tokens/s, wall and host record, and the median tokens/s with its
    spread ((max - min) / median)."""
    runs = []
    for _ in range(WARM_RUNS):
        lru = (srv._fused_jits.misses, srv._prefill_jits.misses,
               srv._fused_jits.evictions, srv._prefill_jits.evictions)
        captures = srv._captures
        out = srv.run(steps=steps)
        h = out["host"]
        if (h["epoch_compiles"] != [0] * h["epochs"]
                or srv._captures != captures
                or lru != (srv._fused_jits.misses, srv._prefill_jits.misses,
                           srv._fused_jits.evictions,
                           srv._prefill_jits.evictions)):
            raise AssertionError(f"warm run built programs: {h}")
        runs.append({"tokens_per_s": out["tokens_per_s"],
                     "wall_s": out["wall_s"],
                     "tokens_served": out["tokens_served"], "host": h})
    rates = sorted(r["tokens_per_s"] for r in runs)
    med = rates[len(rates) // 2]
    return {"steps": steps, "runs": runs, "median_tokens_per_s": med,
            "spread": (rates[-1] - rates[0]) / med if med else None}


def _graph_pool_bytes(srv):
    """Bytes the server's graph memory pool holds on the card (its
    segments in the allocator's snapshot), or "not measured"."""
    import torch
    if srv._graph_pool is None:
        return 0
    try:
        segs = torch.cuda.memory._snapshot()["segments"]
    except (AttributeError, KeyError, RuntimeError):
        return "not measured"
    pool = tuple(srv._graph_pool)
    return sum(s["total_size"] for s in segs
               if tuple(s.get("segment_pool_id", ())) == pool)


def _programs(srv, out):
    """The server's program record: captures, capture seconds per graph,
    the graph pool's bytes and the LRU counters."""
    h = out["host"]
    return {"captures": h["captures"], "capture_s": h["capture_s"],
            "warmups": h["warmups"], "warmup_s": h["warmup_s"],
            "capture_s_per_graph": (h["capture_s"] / h["captures"]
                                    if h["captures"] else None),
            "graph_pool_bytes": _graph_pool_bytes(srv),
            "jit_cache": h["jit_cache"], "epoch_compiles": h["epoch_compiles"],
            "departure_evictions": h["departure_evictions"]}


def grantable_kinds(cfg, batch: int, pages: int):
    """Plan kinds the scheduler can grant a tenant of ``cfg`` in a pool of
    ``pages``: LWM always, LBM where the server's mapping of its decode
    FFN graph carries an LBM candidate that fits the pool.  The mapping
    is the port's copied core, so these are the reference's kinds (at
    full width its 2 ms LBM block cap leaves LWM only)."""
    from repro_torch.launch import serve as S
    tm = S._tenant_model(S._ffn_graph(cfg.name, cfg, seq_block=batch),
                         S._vmem_mapper(pages))
    lbm = any(m.lbm is not None and m.lbm.p_need <= pages
              for m in tm.mapping.mcts)
    return {"LBM", "LWM"} if lbm else {"LWM"}


def serve_main_path(cfg, dev, counters, label: str = "serve",
                    batch: int = 2, max_len: int = 512,
                    pages: int = SERVE_PAGES, steps: int = SERVE_STEPS,
                    arrival=ARRIVAL, kernels: bool = True, shares=()):
    """Two full-width, full-depth tenants of ``cfg`` through the port's
    MultiTenantServer: a resident and an ``arrival`` (a prompt and a
    budget), whose native KV reservation the pool holds whole.
    ``counters`` receives the kernels' launch counts of this run: zeroed
    just before ``run``, read just after.  With ``kernels`` the FFN
    kernels of the plans granted must have launched, cache_matmul of the
    gemv kind (yi-9b); without, nothing may launch (olmoe-1b-7b: the
    server's MoE path gathers its experts in decode and runs the plain
    buckets in prompt chunks, as the reference's).  The plan kinds must
    be those the scheduler can grant.  Then three warm runs, and one
    replayed decode epoch of the resident profiled with the named
    kernels' ``shares``."""
    import torch
    from repro_torch.launch.serve import MultiTenantServer, _kv_reserve_pages
    from repro_torch.sim.driver import TenantSpec
    torch.cuda.reset_peak_memory_stats()
    quote = _kv_reserve_pages(cfg, batch, arrival["prompt_len"])
    srv = MultiTenantServer([cfg.name], tenants=[TenantSpec(cfg.name,
                                                            **arrival)],
                            batch=batch, max_len=max_len, total_pages=pages,
                            epoch_len=4, device=dev, reduced=False)
    _zero_counters()
    out = srv.run(steps=steps)
    counters.update(_counters())
    programs = _programs(srv, out)
    want_kinds = grantable_kinds(cfg, batch, pages)
    if kernels:
        need = {"cache_matmul"} | ({"block_fused_ffn"} if "LBM" in want_kinds
                                   else set())
        if min(counters[k] for k in need) <= 0:
            raise AssertionError(f"{label}: a kernel never launched: "
                                 f"{counters}")
        _gate_kinds(counters, label, ("gemv",))
    elif any(counters.values()):
        raise AssertionError(f"{label}: a kernel launched: {counters}")
    tenants = {}
    for t in srv.tenants:
        res = out["tenants"][t.tid]
        o = res["output"]
        want = steps if t.prompt_len == 0 else 1 + arrival["n_inferences"]
        problems = []
        if o.shape != (batch, want) or o.min() < 0 or o.max() >= cfg.vocab_size:
            problems.append(f"output {o.shape} [{o.min()}, {o.max()}], want "
                            f"({batch}, {want})")
        if t.prompt_len and not t.kv_wanted == t.kv_reserved == quote:
            problems.append(f"reservation {t.kv_reserved} of {t.kv_wanted}, "
                            f"quote {quote}")
        if problems:
            raise AssertionError(f"{label} {t.tid}: {problems}")
        tenants[t.tid] = {"tokens": res["tokens"], "ttft_s": res["ttft_s"],
                          "kv_wanted": res["kv_wanted"],
                          "kv_reserved": res["kv_reserved"],
                          "prefill_chunks": res["prefill_chunks"],
                          "lbm_frac": res["lbm_frac"],
                          "plans": dict(Counter(p.describe()
                                                for p in t.plans)),
                          "first_tokens": o[0, :8].tolist()}
    kinds = {p.kind for t in srv.tenants for p in t.plans}
    if kinds != want_kinds:
        raise AssertionError(f"{label}: plan kinds {kinds}, the scheduler "
                             f"grants {want_kinds}")
    res = {"arch": cfg.name, "layers": srv.tenants[0].cfg.num_layers,
           "total_pages": pages, "quote": quote, "batch": batch,
           "max_len": max_len, "steps": steps, "plan_kinds": sorted(kinds),
           "launches": dict(counters),
           "tokens_served": out["tokens_served"], "wall_s": out["wall_s"],
           "tokens_per_s": out["tokens_per_s"], "dram_total": out["dram_bytes"],
           "host": out["host"], "tenants": tenants, "programs": programs,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    res["warm"] = _warm_runs(srv, steps)
    res["graph_pool_bytes"] = _graph_pool_bytes(srv)
    res["peak_memory_bytes_after_warm"] = torch.cuda.max_memory_allocated()
    res["profile"] = [_profile_replay(srv, srv.tenants[0], shares=shares)]
    return res


# --------------------------------------------------------------- self --
def check_serial_pipelined(cfg, dev, layers: int = 4):
    """Serial (per-step) and pipelined (epoch) serving of two resident
    tenants: bitwise-equal token streams and equal choice traces, under
    each pool of :data:`SELF_POOLS`: full width (4 layers) in a starved
    pool (the zero-page LWM candidate, cache_matmul), and the reduced
    width in a pool where the scheduler grants LBM (block_fused_ffn).
    Each pool's plan kind is the one :func:`grantable_kinds` computes,
    and some pool must be granted LBM."""
    from repro_torch.launch.serve import MultiTenantServer
    from repro_torch.models.base import register
    full = register(dataclasses.replace(cfg, name=f"{cfg.name}-{layers}layer",
                                        num_layers=layers))
    res = {}
    for width, pages in SELF_POOLS:
        arch = full if width == "full" else cfg
        served = arch if width == "full" else arch.reduced()
        kind = "LBM" if "LBM" in grantable_kinds(served, 2, pages) else "LWM"
        kernel = "block_fused_ffn" if kind == "LBM" else "cache_matmul"
        label = f"self {width}@{pages}p"
        outs = []
        _zero_counters()
        for pipeline in (False, True):
            srv = MultiTenantServer([arch.name, arch.name], batch=2, max_len=64,
                                    total_pages=pages, epoch_len=4,
                                    pipeline=pipeline, device=dev,
                                    reduced=width != "full")
            outs.append(srv.run(steps=12))
            got = {p.kind for t in srv.tenants for p in t.plans}
            if got != {kind}:
                raise AssertionError(f"{label}: plans {got}, want {kind}")
            plans = sorted({p.describe() for t in srv.tenants for p in t.plans})
            del srv
        counts = _counters()
        launches = counts[kernel]
        if launches <= 0:
            raise AssertionError(f"{label}: {kernel} never launched")
        if kernel == "cache_matmul" and served.dtype == "bfloat16":
            _gate_kinds(counts, label, ("gemv",))
        for tid, s in outs[0]["tenants"].items():
            p = outs[1]["tenants"][tid]
            if not np.array_equal(s["output"], p["output"]):
                raise AssertionError(f"{label} {tid}: serial and "
                                     "pipelined tokens differ")
            if s["choices"] != p["choices"]:
                raise AssertionError(f"{label} {tid}: choices differ")
        res[f"{width}@{pages}p"] = {
            "d_model": served.d_model, "layers": served.num_layers,
            "dtype": served.dtype, "kind": kind, "plans": plans,
            "launches": {k: v for k, v in counts.items()
                         if k.startswith(kernel)}, "tokens": {
                tid: v["tokens"] for tid, v in outs[1]["tenants"].items()},
            "bit_identical": True}
    if not any(r["kind"] == "LBM" for r in res.values()):
        raise AssertionError("self: no pool was granted LBM")
    return res


# ------------------------------------------------------------- graphs --
def _replay_vs_eager(srv, item):
    """One decode item or prompt chunk of a pipelined server on the card:
    the epoch core (or prefill core) runs eagerly, straight from the
    model, on clones of its tenants' caches, feedback tokens and device
    positions; then the server dispatches the item through its program
    (captured on a miss, then replayed).  Returns whether the tokens,
    every cache buffer, the feedback tokens and the positions are bitwise
    equal, the captures it took, and the kernel launches of both runs
    (the replay's from the counts its capture recorded)."""
    import torch
    from repro_torch.kernels import counters as kcount
    kind = item[0]
    if kind == "prefill":
        _, t, _, n = item
        group, plan, kv = [t], None, srv._kv_len(t.pf_pos + n)
    else:
        _, who, plan, n = item
        group, kv = (who if kind == "bucket" else [who]), srv._item_kv(item)
    clones = {t.tid: ([{name: b.clone() for name, b in c.items()}
                       for c in t.caches], t.token.clone(),
                      t.index_dev.clone(), srv._device_pos(t))
              for t in group}
    want = {}
    before = kcount.snapshot()
    for t in group:
        caches, tok, idx, pos = clones[t.tid]
        if kind == "prefill":
            want[t.tid], _ = srv._prefill_cores[t.cfg.name](
                t.params, caches, t.prompt_dev[:, pos:pos + n], idx, kv_len=kv)
        else:
            want[t.tid], _ = srv._epoch_cores[t.cfg.name](
                t.params, caches, tok, idx, plan=plan, k=n, kv_len=kv)
    eager = kcount.delta(before)
    captures = srv._captures
    before = kcount.snapshot()
    if kind == "prefill":
        srv._dispatch_prefill(item)
    else:
        srv._fused_epoch_fn(item)()
        for t in group:
            srv._advance(t, n)
    replay = kcount.delta(before)
    torch.cuda.synchronize()
    same = True
    for t in group:
        caches, _, _, pos = clones[t.tid]
        out = want[t.tid]
        same &= (torch.equal(t.log[:, pos + n - out.shape[1]:pos + n], out)
                 and torch.equal(t.token, out[:, -1:])
                 and int(t.index_dev) == pos + n == srv._device_pos(t)
                 and all(torch.equal(c[name], e[name])
                         for c, e in zip(t.caches, caches) for name in c))
    return {"kind": kind, "tenants": len(group), "position": pos, "steps": n,
            "kv_len": kv, "plan": plan.describe() if plan is not None else None,
            "kv_dtype": group[0].kv_dtype, "bitwise": bool(same),
            "captured": srv._captures - captures, "launches": replay,
            "eager_launches": eager}


def graph_checks(arch, dev, kv_dtype: str = "native", prompt_len=None):
    """Replay against eager dispatch in one pipelined server of ``arch``
    cut to :data:`GRAPHS`'s layers: a prompt tenant's chunks (chunks of
    256) and its decode epochs, and for a dense or MoE arch with a native
    cache a resident's epochs alone and two residents' as a bucket.  Each
    decode item runs twice, at two positions: the first captures (after
    a warm-up where its signature has none), the second replays the same
    graph.  An MoE tenant's decode binds no plan (``_dec_plan``).
    Returns the checks and the server's record."""
    from repro_torch.core.vmem import LANE
    from repro_torch.launch.serve import MultiTenantServer
    from repro_torch.models.base import register
    from repro_torch.sim.driver import TenantSpec
    g = GRAPHS
    k = g["k"]
    if prompt_len is None:
        prompt_len = g["prompt_len"]
    cut = register(dataclasses.replace(
        arch, name=f"{arch.name}-{g['layers']}layer", num_layers=g["layers"]))
    dense = arch.family != "ssm"
    residents = [cut.name] * (3 if dense and kv_dtype == "native" else 0)
    srv = MultiTenantServer(
        residents, tenants=[TenantSpec(cut.name, prompt_len=prompt_len,
                                       n_inferences=2 * k)],
        batch=g["batch"], max_len=g["max_len"], total_pages=1 << 16,
        epoch_len=k, device=dev, reduced=False, kv_dtype=kv_dtype)
    planned = dense and not arch.is_moe
    plan = (_plan(cut, "LWM", g["lwm_pages"], LANE, kv_dtype) if planned
            else None)
    res_plan = _plan(cut, "LWM", g["lwm_pages"], LANE) if planned else None
    *res_t, prompt_t = srv.tenants
    checks = []
    while prompt_t.prefilling:    # chunks of 256, on the SSD grid
        chunk = min(256, prompt_t.prompt_len - prompt_t.pf_pos)
        checks.append(_replay_vs_eager(srv, ("prefill", prompt_t, None,
                                             chunk)))
    items = [("single", prompt_t, plan, k)]
    if res_t:
        items += [("single", res_t[0], res_plan, k),
                  ("bucket", res_t[1:], res_plan, k)]
    for item in items:     # capture, then a replay one epoch later
        checks += [_replay_vs_eager(srv, item) for _ in range(2)]
    rec = {"captures": srv._captures, "capture_s": srv._capture_s,
           "graph_pool_bytes": _graph_pool_bytes(srv),
           "warm_signatures": len(srv._warm_sigs)}
    del srv, res_t, prompt_t
    _release()
    return checks, rec


def _graph_faults(checks):
    """The checks that are not bitwise or whose replay launched other
    kernels than the eager run, and a second replay that captured."""
    bad = [c for c in checks if not c["bitwise"]
           or c["launches"] != c["eager_launches"]]
    repeats = [c for c in checks if c["kind"] != "prefill"][1::2]
    if any(c["captured"] for c in repeats):
        bad.append("a second replay captured")
    return bad


def check_graphs(cfg, ssm_cfg, dev, kinds: bool = True, moe_cfg=None):
    """Graph replay against eager dispatch at full width (4 layers), by
    :func:`graph_checks`: in a pipelined yi-9b server a prompt tenant's
    chunks (256 + 128 tokens) and epochs with a native and, in a second
    server, an int8 cache, a resident's epochs alone and two residents'
    as a bucket; in a mamba2 server a prompt tenant's 256-token chunk
    and 44-token tail and its epochs; with ``moe_cfg``, the same items of
    olmoe-1b-7b (native cache).  Every check must be bitwise in tokens
    and every cache buffer, launch the kernels the eager run launches (by
    the counts), and a second replay must capture nothing."""
    g = GRAPHS
    res, checks = {}, []
    cases = [(cfg, "native", g["prompt_len"]), (cfg, "int8", g["prompt_len"]),
             (ssm_cfg, "native", g["ssm_prompt_len"])]
    if moe_cfg is not None:
        cases.append((moe_cfg, "native", g["prompt_len"]))
    for arch, kv_dtype, prompt_len in cases:
        got, res[f"{arch.name}/{kv_dtype}"] = graph_checks(
            arch, dev, kv_dtype, prompt_len)
        checks += got
    bad = _graph_faults(checks)
    items = {c["kind"] for c in checks}
    launches = Counter()
    for c in checks:
        launches.update(c["launches"])
    if (bad or items != {"prefill", "single", "bucket"}
            or not launches["cache_matmul"] or not launches["ssd_chunk"]):
        raise AssertionError(f"graphs: {bad or items} ({dict(launches)}): "
                             f"{checks}")
    aot = _check_aot(cfg, dev)
    if kinds:   # full width: the decode matmuls' gemv, ssd_chunk's wgmma
        _gate_kinds({**dict.fromkeys(_counters(), 0), **launches}, "graphs",
                    ("gemv",),
                    ssd=("wgmma",))
    return {"layers": g["layers"], "servers": res, "checks": checks,
            "launches": dict(launches), "aot": aot, "bit_identical": True}


def _check_aot(cfg, dev):
    """``aot_warmup=True`` on the card (full width, 4 layers): two
    residents and a prompt tenant served with and without it; the tokens
    and choice traces must be equal, and the predicted programs (captured
    before the first epoch, each warm-up at the tenants' positions then)
    must be hits."""
    from repro_torch.launch.serve import MultiTenantServer
    from repro_torch.sim.driver import TenantSpec
    name = f"{cfg.name}-{GRAPHS['layers']}layer"
    runs = {}
    for aot in (False, True):
        srv = MultiTenantServer(
            [name, name], tenants=[TenantSpec(name, prompt_len=256,
                                              n_inferences=8)],
            batch=GRAPHS["batch"], max_len=GRAPHS["max_len"],
            total_pages=1 << 16, epoch_len=GRAPHS["k"], device=dev,
            reduced=False, aot_warmup=aot)
        out = srv.run(steps=16)
        runs[aot] = (out, srv._fused_jits.misses)
        del srv
        _release()
    (plain, plain_misses), (warm, warm_misses) = runs[False], runs[True]
    for tid, p in plain["tenants"].items():
        w = warm["tenants"][tid]
        if not np.array_equal(p["output"], w["output"]) or \
                p["choices"] != w["choices"]:
            raise AssertionError(f"aot: {tid} differs with aot_warmup")
    if not warm["host"]["aot_compiled"] or warm_misses >= plain_misses:
        raise AssertionError(f"aot: {warm['host']} misses {warm_misses} "
                             f"vs {plain_misses}")
    return {"aot_compiled": warm["host"]["aot_compiled"],
            "fused_misses": {"plain": plain_misses, "aot": warm_misses},
            "epoch_compiles": {"plain": plain["host"]["epoch_compiles"],
                               "aot": warm["host"]["epoch_compiles"]},
            "tokens_equal": True}


# ------------------------------------------------------------ prefill --
def _plain_quantized_attention(fn):
    """``fn()`` with the quantized flash kernel's plain version in place
    of the kernel (a control run: it launches no quantized kernel)."""
    from repro_torch.kernels import flash_attention as kfa
    kernel = kfa.flash_attention_quantized
    kfa.flash_attention_quantized = (
        lambda q, k, v, ks, vs, causal, tile:
        kfa.flash_attention_quantized_plain(q, k, v, ks, vs, causal))
    try:
        return fn()
    finally:
        kfa.flash_attention_quantized = kernel


def _layer_trace(fn):
    """``fn()`` with each dense layer's attention output and output
    recorded and, in an MoE layer, the experts each token was routed to
    and those that the capacity buckets kept ([G, T, E] masks, taken from
    ``moe_apply``'s own dispatch).  Returns (fn's result, one record per
    layer in order)."""
    import torch
    from repro_torch.models import moe
    from repro_torch.models import transformer as tr
    block, attention, dispatch = tr._dense_block, tr.mha, moe._dispatch
    records, layer = [], {}

    def traced_mha(*args, **kwargs):
        out = attention(*args, **kwargs)
        layer["attn"] = out[0]
        return out

    def traced_dispatch(x, top_e, C, E):
        out = dispatch(x, top_e, C, E)
        _, order, _, keep, tok = out
        G, T, K = top_e.shape
        expert = torch.gather(top_e.reshape(G, T * K), 1, order)
        kept = torch.zeros((G, T * E), dtype=torch.bool, device=x.device)
        kept.scatter_(1, tok * E + expert, keep)
        routed = torch.nn.functional.one_hot(top_e, E).sum(-2) > 0
        layer.update(routed=routed, kept=kept.reshape(G, T, E))
        return out

    def traced_block(*args, **kwargs):
        out = block(*args, **kwargs)
        records.append({"x": out[0], **layer})
        layer.clear()
        return out

    tr._dense_block, tr.mha, moe._dispatch = (traced_block, traced_mha,
                                              traced_dispatch)
    try:
        return fn(), records
    finally:
        tr._dense_block, tr.mha, moe._dispatch = block, attention, dispatch


def _layer_divergence(got, want):
    """Per layer, how far two traced runs drift apart: the attention
    outputs' and the layer outputs' max |difference| over ``want``'s
    largest value and, in an MoE layer, the tokens whose top-k experts
    differ (``route_flips``) and those whose kept experts differ under
    the same top-k (``displaced``: pushed out of, or let into, a full
    bucket by another token's new route)."""
    def rel(g, w):
        w = w.float()
        return float((g.float() - w).abs().max() / w.abs().max())

    rows = []
    for g, w in zip(got, want):
        row = {"attn_rel_err": rel(g["attn"], w["attn"]),
               "rel_err": rel(g["x"], w["x"])}
        if "routed" in w:
            flips = (g["routed"] != w["routed"]).any(-1)
            moved = (g["kept"] != w["kept"]).any(-1) & ~flips
            row.update(route_flips=int(flips.sum()), displaced=int(moved.sum()))
        rows.append(row)
    return rows


def _min_cosine(got, want) -> float:
    import torch
    return float(torch.nn.functional.cosine_similarity(got, want,
                                                       dim=-1).min())


def prefill_main_path(cfg, dev, counters, label: str = "prefill", plans=None,
                      serve=(), profiled=("LBM/native", "LWM/int8",
                                          "LWM/fp8_e4m3")):
    """``make_prefill`` of a full-width, full-depth arch (yi-9b: slice
    2's path; olmoe-1b-7b: the MoE slice's, one ``planned_ffn`` per
    expert and layer under a plan), 2 prompts of 1024 tokens from numpy,
    random weights from one seed, under ``plans`` (default: the four
    settings of :func:`prefill_plans`), then ``make_prefill(cfg,
    serve=True)`` under each plan named in ``serve``.  ``counters``
    receives the launch counts of one pass of the calls (zeroed just
    before, read just after); each call's own counts are kept too.
    Gates: finite logits; every plan within :func:`_gate` of the plain
    path of its ``serve``; a quantized-KV plan also at the cosine bar of
    :data:`PREFILL_COSINE` against it, and within :func:`_gate` of a
    control run that puts the plain attention in place of the quantized
    kernel, the kernel's and the control's runs compared layer by layer
    (:func:`_layer_divergence`); every bf16 launch of the wgmma kind.
    Then each call is timed warm on the host clock, and those named in
    ``profiled`` profiled once."""
    import torch
    from repro_torch.models import model as M
    B, S = PREFILL["batch"], PREFILL["prompt_len"]
    V = cfg.vocab_size
    params = M.init_params(cfg, seed=2, device=dev)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, V, (B, S))).long().to(dev)
    plans = plans or prefill_plans(cfg)
    calls = {name: (M.make_prefill(cfg), plan) for name, plan in plans.items()}
    calls.update({f"serve/{n}": (M.make_prefill(cfg, serve=True), plans[n])
                  for n in serve})

    def call(name):
        fn, plan = calls[name]
        out = fn(params, {"tokens": toks}, plan)
        torch.cuda.synchronize()
        return out

    _zero_counters()
    logits, first_s, per_call = {}, {}, {}
    for name in calls:
        before = _counters()
        t0 = time.perf_counter()
        logits[name] = call(name)[:, :V].float()
        first_s[name] = time.perf_counter() - t0
        per_call[name] = {k: v - before[k] for k, v in _counters().items()
                          if v - before[k]}
    counters.update(_counters())
    if min(counters[k] for k in PREFILL_KERNELS) <= 0:
        raise AssertionError(f"{label}: a kernel never launched: {counters}")
    _gate_kinds(counters, label, ("wgmma",), ("wgmma",), ("wgmma",),
                flash_quantized=("wgmma",))
    bad = [n for n, lg in logits.items() if not bool(torch.isfinite(lg).all())]
    if bad:
        raise AssertionError(f"{label}: non-finite logits under {bad}")
    plain = {False: logits["plain"]}
    if serve:
        plain[True] = M.make_prefill(cfg, serve=True)(
            params, {"tokens": toks})[:, :V].float()
    gates = {}
    for name, lg in logits.items():
        if name == "plain":
            continue
        want = plain[name.startswith("serve/")]
        gate = gates[name] = {**_gate(lg, want, f"{label} {name}"),
                              "min_cosine": _min_cosine(lg, want)}
        kv = calls[name][1].kv_dtype
        if kv == "native":
            continue
        # the control: the same plan and quantized K/V through the plain
        # attention, so the kernel's share of the error shows apart from
        # the quantization's
        _, traced = _layer_trace(lambda n=name: call(n))
        control, control_traced = _layer_trace(
            lambda n=name: _plain_quantized_attention(lambda: call(n)))
        control = control[:, :V].float()
        gate.update(min_cosine_bar=PREFILL_COSINE[kv],
                    control_min_cosine=_min_cosine(control, want),
                    control_max_abs_err=float((control - want).abs().max()),
                    vs_control=_gate(lg, control,
                                     f"{label} {name} vs control"),
                    layers_vs_control=_layer_divergence(traced,
                                                        control_traced))
        del traced, control_traced
        if gate["min_cosine"] < PREFILL_COSINE[kv]:
            raise AssertionError(f"{label} {name}: {gate}")
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    for name, (_, plan) in calls.items():
        t0 = time.perf_counter()
        call(name)
        wall = time.perf_counter() - t0
        runs[name] = {"plan": plan.describe() if plan is not None else None,
                      "first_wall_s": first_s[name], "wall_s": wall,
                      "tokens_per_s": B * S / wall,
                      "launches": per_call[name]}
    peak = torch.cuda.max_memory_allocated()
    profiles = {name: {"plan": runs[name]["plan"],
                       **_profile(lambda n=name: call(n))}
                for name in profiled}
    return {"arch": cfg.name, "layers": cfg.num_layers, "batch": B,
            "prompt_len": S, "launches": dict(counters), "gates": gates,
            "runs": runs, "peak_memory_bytes": peak, "profile": profiles}


# ----------------------------------------------------------- serve_kv --
def serve_kv_pool(cfg) -> int:
    """The serve_kv pool: one native reservation, one fp8 reservation and
    the serve phase's headroom above its native reservation."""
    from repro_torch.launch.serve import _kv_reserve_pages
    b, p = SERVE_KV["batch"], SERVE_KV["prompt_len"]
    native = _kv_reserve_pages(cfg, b, p)
    return native + _kv_reserve_pages(cfg, b, p, "fp8_e4m3") + (SERVE_PAGES
                                                                 - native)


def _profile_cache_epoch(cfg, params, dev, plan, kv_dtype, k: int = 4):
    """:func:`_profile` of one decode epoch (batch and prompt of
    :data:`SERVE_KV`) of a tenant with a ``kv_dtype`` cache, prefilled
    from a seeded prompt; K/V (de)quantization annotated."""
    import torch
    from repro_torch.core.vmem import LANE
    from repro_torch.kernels import quant
    from repro_torch.models import model as M
    from repro_torch.models.transformer import init_caches
    B, P, L = SERVE_KV["batch"], SERVE_KV["prompt_len"], SERVE_KV["max_len"]
    caches = init_caches(params, cfg, B, L, kv_dtype=kv_dtype, device=dev)
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, P))).long().to(dev)
    token, caches = M.make_prefill_chunk(cfg)(params, caches, prompt, 0)
    epoch = M.make_decode_epoch(cfg)
    state = {"token": token, "index": P}

    def run():
        i = state["index"]                 # the server's 128-token windows
        toks, _ = epoch(params, caches, state["token"], i, plan=plan, k=k,
                        kv_len=min(L, -(-(i + k) // LANE) * LANE))
        state["token"], state["index"] = toks[:, -1:], i + k
        torch.cuda.synchronize()

    names = ("quantize_rows", "dequantize_rows")
    kept = {n: getattr(quant, n) for n in names}

    def annotated(name):
        def fn(*a, **kw):
            with torch.profiler.record_function(name):
                return kept[name](*a, **kw)
        return fn

    for n in names:
        setattr(quant, n, annotated(n))
    try:
        return {"plan": plan.describe(), "kv_dtype": kv_dtype, "steps": k,
                **_profile(run, annotations=names)}
    finally:
        for n, fn in kept.items():
            setattr(quant, n, fn)


def serve_kv_main_path(cfg, dev, counters, found):
    """Quantized-KV serving: full-width, full-depth yi-9b under
    ``kv_dtype="auto"``, one resident tenant and three prompt tenants
    arriving at distinct steps, all on one weight set (``params_fn``
    memo), in the :func:`serve_kv_pool`.  The rung each arrival must take
    is computed from the reservation quotes and the free pages at its
    admission (the pool less the reservations already held), and
    asserted with the free pages the server saw.  ``counters`` receives
    the kernels' launch counts of the run (zeroed just before, read just
    after), ``found["decode_plan"]`` the int8 tenant's last decode plan.
    Then one decode epoch under that plan is profiled with a native and
    with an int8 cache."""
    import torch
    from repro_torch.core.policy import KV_PRECISION_LADDER, choose_kv_dtype
    from repro_torch.kernels import quant
    from repro_torch.launch.serve import MultiTenantServer, _kv_reserve_pages
    from repro_torch.models import model as M
    from repro_torch.sim.driver import TenantSpec
    torch.cuda.reset_peak_memory_stats()
    B, P = SERVE_KV["batch"], SERVE_KV["prompt_len"]
    budget, steps = SERVE_KV["budget"], SERVE_KV["steps"]
    pool = serve_kv_pool(cfg)
    quotes = {kv: _kv_reserve_pages(cfg, B, P, kv) for kv in KV_PRECISION_LADDER}
    free, want_free, want_rungs = pool, [], []
    for _ in SERVE_KV["arrive_at"]:
        rung = choose_kv_dtype(quotes, free)
        want_free.append(free)
        want_rungs.append(rung)
        free -= min(quotes[rung], free)
    if want_rungs != ["native", "fp8_e4m3", "int8"]:
        raise AssertionError(f"serve_kv: pool {pool} gives rungs {want_rungs}")
    memo = {}

    def params_fn(c, pkey):
        if pkey not in memo:
            memo[pkey] = M.init_params(c, pkey, dev)
        return memo[pkey]

    specs = [TenantSpec(cfg.name, param_seed=0)] + [
        TenantSpec(cfg.name, arrive_at=at, prompt_len=P, n_inferences=budget,
                   param_seed=0) for at in SERVE_KV["arrive_at"]]
    srv = MultiTenantServer([], tenants=specs, batch=B,
                            max_len=SERVE_KV["max_len"], total_pages=pool,
                            epoch_len=4, device=dev, reduced=False,
                            kv_dtype="auto", params_fn=params_fn)
    seen_free, stamped = [], {}
    choose, record = srv._choose_kv_dtype, srv._record_page_scales

    def spy_choose(c, spec):
        seen_free.append(srv.cache.free_pages)
        return choose(c, spec)

    def spy_record(t):
        record(t)
        stamped[t.tid] = {
            "leaves": {n: str(b.dtype) for n, b in t.caches[0].items()},
            "page_scales": list(srv.cache.page_scales_of(t.tid + "#kv")
                                .values()),
            "pages": len(srv.cache.pages_of(t.tid + "#kv"))}

    srv._choose_kv_dtype, srv._record_page_scales = spy_choose, spy_record
    _zero_counters()
    out = srv.run(steps=steps)
    counters.update(_counters())
    programs = _programs(srv, out)
    if counters["cache_matmul"] <= 0:
        raise AssertionError(f"serve_kv: cache_matmul never launched: {counters}")
    if seen_free != want_free:
        raise AssertionError(f"serve_kv: free pages at admission {seen_free}, "
                             f"predicted {want_free}")
    want_kinds = grantable_kinds(cfg, B, pool)
    kinds = {p.kind for t in srv.tenants for p in t.plans}
    if kinds != want_kinds:
        raise AssertionError(f"serve_kv: plan kinds {kinds}, the scheduler "
                             f"grants {want_kinds}")
    resident, arrivals = srv.tenants[0], srv.tenants[1:]
    vocab, tenants = cfg.vocab_size, {}
    for t, rung in [(resident, "native")] + list(zip(arrivals, want_rungs)):
        res = out["tenants"][t.tid]
        o = res["output"]
        want_len = steps if t.prompt_len == 0 else 1 + budget
        tags = {p.describe().partition("+kv:")[2] or "native" for p in t.plans}
        leaves = (stamped[t.tid]["leaves"] if t.prompt_len else
                  {n: str(b.dtype) for n, b in t.caches[0].items()})
        want_leaves = ({"k": "torch.bfloat16", "v": "torch.bfloat16"}
                       if rung == "native" else
                       {"k": str(quant.kv_storage_dtype(rung)),
                        "v": str(quant.kv_storage_dtype(rung)),
                        "k_scale": "torch.float32", "v_scale": "torch.float32"})
        problems = []
        if t.kv_dtype != rung or res["kv_dtype"] != rung or tags != {rung}:
            problems.append(f"rung {t.kv_dtype}/{res['kv_dtype']} tags {tags}")
        if leaves != want_leaves:
            problems.append(f"cache leaves {leaves}")
        if t.prompt_len and t.kv_wanted != quotes[rung]:
            problems.append(f"kv_wanted {t.kv_wanted} != {quotes[rung]}")
        if rung != "native":
            sc = stamped[t.tid]
            if not sc["page_scales"] or sc["pages"] != len(sc["page_scales"]) \
                    or min(sc["page_scales"]) <= 0:
                problems.append(f"page scales {sc}")
        if o.shape != (B, want_len) or o.min() < 0 or o.max() >= vocab:
            problems.append(f"output {o.shape} range [{o.min()}, {o.max()}]")
        if problems:
            raise AssertionError(f"serve_kv {t.tid}: {problems}")
        tenants[t.tid] = {
            "kv_dtype": t.kv_dtype, "tokens": res["tokens"],
            "ttft_s": res["ttft_s"], "kv_wanted": res["kv_wanted"],
            "kv_reserved": res["kv_reserved"],
            "prefill_chunks": res["prefill_chunks"],
            "plans": dict(Counter(p.describe() for p in t.plans)),
            "page_scales": ({"n": len(stamped[t.tid]["page_scales"]),
                             "min": min(stamped[t.tid]["page_scales"]),
                             "max": max(stamped[t.tid]["page_scales"])}
                            if rung != "native" else None),
            "first_tokens": o[0, :8].tolist()}
    full = [t.kv_reserved == t.kv_wanted for t in arrivals]
    if full != [True, True, False]:
        raise AssertionError(f"serve_kv: full reservations {full}, want "
                             "the first two full and the int8 one partial")
    res = {"arch": cfg.name, "layers": cfg.num_layers, "total_pages": pool,
           "quotes": quotes, "free_at_admission": seen_free,
           "rungs": [t.kv_dtype for t in arrivals], "batch": B,
           "max_len": SERVE_KV["max_len"], "steps": steps,
           "plan_kinds": sorted(kinds), "launches": dict(counters),
           "tokens_served": out["tokens_served"], "wall_s": out["wall_s"],
           "tokens_per_s": out["tokens_per_s"], "dram_total": out["dram_bytes"],
           "host": out["host"], "tenants": tenants, "programs": programs,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    res["warm"] = _warm_runs(srv, SERVE_KV["warm_steps"])
    res["graph_pool_bytes"] = _graph_pool_bytes(srv)
    res["profile_replay"] = _profile_replay(srv, resident)
    int8 = arrivals[2]
    plan = int8.plans[-1]                       # its last decode epoch's
    params = memo[0]
    del srv, resident, arrivals, int8
    found["decode_plan"] = plan
    res["decode_plan"] = plan.describe()
    res["profile"] = {kv: _profile_cache_epoch(cfg, params, dev, plan, kv)
                      for kv in ("native", "int8")}
    prof = res["profile"]
    if all(isinstance(prof[kv]["device_ms"], float) for kv in prof):
        res["quantized_cache_overhead_share"] = (
            1 - prof["native"]["device_ms"] / prof["int8"]["device_ms"])
    return res


# ---------------------------------------------------------- ffn_quant --
def _plain_ffn_quant(x, wg, wg_s, wu, wu_s, wd, wd_s):
    import torch.nn.functional as F
    from repro_torch.kernels import cache_matmul as kmm
    g = kmm.cache_matmul_quant_plain(x, wg, wg_s)
    u = kmm.cache_matmul_quant_plain(x, wu, wu_s)
    h = (F.silu(g.float()) * u.float()).to(x.dtype)
    return kmm.cache_matmul_quant_plain(h, wd, wd_s)


def _library_quant_ms(a, q, scale, want, dn):
    """One PyTorch call computing the same function, timed on the same
    inputs: ``torch._weight_int8pack_mm`` for int8 codes where this
    build runs it on CUDA and it agrees with the plain version; else
    None and the reason."""
    import torch
    if q.dtype != torch.int8:
        return None, "no PyTorch call takes fp8 codes with per-column scales"
    fn = getattr(torch, "_weight_int8pack_mm", None)
    if fn is None:
        return None, "torch._weight_int8pack_mm missing"
    qt, st = q.t().contiguous(), scale[0].to(a.dtype).contiguous()
    try:
        got = fn(a, qt, st)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        return None, f"torch._weight_int8pack_mm: {str(e).splitlines()[0][:160]}"
    err, ok = _close(got, want, dn)
    if not ok:
        return None, f"torch._weight_int8pack_mm disagrees: max error {err}"
    return _median_ms(lambda: fn(a, qt, st), 10), "torch._weight_int8pack_mm"


def quant_timings(cfg, dev, plans):
    """cache_matmul_quant at the ffn_quant path's GEMMs (bf16 A, int8 and
    fp8 codes, M = 2 and 2048 rows, gate/up and down) with the tiles each
    plan lowers to (gemv at 2 rows, wgmma at 2048), against its plain
    version on the timed inputs and bitwise on a repeat: CUDA event
    medians of the kernel and, in turns with it, of the simt tile the
    same plan gave before the new kinds (``simt_ms``), of the plain
    version, a library call where one computes the same function, and
    ``torch.matmul`` on a bf16 B dequantized beforehand (a yardstick for
    another function)."""
    import torch
    from repro_torch.kernels import cache_matmul as kmm
    from repro_torch.kernels import ops, quant
    d, f = cfg.d_model, cfg.d_ff
    dt, dn, eb = torch.bfloat16, "bfloat16", 2
    limit = ops.smem_limit(torch.device(dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    out, timed = {}, {}
    for rows in (2, 2048):
        acts = {"up": _randn(gen, (rows, d), dt), "down": _randn(gen, (rows, f), dt)}
        for kv in KV_CACHES:
            for gemm, (k, n) in (("up", (d, f)), ("down", (f, d))):
                w = _randn(gen, (k, n), torch.float32, 1 / math.sqrt(k))
                q, sc = quant.quantize_cols(w, kv)
                deq = (q.float() * sc).to(dt)
                a = acts[gemm]
                want = kmm.cache_matmul_quant_plain(a, q, sc)
                lib_ms, lib = _library_quant_ms(a, q, sc, want, dn)
                for pname, plan in plans.items():
                    tiles = ops.ffn_quant_tiles(plan, rows, d, f)
                    tile = tiles[0] if gemm == "up" else tiles[1]
                    hop = ops.legalize_matmul_quant_tile(tile, rows, limit,
                                                         dt, k, n)
                    # the simt tile the same plan gives fp32 (every bf16
                    # call's before the gemv and wgmma kinds)
                    simt = ops.legalize_matmul_quant_tile(
                        tile, rows, limit, torch.float32, k, n)
                    if (hop, simt) not in timed:  # plans that share tiles
                        bound, by = _bound(
                            eb * (rows * k + rows * n) + k * n + 4 * n,
                            2 * rows * k * n, dn)
                        got = kmm.cache_matmul_quant(a, q, sc, hop)
                        err, ok = _close(got, want, dn)
                        repeat = bool(torch.equal(
                            got, kmm.cache_matmul_quant(a, q, sc, hop)))
                        del got
                        reps = 30 if rows <= 8 else 10
                        t = _turns_ms({
                            "ms": lambda: kmm.cache_matmul_quant(a, q, sc, hop),
                            "simt_ms": lambda: kmm.cache_matmul_quant(
                                a, q, sc, simt)}, reps)
                        timed[hop, simt] = {
                            "kv": kv, "shape": [rows, k, n], "kind": hop.kind,
                            "hopper_tile": [hop.bm, hop.bn, hop.bk],
                            "simt_tile": [simt.bm, simt.bn, simt.bk], **t,
                            "speedup_vs_simt": t["simt_ms"] / t["ms"],
                            "plain_ms": _median_ms(
                                lambda: kmm.cache_matmul_quant_plain(a, q, sc),
                                reps),
                            "library_ms": lib_ms, "library": lib,
                            "yardstick_matmul_dequantized_bf16_ms": _median_ms(
                                lambda: torch.matmul(a, deq), reps),
                            "bound_ms": bound, "bound_by": by,
                            "max_abs_err": err, "bitwise_repeat": repeat,
                            "ok": ok and repeat}
                        if lib_ms is not None:
                            timed[hop, simt]["vs_library"] = t["ms"] / lib_ms
                        if hop.kind == "gemv":
                            timed[hop, simt]["gemv_split"] = list(
                                kmm.gemv_split(n, k, torch.cuda.
                                               get_device_properties(
                                                   a.device).multi_processor_count))
                    out[f"{kv} {pname} m{rows} {gemm}"] = {
                        "plan": pname, "plan_tile": [tile.bm, tile.bn, tile.bk],
                        **timed[hop, simt]}
                timed.clear()
                del w, q, sc, deq
    return out


def ffn_quant_plans(cfg, decode_plan):
    """The FfnPlans the ffn_quant phase runs: the decode grant of the
    serve_kv phase's int8 tenant, the LWM@32p prefill plan, and the
    smallest fused (LBM) prefill grant, whose quantized FFN takes the
    fallback tile."""
    from repro_torch.core.vmem import fused_ffn_pages
    s = PREFILL["prompt_len"]
    lbm = _plan(cfg, "LBM", fused_ffn_pages(s, cfg.d_model, cfg.d_ff, 2), s)
    lwm = _plan(cfg, "LWM", PREFILL["lwm_pages"], s)
    return {f"decode {decode_plan.describe()}": decode_plan.ffn,
            f"prefill {lwm.describe()}": lwm.ffn,
            f"fallback {lbm.describe()}": lbm.ffn}


def ffn_quant_main_path(cfg, dev, decode_plan, counters):
    """``ops.planned_ffn_quant`` over every layer of full-width yi-9b,
    FFN weights drawn in bf16 from one seed and quantized per column to
    int8 and to fp8, on x of 2 and of 2048 rows, under the three plans of
    :func:`ffn_quant_plans`.  ``counters`` receives the launch counts of
    one pass of the twelve settings (zeroed just before, read just
    after); each setting's 48-layer pass is timed on the host clock,
    synchronised.  Gates per layer: within tolerance of the plain chain on
    the same codes, and at :data:`PREFILL_COSINE` (per row) against
    ``ops.planned_ffn`` on the bf16 weights under the same plan."""
    import torch
    from repro_torch.kernels import ops, quant
    L, d, f = cfg.num_layers, cfg.d_model, cfg.d_ff
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    plans = ffn_quant_plans(cfg, decode_plan)
    weights, qweights = [], {kv: [] for kv in KV_CACHES}
    for _ in range(L):
        w = tuple(_randn(gen, shape, torch.bfloat16, 1 / math.sqrt(shape[0]))
                  for shape in ((d, f), (d, f), (f, d)))
        weights.append(w)
        for kv in KV_CACHES:
            qweights[kv].append(tuple(t for wi in w
                                      for t in quant.quantize_cols(wi, kv)))
    xs = {rows: _randn(gen, (rows, d), torch.bfloat16) for rows in (2, 2048)}
    settings = [(kv, pname, rows) for kv in KV_CACHES for pname in plans
                for rows in xs]
    for kv, pname, rows in settings:                        # warm
        ops.planned_ffn_quant(xs[rows], *qweights[kv][0], plans[pname])
    torch.cuda.synchronize()
    _zero_counters()
    outs, pass_ms = {}, {}
    for key in settings:
        kv, pname, rows = key
        t0 = time.perf_counter()
        outs[key] = [ops.planned_ffn_quant(xs[rows], *qweights[kv][l],
                                           plans[pname]) for l in range(L)]
        torch.cuda.synchronize()
        pass_ms[key] = (time.perf_counter() - t0) * 1e3
    counters.update(_counters())
    if counters["cache_matmul_quant"] != len(settings) * L * 3:
        raise AssertionError(f"ffn_quant: launches {counters}, want "
                             f"{len(settings) * L * 3} cache_matmul_quant")
    # bf16 activations: 2 rows on the gemv tile, 2048 on a wgmma tile
    _gate_kinds(counters, "ffn_quant", quant=("gemv", "wgmma"))
    if counters["cache_matmul_quant.gemv"] != counters["cache_matmul_quant"] // 2:
        raise AssertionError(f"ffn_quant: kinds {counters}")
    results = {}
    for pname in plans:
        for rows, x in xs.items():
            ref = [ops.planned_ffn(x, *weights[l], plans[pname])
                   for l in range(L)]
            for kv in KV_CACHES:
                key = (kv, pname, rows)
                worst_err, min_cos, bad = 0.0, 1.0, []
                for l, got in enumerate(outs.pop(key)):
                    err, ok = _close(got, _plain_ffn_quant(x, *qweights[kv][l]),
                                     "bfloat16")
                    cos = float(torch.nn.functional.cosine_similarity(
                        got.float(), ref[l].float(), dim=-1).min())
                    worst_err, min_cos = max(worst_err, err), min(min_cos, cos)
                    if not ok or not bool(torch.isfinite(got).all()):
                        bad.append(l)
                if bad or min_cos < PREFILL_COSINE[kv]:
                    raise AssertionError(
                        f"ffn_quant {key}: layers {bad} off the plain chain "
                        f"(max error {worst_err}), min cosine {min_cos} "
                        "against planned_ffn")
                results[f"{kv} {pname} m{rows}"] = {
                    "pass_ms": pass_ms[key], "max_abs_err_vs_plain": worst_err,
                    "tol": TOL["bfloat16"],
                    "min_cosine_vs_bf16_planned_ffn": min_cos,
                    "min_cosine_bar": PREFILL_COSINE[kv]}
            del ref
    del weights, qweights, xs
    torch.cuda.empty_cache()
    timings = quant_timings(cfg, dev, plans)
    bad = [k for k, v in timings.items() if not v["ok"]]
    if bad:
        raise AssertionError(f"ffn_quant: kernel off its plain version: {bad}")
    return {"arch": cfg.name, "layers": L, "plans": list(plans),
            "launches": dict(counters), "settings": results,
            "timings": timings}


# --------------------------------------------------------------- main --
# ---------------------------------------------------------------- ssm --
def _ssm_plans(cfg):
    """The plans of :data:`SSM_GRANTS` (LWM grants; an SSM layer reads
    only their SSD chunk), keyed by the chunk each lowers to."""
    from repro_torch.core.vmem import LANE
    plans = {}
    for pages in SSM_GRANTS:
        plan = _plan(cfg, "LWM", pages, LANE)
        plans[plan.ssm_chunk] = plan
    if sorted(plans, reverse=True) != [256, 128, 64]:
        raise AssertionError(f"SSM grants {SSM_GRANTS} lower to chunks "
                             f"{sorted(plans)}")
    return plans


def _kernel_share(profile, name: str):
    """Share of the profiled device time in kernels whose name holds
    ``name`` (from the profile's top rows)."""
    if not isinstance(profile.get("device_ms"), float):
        return "not measured"
    return sum(r["share"] for r in profile["top"] if name in r["name"])


def check_e2e_ssm(cfg, dev):
    """Full-width mamba2 cut to ``SSM_E2E["layers"]`` layers: the card
    with ssd_chunk against the CPU with its plain version, same weights
    and tokens.  ``make_prefill`` under the :func:`_ssm_plans` of a
    300-token prompt (a 256-token chunk and a 44-token tail segment: the
    plans' chunks do not divide 300, so each runs the architecture's
    256, as the reference does) and of a 512-token prompt (which each
    plan's chunk divides), then a prefill and two teacher-forced decode
    epochs of 4 steps; gated by :func:`_gate`, greedy tokens of the
    prefills equal.  Records, without gating, whether a chunked prefill
    (256 + 44, the state carried) equals the one-shot prefill bitwise on
    the card."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models.transformer import init_caches, prefill_chunk
    cfg = dataclasses.replace(cfg, num_layers=SSM_E2E["layers"])
    B, P = SSM_E2E["batch"], SSM_E2E["prompt_len"]
    plans = _ssm_plans(cfg)
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg.vocab_size, (B, P))
    forced = rng.integers(0, cfg.vocab_size, (B, 9))
    aligned = rng.integers(0, cfg.vocab_size, (B, 512))
    prefill = M.make_prefill(cfg)

    def run(params, device):
        pf = {}
        for name in (P, 512):
            toks = torch.from_numpy(prompt if name == P else aligned)
            toks = toks.long().to(device)
            for q, plan in plans.items():
                pf[(name, q)] = prefill(params, {"tokens": toks},
                                        plan).float().cpu()
        return pf, _e2e_run(cfg, params, device, prompt, forced, [None, None])

    params = M.init_params(cfg, seed=1, device=dev)
    _zero_counters()
    got_pf, got = run(params, dev)
    launches = _counters()["ssd_chunk"]
    if launches <= 0:
        raise AssertionError("e2e_ssm: ssd_chunk never launched")
    toks = torch.from_numpy(prompt).long().to(dev)
    last, states = {}, {}
    for name, cuts in (("one_shot", (P,)), ("chunked", (256, P))):
        caches = init_caches(params, cfg, B, P, device=dev)
        lo = 0
        for hi in cuts:
            logits, caches = prefill_chunk(params, toks[:, lo:hi], caches, lo,
                                           cfg)
            lo = hi
        last[name], states[name] = logits, caches
    chunked = {
        "cuts": [256, P - 256],
        "logits_bitwise": bool(torch.equal(last["one_shot"], last["chunked"])),
        "states_bitwise": all(
            torch.equal(a[k], b[k]) for a, b in zip(states["one_shot"],
                                                    states["chunked"])
            for k in ("conv", "ssm")),
        "max_abs_logit_diff": float(
            (last["one_shot"] - last["chunked"]).abs().max())}
    want_pf, want = run(_to(params, "cpu"), "cpu")
    del params
    V = cfg.vocab_size
    gates = {}
    for (n, q), got_q in got_pf.items():
        plan = plans[q]
        label = f"{n} tokens, {plan.pages}p/chunk{q}"
        gate = _gate(got_q[..., :V], want_pf[(n, q)][..., :V],
                     f"e2e_ssm prefill {label}")
        if gate["greedy_agreement"] != 1.0:
            raise AssertionError(f"e2e_ssm prefill {label}: {gate}")
        gates[label] = gate
    return {"arch": cfg.name, "layers": cfg.num_layers, "prompt_lens": [P, 512],
            "prefill": gates,
            "decode": _gate(got[..., :V], want[..., :V], "e2e_ssm decode"),
            "positions": int(got.shape[1]), "launches": launches,
            "chunked_vs_one_shot_on_card": chunked}


def _agreement(got, want):
    """Max |difference|, min cosine and greedy agreement of logits."""
    import torch
    return {"max_abs_err": float((got - want).abs().max()),
            "max_abs_logit": float(want.abs().max()),
            "min_cosine": float(torch.nn.functional.cosine_similarity(
                got, want, dim=-1).min()),
            "greedy_agreement": float((got.argmax(-1) == want.argmax(-1))
                                      .float().mean())}


def _plain_ssd_chunk(fn):
    """``fn()`` with ssd_chunk's plain version in place of the kernel (a
    control run: it launches no ssd_chunk)."""
    from repro_torch.kernels import ssd_scan as kssd
    kernel = kssd.ssd_chunk
    kssd.ssd_chunk = _ssd_plain
    try:
        return fn()
    finally:
        kssd.ssd_chunk = kernel


def prefill_ssm_main_path(cfg, dev, counters):
    """Slice 4's prefill path: ``make_prefill`` of full-width, full-depth
    mamba2 (bf16), 2 prompts of 1024 tokens from numpy, random weights
    from one seed, under the :func:`_ssm_plans` (SSD chunks 256, 128,
    64).  ``counters`` receives the launch counts of one pass of the
    three (zeroed just before, read just after).  Gates: finite logits;
    SSD is exact under any chunking, held on an fp32 copy of the same
    weights: the 128- and 64-chunk logits within :func:`_gate` of the
    256-chunk ones, greedy tokens equal.  In bf16 the three plans'
    agreement is held against a control: the 256-chunk plan with the
    plain version in place of the kernel, which sums in another order
    at the same chunk.  Over 48 random bf16 layers such differences grow
    to the size of the chunk-to-chunk ones, so the bar is relative: each
    plan's 1 - cosine within :data:`SSM_BF16_SPREAD` times the
    control's (at least :data:`SSM_BF16_FLOOR`), and the control's
    cosine at least
    :data:`SSM_BF16_COSINE`.  Then each plan is timed warm on the host
    clock, and the 256-chunk plan profiled once."""
    import torch
    from repro_torch.models import model as M
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    B, S = SSM_PREFILL["batch"], SSM_PREFILL["prompt_len"]
    V = cfg.vocab_size
    params = M.init_params(cfg, seed=2, device=dev)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, V, (B, S))).long().to(dev)
    plans = _ssm_plans(cfg)

    def call(plan, c=cfg, p=params):
        out = M.make_prefill(c)(p, {"tokens": toks}, plan)
        torch.cuda.synchronize()
        return out[:, :V].float()

    _zero_counters()
    logits, first_s = {}, {}
    for q, plan in plans.items():
        t0 = time.perf_counter()
        logits[q] = call(plan)
        first_s[q] = time.perf_counter() - t0
    counters.update(_counters())
    if counters["ssd_chunk"] <= 0:
        raise AssertionError(f"prefill_ssm: ssd_chunk never launched: "
                             f"{counters}")
    _gate_kinds(counters, "prefill_ssm", ssd=("wgmma",))
    bad = [q for q, lg in logits.items() if not bool(torch.isfinite(lg).all())]
    if bad:
        raise AssertionError(f"prefill_ssm: non-finite logits at chunks {bad}")
    want = logits[256]
    gates = {"bf16": {f"chunk{q}_vs_256": _agreement(logits[q], want)
                      for q in (128, 64)}}
    control = _agreement(_plain_ssd_chunk(lambda: call(plans[256])), want)
    gates["bf16"]["control_plain_vs_kernel_chunk256"] = control
    spread = max(SSM_BF16_SPREAD * (1.0 - control["min_cosine"]),
                 SSM_BF16_FLOOR)
    gates["bf16"]["limit_one_minus_cosine"] = spread
    if control["min_cosine"] < SSM_BF16_COSINE or any(
            1.0 - gates["bf16"][f"chunk{q}_vs_256"]["min_cosine"] > spread
            for q in (128, 64)):
        raise AssertionError(f"prefill_ssm bf16: {gates['bf16']}")
    c32 = dataclasses.replace(cfg, dtype="float32")
    p32 = _to_dtype(params, torch.float32)
    l32 = {q: call(plan, c32, p32) for q, plan in plans.items()}
    del p32
    for q in (128, 64):
        gates[f"fp32_chunk{q}_vs_256"] = {
            **_gate(l32[q], l32[256], f"prefill_ssm fp32 chunk {q} vs 256"),
            "min_cosine": _agreement(l32[q], l32[256])["min_cosine"]}
        if gates[f"fp32_chunk{q}_vs_256"]["greedy_agreement"] != 1.0:
            raise AssertionError(f"prefill_ssm fp32 chunk {q}: {gates}")
    runs = {}
    for q, plan in plans.items():
        t0 = time.perf_counter()
        call(plan)
        wall = time.perf_counter() - t0
        runs[f"chunk{q}"] = {"plan": plan.describe(), "pages": plan.pages,
                             "first_wall_s": first_s[q], "wall_s": wall,
                             "tokens_per_s": B * S / wall}
    peak = torch.cuda.max_memory_allocated()
    profile = _profile(lambda: call(plans[256]))
    profile["ssd_chunk_share"] = _kernel_share(profile, "ssd_chunk")
    return {"arch": cfg.name, "layers": cfg.num_layers, "batch": B,
            "prompt_len": S, "launches": dict(counters), "gates": gates,
            "runs": runs, "allocated_at_start_bytes": base,
            "peak_memory_bytes": peak, "profile": profile}


def _profile_ssm_prefill_chunk(cfg, params, dev, tokens: int = 256):
    """:func:`_profile` of one serving prefill chunk of ``tokens`` prompt
    tokens (batch of :data:`SERVE_SSM`) from a zero state."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models.transformer import init_caches
    B = SERVE_SSM["batch"]
    prompt = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (B, tokens))).long().to(dev)
    chunk = M.make_prefill_chunk(cfg)

    def run():
        chunk(params, init_caches(params, cfg, B, tokens, device=dev), prompt,
              0)
        torch.cuda.synchronize()

    out = {"tokens": tokens, **_profile(run)}
    out["ssd_chunk_share"] = _kernel_share(out, "ssd_chunk")
    return out


def serve_ssm_main_path(cfg, dev, counters):
    """Slice 4's serving path: ``MultiTenantServer(["mamba2-370m"],
    reduced=False)``, full depth, in the :data:`SERVE_SSM` pool: a
    resident decoding for every step, and two prompt tenants arriving at
    steps 4 and 8.  Their state reservations (``_kv_reserve_pages``) must
    fit the pool together and be held whole; the free pages the server
    saw at each admission are reported.  ``counters`` receives the
    kernels' launch counts of the run (zeroed just before, read just
    after); ssd_chunk must have launched.  Then one decode epoch of the
    resident and one 256-token prefill chunk are profiled."""
    import torch
    from repro_torch.launch.serve import MultiTenantServer, _kv_reserve_pages
    from repro_torch.sim.driver import TenantSpec
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    B, steps, budget = SERVE_SSM["batch"], SERVE_SSM["steps"], SERVE_SSM["budget"]
    pool = SERVE_SSM["pages"]
    quotes = [_kv_reserve_pages(cfg, B, p) for _, p in SERVE_SSM["arrivals"]]
    if sum(quotes) > pool:
        raise AssertionError(f"serve_ssm: reservations {quotes} exceed the "
                             f"{pool}-page pool")
    specs = [TenantSpec(cfg.name, arrive_at=at, prompt_len=p,
                        n_inferences=budget)
             for at, p in SERVE_SSM["arrivals"]]
    srv = MultiTenantServer([cfg.name], tenants=specs, batch=B,
                            max_len=SERVE_SSM["max_len"], total_pages=pool,
                            epoch_len=4, device=dev, reduced=False)
    seen_free = []
    choose = srv._choose_kv_dtype

    def spy_choose(c, spec):
        seen_free.append(srv.cache.free_pages)
        return choose(c, spec)

    srv._choose_kv_dtype = spy_choose
    _zero_counters()
    out = srv.run(steps=steps)
    counters.update(_counters())
    programs = _programs(srv, out)
    if counters["ssd_chunk"] <= 0:
        raise AssertionError(f"serve_ssm: ssd_chunk never launched: {counters}")
    _gate_kinds(counters, "serve_ssm", ssd=("wgmma",))
    resident = srv.tenants[0]
    vocab, tenants = cfg.vocab_size, {}
    for t, quote in zip(srv.tenants, [0] + quotes):
        res = out["tenants"][t.tid]
        o = res["output"]
        want_len = steps if t.prompt_len == 0 else 1 + budget
        problems = []
        if o.shape != (B, want_len) or o.min() < 0 or o.max() >= vocab:
            problems.append(f"output {o.shape} range [{o.min()}, {o.max()}]")
        if t.kv_dtype != "native":
            problems.append(f"kv_dtype {t.kv_dtype}")
        if not t.kv_wanted == t.kv_reserved == quote:
            problems.append(f"reservation {t.kv_reserved} of {t.kv_wanted}, "
                            f"quote {quote}")
        if problems:
            raise AssertionError(f"serve_ssm {t.tid}: {problems}")
        tenants[t.tid] = {
            "prompt_len": t.prompt_len, "tokens": res["tokens"],
            "ttft_s": res["ttft_s"], "kv_wanted": res["kv_wanted"],
            "kv_reserved": res["kv_reserved"],
            "prefill_chunks": res["prefill_chunks"],
            "plans": dict(Counter(f"{p.describe()}/chunk{p.ssm_chunk}"
                                  for p in t.plans)),
            "first_tokens": o[0, :8].tolist()}
    res = {"arch": cfg.name, "layers": cfg.num_layers, "total_pages": pool,
           "quotes": quotes, "free_at_admission": seen_free, "batch": B,
           "max_len": SERVE_SSM["max_len"], "steps": steps,
           "plan_kinds": sorted({p.kind for t in srv.tenants
                                 for p in t.plans}),
           "launches": dict(counters), "tokens_served": out["tokens_served"],
           "wall_s": out["wall_s"], "tokens_per_s": out["tokens_per_s"],
           "dram_total": out["dram_bytes"], "host": out["host"],
           "tenants": tenants, "allocated_at_start_bytes": base,
           "programs": programs,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    res["warm"] = _warm_runs(srv, steps)
    res["graph_pool_bytes"] = _graph_pool_bytes(srv)
    params = resident.params
    res["profile"] = {"decode_epoch": _profile_replay(srv, resident),
                      "prefill_chunk": _profile_ssm_prefill_chunk(cfg, params,
                                                                  dev)}
    return res


def check_serial_pipelined_ssm(cfg, dev, counters):
    """Serial (per-step) and pipelined (epoch) serving of full-width,
    full-depth mamba2 on the card, in the :data:`SELF_SSM` pool: two
    residents and a prompt tenant arriving mid-run, whose prompt chunks
    run ssd_chunk (the residents' O(1) decode steps are plain torch, as
    in the reference).  Bitwise-equal token streams, equal choice traces
    and prefill chunks.  ``counters`` receives the launch counts of the
    two runs (zeroed just before, read just after); ssd_chunk must have
    launched."""
    from repro_torch.launch.serve import MultiTenantServer
    from repro_torch.sim.driver import TenantSpec
    at, prompt_len = SELF_SSM["arrival"]
    spec = TenantSpec(cfg.name, arrive_at=at, prompt_len=prompt_len,
                      n_inferences=SELF_SSM["budget"])
    outs = []
    _zero_counters()
    for pipeline in (False, True):
        srv = MultiTenantServer([cfg.name, cfg.name], tenants=[spec],
                                batch=SELF_SSM["batch"],
                                max_len=SELF_SSM["max_len"],
                                total_pages=SERVE_SSM["pages"], epoch_len=4,
                                pipeline=pipeline, device=dev, reduced=False)
        outs.append((srv.run(steps=SELF_SSM["steps"]),
                     {t.tid: list(t.chunks) for t in srv.tenants}))
        del srv
    counters.update(_counters())
    if counters["ssd_chunk"] <= 0:
        raise AssertionError(f"self_ssm: ssd_chunk never launched: {counters}")
    _gate_kinds(counters, "self_ssm", ssd=("wgmma",))
    (serial, serial_chunks), (piped, piped_chunks) = outs
    if serial_chunks != piped_chunks:
        raise AssertionError(f"self_ssm: prefill chunks differ: "
                             f"{serial_chunks} vs {piped_chunks}")
    for tid, s in serial["tenants"].items():
        p = piped["tenants"][tid]
        if not np.array_equal(s["output"], p["output"]):
            raise AssertionError(f"self_ssm {tid}: serial and pipelined "
                                 "tokens differ")
        if s["choices"] != p["choices"]:
            raise AssertionError(f"self_ssm {tid}: choices differ")
    return {"arch": cfg.name, "layers": cfg.num_layers, **SELF_SSM,
            "bit_identical": True, "launches": dict(counters),
            "prefill_chunks": piped_chunks,
            "tokens": {tid: v["tokens"] for tid, v in piped["tenants"].items()},
            "first_tokens": {tid: v["output"][0, :8].tolist()
                             for tid, v in piped["tenants"].items()}}


# ---------------------------------------------------------------- moe --
def moe_prefill_plans(cfg, seq_block=None):
    """The MoE prefill settings, lowered at the experts' d_ff: plain, the
    smallest LBM grant that lowers fused at ``seq_block`` (default: the
    prefill's prompt length), and 32-page LWM grants with native and
    int8 KV."""
    from repro_torch.core.vmem import fused_ffn_pages
    s = seq_block or PREFILL["prompt_len"]
    lwm = PREFILL["lwm_pages"]
    lbm = fused_ffn_pages(s, cfg.d_model, cfg.d_ff, 2)
    return {"plain": None,
            "LBM/native": _plan(cfg, "LBM", lbm, s),
            "LWM/native": _plan(cfg, "LWM", lwm, s),
            "LWM/int8": _plan(cfg, "LWM", lwm, s, "int8")}


def check_e2e_moe(cfg, dev):
    """olmoe-1b-7b at full width cut to 4 layers, random weights from one
    seed: ``make_prefill`` of a 40-token prompt (16 bucket rows an
    expert) under an LBM plan, an LWM native plan and an LWM int8 plan,
    each expert's FFN through the plan's kernels, then a prefill and a
    teacher-forced decode epoch (the gathered-expert path), on the card
    against the same entry points on the CPU with the plain versions and
    the same weights.  Gate: :func:`_gate`; every bf16 kernel launch of
    the wgmma kind."""
    import torch
    from repro_torch.core.vmem import LANE
    from repro_torch.models import model as M
    e = MOE_E2E
    cfg = dataclasses.replace(cfg, num_layers=e["layers"])
    plans = {k: v for k, v in moe_prefill_plans(cfg, LANE).items()
             if v is not None}
    rng = np.random.default_rng(4)
    long_prompt = rng.integers(0, cfg.vocab_size, (e["batch"], e["prompt_len"]))
    prompt = rng.integers(0, cfg.vocab_size, (e["batch"], 8))
    forced = rng.integers(0, cfg.vocab_size, (e["batch"], 9))
    prefill = M.make_prefill(cfg)

    def run(params, device):
        toks = torch.from_numpy(long_prompt).long().to(device)
        pf = {name: prefill(params, {"tokens": toks}, p).float().cpu()
              for name, p in plans.items()}
        return pf, _e2e_run(cfg, params, device, prompt, forced,
                            [plans["LWM/native"]])

    params = M.init_params(cfg, seed=3, device=dev)
    _zero_counters()
    got_pf, got_dec = run(params, dev)
    launches = _counters()
    want_pf, want_dec = run(_to(params, "cpu"), "cpu")
    del params
    V = cfg.vocab_size
    if min(launches[k] for k in PREFILL_KERNELS) <= 0:
        raise AssertionError(f"e2e_moe: a kernel never launched: {launches}")
    _gate_kinds(launches, "e2e_moe", ("wgmma",), ("wgmma",), ("wgmma",),
                flash_quantized=("wgmma",))
    return {"layers": e["layers"], "prompt_len": e["prompt_len"],
            "plans": {n: p.describe() for n, p in plans.items()},
            "prefill": {n: _gate(got_pf[n][..., :V], want_pf[n][..., :V],
                                 f"e2e_moe prefill {n}") for n in plans},
            "decode": _gate(got_dec[..., :V], want_dec[..., :V],
                            "e2e_moe decode"),
            "launches": launches}


def check_serial_pipelined_moe(cfg, dev):
    """Serial (eager, per step) and pipelined (graphs) serving of two
    resident olmoe-1b-7b tenants at full width cut to 4 layers: token
    streams bitwise equal; the pipelined run decodes them as one
    bucket."""
    from repro_torch.launch.serve import MultiTenantServer
    from repro_torch.models.base import register
    m = SELF_MOE
    cut = register(dataclasses.replace(cfg, name=f"{cfg.name}-"
                                       f"{m['layers']}layer-self",
                                       num_layers=m["layers"]))
    outs, buckets = [], 0
    for pipeline in (False, True):
        srv = MultiTenantServer([cut.name, cut.name], batch=m["batch"],
                                max_len=m["max_len"], total_pages=m["pages"],
                                epoch_len=4, pipeline=pipeline, device=dev,
                                reduced=False)
        outs.append(srv.run(steps=m["steps"]))
        if pipeline:
            buckets = sum(1 for key in srv._fused_jits.keys()
                          if key[0] == "bucket")
        del srv
        _release()
    serial, piped = outs
    for tid, s_ in serial["tenants"].items():
        if not np.array_equal(s_["output"], piped["tenants"][tid]["output"]):
            raise AssertionError(f"self_moe {tid}: serial and pipelined "
                                 "tokens differ")
    if not buckets:
        raise AssertionError("self_moe: the residents never ran as a bucket")
    return {"arch": cfg.name, **m, "bucket_programs": buckets,
            "bit_identical": True,
            "tokens": {tid: v["tokens"] for tid, v in piped["tenants"].items()},
            "first_tokens": {tid: v["output"][0, :8].tolist()
                             for tid, v in piped["tenants"].items()}}


def serve_mix_main_path(dev, counters):
    """The reference CLI's default pool through the port's CLI, in this
    process: ``repro_torch.launch.serve.main`` with ``--full-width
    --archs yi-9b olmoe-1b-7b mamba2-370m --arrivals 2 --prompt-len
    256`` and a pool that holds each arch's native reservation of one
    prompt beside :data:`SERVE_MIX`'s headroom.  Its printed lines are
    kept.  ``counters`` receives the launch counts of the run (zeroed
    just before, read just after): yi-9b's decode runs cache_matmul's
    gemv tile and the mamba2 arrival's prompt chunks ssd_chunk."""
    import contextlib
    import io
    from repro_torch.launch import serve as S
    from repro_torch.models.base import get_arch
    m = SERVE_MIX
    pages = m["headroom"] + sum(
        S._kv_reserve_pages(get_arch(a), 2, m["prompt_len"])
        for a in m["archs"])
    argv = ["--full-width", "--device", dev, "--archs", *m["archs"],
            "--arrivals", str(m["arrivals"]), "--prompt-len",
            str(m["prompt_len"]), "--pages", str(pages)]
    buf = io.StringIO()
    _zero_counters()
    with contextlib.redirect_stdout(buf):
        out = S.main(argv)
    counters.update(_counters())
    if counters["cache_matmul"] <= 0 or counters["ssd_chunk"] <= 0:
        raise AssertionError(f"serve_mix: a kernel never launched: {counters}")
    _gate_kinds(counters, "serve_mix", ("gemv",), ssd=("wgmma",))
    tenants = {}
    for tid, res in out["tenants"].items():
        problems = []
        if res["tokens"] <= 0:
            problems.append("no tokens")
        if res["prompt_len"] and (res["ttft_s"] is None or res["kv_reserved"]
                                  != res["kv_wanted"]):
            problems.append(f"ttft {res['ttft_s']} reservation "
                            f"{res['kv_reserved']} of {res['kv_wanted']}")
        if problems:
            raise AssertionError(f"serve_mix {tid}: {problems}")
        tenants[tid] = {k: res[k] for k in (
            "tokens", "ttft_s", "prompt_len", "prefill_chunks", "kv_wanted",
            "kv_reserved", "lbm_frac", "choices", "plans")}
    return {"argv": argv, "pages": pages, "lines": buf.getvalue().splitlines(),
            "tokens_served": out["tokens_served"], "wall_s": out["wall_s"],
            "tokens_per_s": out["tokens_per_s"],
            "p95_ttft_s": out["p95_ttft_s"], "launches": dict(counters),
            "host": {k: out["host"][k] for k in (
                "epochs", "sched_wall_s", "device_wall_s", "captures",
                "capture_s", "epoch_compiles")},
            "tenants": tenants}


def _release():
    """Free what the last phase left before the next one starts: collect
    its reference cycles (a server and its tenants refer to each other),
    so that their device tensors go, then return the cached blocks."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    (OUT_DIR / "phases.jsonl").unlink(missing_ok=True)
    from repro_torch.models.base import get_arch
    cfg, ssm_cfg = get_arch("yi-9b"), get_arch(SSM_ARCH)
    moe_cfg = get_arch(MOE_ARCH)
    dev = "cuda"
    report = {}
    report["device"] = _phase("device", device_info)
    report["build"] = _phase("build", build_kernels)
    report["kernels"] = _phase("kernels", check_kernels, cfg, ssm_cfg,
                               moe_cfg, dev)
    if report["kernels"]["failed"]:
        raise AssertionError(f"kernels disagree: {report['kernels']['failed']}")
    _release()
    report["e2e"] = _phase("e2e", check_e2e, cfg, dev)
    _release()
    serve_counts, prefill_counts = {}, {}
    report["serve"] = _phase("serve", serve_main_path, cfg, dev, serve_counts)
    _release()
    report["self"] = _phase("self", check_serial_pipelined, cfg, dev)
    _release()
    report["graphs"] = _phase("graphs", check_graphs, cfg, ssm_cfg, dev,
                              moe_cfg=moe_cfg)
    _release()
    report["prefill"] = _phase("prefill", prefill_main_path, cfg, dev,
                               prefill_counts)
    _release()
    serve_kv_counts, ffn_quant_counts, found = {}, {}, {}
    report["serve_kv"] = _phase("serve_kv", serve_kv_main_path, cfg, dev,
                                serve_kv_counts, found)
    decode_plan = found["decode_plan"]
    _release()
    report["ffn_quant"] = _phase("ffn_quant", ffn_quant_main_path, cfg, dev,
                                 decode_plan, ffn_quant_counts)
    _release()
    report["e2e_ssm"] = _phase("e2e_ssm", check_e2e_ssm, ssm_cfg, dev)
    _release()
    prefill_ssm_counts, serve_ssm_counts = {}, {}
    report["prefill_ssm"] = _phase("prefill_ssm", prefill_ssm_main_path,
                                   ssm_cfg, dev, prefill_ssm_counts)
    _release()
    report["serve_ssm"] = _phase("serve_ssm", serve_ssm_main_path, ssm_cfg,
                                 dev, serve_ssm_counts)
    _release()
    report["self_ssm"] = _phase("self_ssm", check_serial_pipelined_ssm,
                                ssm_cfg, dev, {})
    _release()
    report["e2e_moe"] = _phase("e2e_moe", check_e2e_moe, moe_cfg, dev)
    _release()
    prefill_moe_counts, serve_moe_counts, serve_mix_counts = {}, {}, {}
    report["prefill_moe"] = _phase(
        "prefill_moe", prefill_main_path, moe_cfg, dev, prefill_moe_counts,
        label="prefill_moe", plans=moe_prefill_plans(moe_cfg),
        serve=("LWM/native",),
        profiled=("plain", "LBM/native", "LWM/native", "LWM/int8"))
    _release()
    report["serve_moe"] = _phase(
        "serve_moe", serve_main_path, moe_cfg, dev, serve_moe_counts,
        label="serve_moe", kernels=False, shares=(GATHER_KERNEL,),
        **SERVE_MOE)
    _release()
    report["self_moe"] = _phase("self_moe", check_serial_pipelined_moe,
                                moe_cfg, dev)
    _release()
    report["serve_mix"] = _phase("serve_mix", serve_mix_main_path, dev,
                                 serve_mix_counts)

    timings = report["kernels"]["timings"]
    csrc = "src/repro_torch/csrc/"
    source = {  # name: (source, TPU kernel replaced, timing, launches)
        "cache_matmul": (csrc + "cache_matmul.cu",
                         "src/repro/kernels/cache_matmul.py:99",
                         timings["cache_matmul.up"], serve_counts),
        "block_fused_ffn": (csrc + "block_fused_ffn.cu",
                            "src/repro/kernels/block_fused_ffn.py:54",
                            timings["block_fused_ffn.prefill"], prefill_counts),
        "flash_attention": (csrc + "flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:111",
                            timings["flash_attention"], prefill_counts),
        "flash_attention_quantized": (
            csrc + "flash_attention.cu",
            "src/repro/kernels/flash_attention.py:173",
            timings["flash_attention_quantized"], prefill_counts),
        "cache_matmul_quant": (
            csrc + "cache_matmul_quant.cu",
            "src/repro/kernels/cache_matmul.py:73",
            report["ffn_quant"]["timings"][
                f"int8 decode {decode_plan.describe()} m2 up"],
            ffn_quant_counts),
        "ssd_chunk": (csrc + "ssd_chunk.cu",
                      "src/repro/kernels/ssd_scan.py:62",
                      timings["ssd_chunk.prefill"], prefill_ssm_counts)}
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": counts[name], "max_abs_err": t["max_abs_err"],
                **{k: t[k] for k in keys},
                **{k: t[k] for k in ("kind", "simt_ms") if k in t}}
               for name, (src, rep, t, counts) in source.items()]
    # the matmuls' prefill GEMMs (wgmma, 2048 rows) beside their decode ones
    pf = timings["cache_matmul.prefill.up"]
    kernels[0]["prefill"] = {"launches": prefill_counts["cache_matmul"],
                             "max_abs_err": pf["max_abs_err"],
                             **{k: pf[k] for k in keys + ("kind", "simt_ms")}}
    # the quantized flash kernel under the fp8 plan beside the int8 one
    pf = timings["flash_attention_quantized.fp8_e4m3"]
    kernels[3]["fp8_e4m3"] = {"max_abs_err": pf["max_abs_err"],
                              **{k: pf[k] for k in keys + ("kind", "simt_ms")}}
    lwm_q = next(p for p in report["ffn_quant"]["plans"]
                 if p.startswith("prefill "))
    pf = report["ffn_quant"]["timings"][f"int8 {lwm_q} m2048 up"]
    kernels[4]["prefill"] = {
        "launches": ffn_quant_counts["cache_matmul_quant.wgmma"],
        "max_abs_err": pf["max_abs_err"],
        **{k: pf[k] for k in keys + ("kind", "simt_ms")}}
    # the expert GEMMs and the fused expert FFN of the MoE prefill, each
    # with the launches of the prefill_moe call that runs its shape
    moe_runs = report["prefill_moe"]["runs"]
    for i, label, run in ((0, "moe.up", "LWM/native"),
                          (0, "moe.down", "LWM/native"),
                          (0, "moe.serve.up", "serve/LWM/native"),
                          (0, "moe.serve.down", "serve/LWM/native"),
                          (1, "moe", "LBM/native")):
        kernel = kernels[i]["name"]
        pf = timings[f"{kernel}.{label}"]
        kernels[i][label] = {
            "launches": moe_runs[run]["launches"][f"{kernel}.wgmma"],
            "max_abs_err": pf["max_abs_err"],
            **{k: pf[k] for k in keys + ("kind",)}}
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(report["device"]["nvidia_smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
