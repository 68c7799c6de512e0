#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printed as one JSON object with its seconds:

* ``device``: the card (``nvidia-smi`` name and power limit, SMs, shared
  memory per block, L2).
* ``build``: compiles the port's CUDA kernels from ``src/repro_torch/csrc``
  with ``nvcc`` for ``sm_90a``, one compiler per source, all at once.
* ``kernels``: holds each kernel against its plain PyTorch version on the
  card, in bf16 and fp32 (TF32 off), at full-width yi-9b decode shapes, a
  256-row prefill-sized shape and a ragged one, with tiles and blocks
  lowered from full-width plans under several grants; then times each at
  the serving path's decode shape.
* ``e2e``: full-width yi-9b cut to 4 layers, random weights from one
  seed: prefill, then two teacher-forced decode epochs (an LBM plan and an
  LWM plan) on the card with the kernels, against the same entry points
  on the CPU with the same weights.
* ``serve``: the main path.  ``MultiTenantServer`` serves two full-width,
  full-depth (48-layer) yi-9b tenants, one resident and one arriving with
  a 256-token prompt, for 32 steps under a page pool tight enough that the
  grants switch between LBM (block_fused_ffn) and LWM (cache_matmul).  The
  kernels' launch counters are zeroed just before the run and read just
  after it.  Then one decode epoch is profiled for where the time goes.
* ``self``: serial against pipelined serving on the card (full width,
  4 layers), token streams bitwise equal, under an LBM pool and an LWM
  pool.

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

SERVE_PAGES = 1800     # LBM (324 pages) fits before the arrival's KV
#                        reservation (1536 pages), not after it
SERVE_STEPS = 32
ARRIVAL = dict(arrive_at=8.0, prompt_len=256, n_inferences=16)
SELF_POOLS = ((1800, "LBM"), (64, "LWM"))   # serial vs pipelined pools


def _phase(name, fn, *args, **kwargs):
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    rec = {"phase": name, **out, "seconds": round(time.perf_counter() - t0, 3)}
    print(json.dumps(rec), flush=True)
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
                     "max_spill_store_bytes": max(spills, default=None)}
    return {"nvcc": build.nvcc(), "sources": out}


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
        for label, m, k, n, tile in mm:
            a = _randn(gen, (m, k), dtype)
            b = _randn(gen, (k, n), dtype, 1 / math.sqrt(k))
            got = ops.planned_matmul(a, b, tile)
            err, ok = _close(got, kmm.cache_matmul_plain(a, b), dn)
            hop = ops.legalize_matmul_tile(tile, m, limit)
            rows.append({"kernel": "cache_matmul", "case": label, "dtype": dn,
                         "shape": [m, k, n],
                         "plan_tile": [tile.bm, tile.bn, tile.bk],
                         "hopper_tile": [hop.bm, hop.bn, hop.bk],
                         "max_abs_err": err, "tol": TOL[dn], "ok": ok})
        ffn = []
        # the smallest LBM grant, and two that widen block_f
        for pages in (fused_ffn_pages(LANE, d, f, eb), 300 * eb, 600 * eb):
            plan = lower_ffn(LANE, d, f, eb, pages, want_fused=True)
            for s in (2, 256):
                ffn.append((f"lbm@{pages}p", s, d, f, plan))
        ffn.append(("ragged", 37, 333, 1000,
                    lower_ffn(LANE, 333, 1000, eb, 4096, want_fused=True)))
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
                                        limit)
            rows.append({"kernel": "block_fused_ffn", "case": label,
                         "dtype": dn, "shape": [s, dd, ff],
                         "plan_block": [plan.block_s, plan.block_f],
                         "hopper_tile": [hop.bs, hop.bf, hop.bk],
                         "max_abs_err": err, "tol": TOL[dn], "ok": ok})
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


def _bound(nbytes: int, flops: int, dtype_name: str):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(tb, tf), ("bytes" if tb >= tf else "operations")


def kernel_timings(cfg, dev, batch: int, lwm_pages: int, lbm_pages: int):
    """Kernel, plain and library times at the serving path's decode
    shapes (bf16, M = batch rows), with the tiles the serve's plans
    lower to."""
    import torch
    from repro_torch.core.plan import lower_ffn
    from repro_torch.core.vmem import LANE
    from repro_torch.kernels import block_fused_ffn as kffn
    from repro_torch.kernels import cache_matmul as kmm
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
        hop = ops.legalize_matmul_tile(tile, a.shape[0], limit)
        m, k = a.shape
        n = b.shape[1]
        bound, by = _bound(eb * (m * k + k * n + m * n), 2 * m * k * n, dn)
        err, ok = _close(kmm.cache_matmul(a, b, hop), kmm.cache_matmul_plain(a, b), dn)
        out[f"cache_matmul.{label}"] = {
            "shape": [m, k, n], "hopper_tile": [hop.bm, hop.bn, hop.bk],
            "ms": _median_ms(lambda: kmm.cache_matmul(a, b, hop)),
            "plain_ms": _median_ms(lambda: kmm.cache_matmul_plain(a, b)),
            "library_ms": _median_ms(lambda: torch.matmul(a, b)),
            "bound_ms": bound, "bound_by": by, "max_abs_err": err, "ok": ok}
    hop = ops.legalize_ffn_tile(lbm.block_s, lbm.block_f, batch, limit)
    bound, by = _bound(eb * (2 * batch * d + 3 * d * f), 6 * batch * d * f, dn)
    err, ok = _close(kffn.block_fused_ffn(x, wg, wu, wd, hop),
                     kffn.block_fused_ffn_plain(x, wg, wu, wd), dn)
    out["block_fused_ffn"] = {
        "shape": [batch, d, f], "plan_block": [lbm.block_s, lbm.block_f],
        "hopper_tile": [hop.bs, hop.bf, hop.bk],
        "ms": _median_ms(lambda: kffn.block_fused_ffn(x, wg, wu, wd, hop)),
        "plain_ms": _median_ms(lambda: kffn.block_fused_ffn_plain(x, wg, wu, wd)),
        "library_ms": None, "bound_ms": bound, "bound_by": by,
        "partial_bytes": kffn.partial_bytes(hop, batch, d, f),
        "max_abs_err": err, "ok": ok}
    return out


def check_kernels(cfg, dev):
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = kernel_cases(cfg, dev)
    bad = [r for r in rows if not r["ok"]]
    timings = kernel_timings(cfg, dev, batch=2, lwm_pages=32, lbm_pages=324)
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


class _Forced:
    """Teacher forcing for decode_epoch: records each step's logits and
    feeds the next preset token instead of the greedy one."""

    def __init__(self, tokens):
        self.tokens, self.i, self.logits = tokens, 0, []

    def __call__(self, logits):
        self.logits.append(logits[:, -1].float())
        self.i += 1
        return self.tokens[:, self.i]


def _e2e_run(cfg, params, dev, prompt, forced, plans):
    import torch
    from repro_torch.models.transformer import (decode_epoch, init_caches,
                                                prefill_chunk)
    caches = init_caches(params, cfg, prompt.shape[0], 64, device=dev)
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


def check_e2e(cfg, dev, layers: int = 4, lbm_pages: int = 324,
              lwm_pages: int = 32):
    """The card with kernels against the CPU with the plain versions,
    same weights and tokens.  Tolerance (bf16 activations rounded at
    different points over 4 layers): max |logit difference| <= 2e-2 of the
    largest reference logit; a greedy token may differ only where the
    reference's own margin is within twice that."""
    import torch
    from repro_torch.core.plan import KernelPlan, lower_ffn
    from repro_torch.core.vmem import LANE
    from repro_torch.kernels import block_fused_ffn as kffn
    from repro_torch.kernels import cache_matmul as kmm
    from repro_torch.models import model as M
    cfg = dataclasses.replace(cfg, num_layers=layers)
    eb = torch.tensor([], dtype=cfg.torch_dtype).element_size()
    plans = [KernelPlan("LBM", lbm_pages, lower_ffn(LANE, cfg.d_model, cfg.d_ff,
                                                    eb, lbm_pages, True)),
             KernelPlan("LWM", lwm_pages, lower_ffn(LANE, cfg.d_model, cfg.d_ff,
                                                    eb, lwm_pages, False))]
    if [p.ffn.fused for p in plans] != [True, False]:
        raise AssertionError(f"e2e plans {plans} are not LBM then LWM")
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, (2, 8))
    forced = rng.integers(0, cfg.vocab_size, (2, 9))
    params = M.init_params(cfg, seed=1, device=dev)
    l0 = (kmm.launches, kffn.launches)
    got = _e2e_run(cfg, params, dev, prompt, forced, plans)
    launches = {"cache_matmul": kmm.launches - l0[0],
                "block_fused_ffn": kffn.launches - l0[1]}
    want = _e2e_run(cfg, _to(params, "cpu"), "cpu", prompt, forced, plans)
    del params
    got, want = got[..., :cfg.vocab_size], want[..., :cfg.vocab_size]
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    tol = 2e-2 * scale
    g_arg, w_arg = got.argmax(-1), want.argmax(-1)
    margin = want.max(-1).values - want.gather(-1, g_arg[..., None])[..., 0]
    agree = float((g_arg == w_arg).float().mean())
    bad_tokens = int(((g_arg != w_arg) & (margin > 2 * tol)).sum())
    ok = (bool(torch.isfinite(got).all()) and err <= tol and bad_tokens == 0
          and all(v > 0 for v in launches.values()))
    if not ok:
        raise AssertionError(f"e2e: err {err} tol {tol} agree {agree} "
                             f"bad_tokens {bad_tokens} launches {launches}")
    return {"layers": layers, "positions": int(got.shape[1]),
            "max_abs_err": err, "max_abs_logit": scale, "tol": tol,
            "greedy_agreement": agree, "launches": launches,
            "plans": [p.describe() for p in plans]}


# -------------------------------------------------------------- serve --
def _profile_epoch(srv, t, plan, k: int = 4):
    """Device time by kernel over one decode epoch of tenant ``t`` (its
    caches and params as the run left them), plus the same epoch timed on
    the host clock without the profiler for the device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    epoch = srv._epoch_cores[t.cfg.name]

    def run():
        kv = srv._kv_len(t.index + k)
        toks, t.caches = epoch(t.params, t.caches, t.token, t.index, plan=plan,
                               k=k, kv_len=kv)
        t.token = toks[:, -1:]
        t.index += k
        torch.cuda.synchronize()

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

    rows = [(e.key, dev_us(e), e.count) for e in prof.key_averages()]
    rows = [r for r in rows if r[1] > 0]
    total_us = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    top = [{"name": n[:80], "device_ms": us / 1e3, "calls": c,
            "share": us / total_us} for n, us, c in rows[:12]]
    return {"plan": plan.describe(), "steps": k, "wall_ms": wall_ms,
            "device_ms": total_us / 1e3 if total_us else "not measured",
            "idle_share": (1 - total_us / 1e3 / wall_ms) if total_us else
            "not measured", "top": top}


def serve_main_path(dev, counters):
    """Two full-width, full-depth yi-9b tenants through the port's
    MultiTenantServer.  ``counters`` receives the kernels' launch counts
    of this run: zeroed just before ``run``, read just after."""
    import torch
    from repro_torch.kernels import block_fused_ffn as kffn
    from repro_torch.kernels import cache_matmul as kmm
    from repro_torch.launch.serve import MultiTenantServer
    from repro_torch.sim.driver import TenantSpec
    torch.cuda.reset_peak_memory_stats()
    srv = MultiTenantServer(["yi-9b"], tenants=[TenantSpec("yi-9b", **ARRIVAL)],
                            batch=2, max_len=512, total_pages=SERVE_PAGES,
                            epoch_len=4, device=dev, reduced=False)
    kmm.launches = 0
    kffn.launches = 0
    out = srv.run(steps=SERVE_STEPS)
    counters.update({"cache_matmul": kmm.launches,
                     "block_fused_ffn": kffn.launches})
    if min(counters.values()) <= 0:
        raise AssertionError(f"serve: a kernel never launched: {counters}")
    vocab = srv.tenants[0].cfg.vocab_size
    tenants = {}
    for t in srv.tenants:
        res = out["tenants"][t.tid]
        o = res["output"]
        want = SERVE_STEPS if t.prompt_len == 0 else 1 + ARRIVAL["n_inferences"]
        if o.shape != (2, want) or o.min() < 0 or o.max() >= vocab:
            raise AssertionError(f"{t.tid}: output {o.shape} range "
                                 f"[{o.min()}, {o.max()}], want (2, {want})")
        plans = Counter(p.describe() for p in t.plans)
        tenants[t.tid] = {"tokens": res["tokens"], "ttft_s": res["ttft_s"],
                          "kv_wanted": res["kv_wanted"],
                          "kv_reserved": res["kv_reserved"],
                          "prefill_chunks": res["prefill_chunks"],
                          "lbm_frac": res["lbm_frac"], "plans": dict(plans),
                          "first_tokens": o[0, :8].tolist()}
    kinds = {p.kind for t in srv.tenants for p in t.plans}
    if kinds != {"LBM", "LWM"}:
        raise AssertionError(f"serve: plan kinds {kinds}, want LBM and LWM")
    res = {"arch": "yi-9b", "layers": srv.tenants[0].cfg.num_layers,
           "total_pages": SERVE_PAGES, "batch": 2, "max_len": 512,
           "steps": SERVE_STEPS, "launches": dict(counters),
           "tokens_served": out["tokens_served"], "wall_s": out["wall_s"],
           "tokens_per_s": out["tokens_per_s"], "dram_total": out["dram_bytes"],
           "host": out["host"], "tenants": tenants,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    resident = srv.tenants[0]
    plan_of = {p.kind: p for p in resident.plans}
    res["profile"] = [_profile_epoch(srv, resident, plan_of[k])
                      for k in ("LWM", "LBM")]
    return res


# --------------------------------------------------------------- self --
def check_serial_pipelined(cfg, dev, layers: int = 4):
    """Serial (per-step) and pipelined (epoch) serving of two resident
    full-width tenants: bitwise-equal token streams and equal choice
    traces, under a pool that grants LBM and one that grants LWM."""
    from repro_torch.launch.serve import MultiTenantServer
    from repro_torch.models.base import register
    arch = register(dataclasses.replace(cfg, name=f"{cfg.name}-{layers}layer",
                                        num_layers=layers))
    res = {}
    for pages, kind in SELF_POOLS:
        outs = []
        for pipeline in (False, True):
            srv = MultiTenantServer([arch.name, arch.name], batch=2, max_len=64,
                                    total_pages=pages, epoch_len=4,
                                    pipeline=pipeline, device=dev, reduced=False)
            outs.append(srv.run(steps=12))
            got = {p.kind for t in srv.tenants for p in t.plans}
            if got != {kind}:
                raise AssertionError(f"self@{pages}p: plans {got}, want {kind}")
            del srv
        for tid, s in outs[0]["tenants"].items():
            p = outs[1]["tenants"][tid]
            if not np.array_equal(s["output"], p["output"]):
                raise AssertionError(f"self@{pages}p {tid}: serial and "
                                     "pipelined tokens differ")
            if s["choices"] != p["choices"]:
                raise AssertionError(f"self@{pages}p {tid}: choices differ")
        res[kind] = {"pages": pages, "tokens": {
            tid: v["tokens"] for tid, v in outs[1]["tenants"].items()},
            "bit_identical": True}
    return {"layers": layers, **res}


# --------------------------------------------------------------- main --
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
    from repro_torch.models.base import get_arch
    cfg = get_arch("yi-9b")
    dev = "cuda"
    report = {}
    report["device"] = _phase("device", device_info)
    report["build"] = _phase("build", build_kernels)
    report["kernels"] = _phase("kernels", check_kernels, cfg, dev)
    if report["kernels"]["failed"]:
        raise AssertionError(f"kernels disagree: {report['kernels']['failed']}")
    torch.cuda.empty_cache()
    report["e2e"] = _phase("e2e", check_e2e, cfg, dev)
    torch.cuda.empty_cache()
    counters = {}
    report["serve"] = _phase("serve", serve_main_path, dev, counters)
    torch.cuda.empty_cache()
    report["self"] = _phase("self", check_serial_pipelined, cfg, dev)

    timings = report["kernels"]["timings"]
    source = {"cache_matmul": ("src/repro_torch/csrc/cache_matmul.cu",
                               "src/repro/kernels/cache_matmul.py:99",
                               timings["cache_matmul.up"]),
              "block_fused_ffn": ("src/repro_torch/csrc/block_fused_ffn.cu",
                                  "src/repro/kernels/block_fused_ffn.py:54",
                                  timings["block_fused_ffn"])}
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": counters[name], "max_abs_err": t["max_abs_err"],
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"]}
               for name, (src, rep, t) in source.items()]
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
