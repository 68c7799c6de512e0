# Verbatim copy of src/repro/core/mapping.py (the JAX package's framework-free
# scheduling code); only the package name in imports differs.
"""Cache-aware mapping: the heuristic-solver-hybrid layer mapper.

Paper Section III-C(1): the mapper generates, for every layer, one
mapping candidate per cache-usage limit.  It (i) shrinks the search
space with heuristic rules — tile alignment to the PE array and cache
lines, double-buffered scratchpad utilization, and collapsing loop
permutations into four *residency classes* — then (ii) phrases each
residency class as a disjoint integer sub-problem minimizing DRAM
traffic under the cache budget, (iii) solves each subspace exactly
(bounded enumeration over aligned tile factors — the problems are small
enough that the exact solver replaces the paper's off-the-shelf ILP
solver), and keeps the minimum-DRAM result per usage limit.

DRAM-traffic model for one GEMM  C[M,N] += A[M,K] @ B[K,N]  (bytes,
element size ``eb``), tiles (Tm, Tn, Tk), ``r`` reps (``b_reused``
marks B identical across reps — LSTM/FC weights):

  STREAM   : A: r*M*K*ceil(N/Tn)     B: r*K*N*ceil(M/Tm)   C: r*M*N
  A_PANEL  : A: r*M*K                B: r*K*N*ceil(M/Tm)   C: r*M*N
  B_PANEL  : A: r*M*K                B: K*N (once, iff b_reused else r*K*N)
  BOTH     : compulsory traffic; A panel and B resident simultaneously

Residency panels live in the tenant's shared-cache region (page-
granular, via CPT); streamed tiles live in the NPU scratchpad (double
buffered) and move through NEC *bypass* semantics so they never pollute
the cache — this is where the architecture and the mapping co-design
meet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.mct import (MCT, CacheMapEntry, LoopTable, MappingCandidate,
                            ModelMapping, Residency)
from repro_torch.core.types import (GemmDims, LayerKind, LayerSpec, ModelGraph,
                              align_up, ceil_div)


@dataclasses.dataclass(frozen=True)
class MapperConfig:
    pe_dim: int = 32                     # systolic array edge -> tile alignment
    scratchpad_bytes: int = 256 * 2**10  # per-core private buffer
    page_bytes: int = 32 * 2**10
    line_bytes: int = 64
    # cache-usage limits the mapper targets (fractions of the NPU subspace)
    usage_fractions: Tuple[float, ...] = (0.0, 0.125, 0.25, 0.5, 1.0)
    npu_subspace_bytes: int = 12 * 2**20
    # throughput constants for t_est (per core)
    compute_flops: float = 2 * 32 * 32 * 1e9   # MACs/cycle * 2 * 1GHz
    dram_bps: float = 102.4e9 / 4              # fair per-stream share

    @property
    def usage_limits(self) -> Tuple[int, ...]:
        return tuple(int(f * self.npu_subspace_bytes) for f in self.usage_fractions)


def _pages(nbytes: int, page_bytes: int) -> int:
    return ceil_div(nbytes, page_bytes) if nbytes > 0 else 0


_FACTOR_CACHE: Dict[Tuple[int, int, int], List[int]] = {}


def _aligned_factors(dim: int, align: int, cap: int) -> List[int]:
    """Heuristic rule: tile factors are multiples of the PE edge, capped,
    deduplicated, always including the full dim if it fits the cap."""
    key = (dim, align, cap)
    hit = _FACTOR_CACHE.get(key)
    if hit is not None:
        return hit
    out = set()
    t = align
    while t < min(dim, cap):
        out.add(t)
        t *= 2
    out.add(min(align_up(dim, align), align_up(cap, align)) if dim > cap
            else align_up(dim, align))
    res = _FACTOR_CACHE[key] = sorted(out)
    return res


@dataclasses.dataclass(frozen=True)
class _GemmPlan:
    loop: LoopTable
    dram_bytes: int
    resident_bytes: int   # shared-cache footprint (pages come from this)
    stream_a: bool        # A moved via bypass
    stream_b: bool
    flops: int


# Exact-solver results are pure functions of (gemm, elem size, budget,
# config) — all hashable frozen dataclasses — and the same subspaces are
# re-solved constantly (every sim rebuilds every tenant's MCTs; MCT
# builds across tenants repeat identical layers), so both solver entry
# points are memoized process-wide.  Values are frozen plans/candidates,
# shared read-only by every caller.
_GEMM_PLAN_CACHE: Dict[Tuple[GemmDims, int, int, MapperConfig],
                       Optional["_GemmPlan"]] = {}
_LWM_CACHE: Dict[Tuple[LayerSpec, int, MapperConfig], MappingCandidate] = {}


def _plan_gemm(g: GemmDims, eb: int, budget: int, cfg: MapperConfig) -> Optional[_GemmPlan]:
    """Solve one GEMM's disjoint subspaces under ``budget`` bytes of
    shared cache; returns the min-DRAM plan or None if even STREAM fails
    (cannot happen: STREAM needs zero cache).  Memoized on
    ``(g, eb, budget, cfg)``."""
    key = (g, eb, budget, cfg)
    if key in _GEMM_PLAN_CACHE:
        return _GEMM_PLAN_CACHE[key]
    sp = cfg.scratchpad_bytes // 2   # double buffering halves usable space
    pe = cfg.pe_dim
    r = g.reps
    # enumerate with plain tuples — frozen-dataclass construction per
    # candidate dominates solve time otherwise; the single winning plan
    # is materialized once at the end
    best: Optional[Tuple] = None   # (dram, resident, order, tm, tn, tk,
    #                                residency, stream_a, stream_b)

    def consider(dram, resident, order, tm, tn, tk, res, sa, sb):
        nonlocal best
        if best is None or (dram, resident) < (best[0], best[1]):
            best = (dram, resident, order, tm, tn, tk, res, sa, sb)

    tks = _aligned_factors(g.K, pe, 4 * pe)
    # --- subspace STREAM: zero cache pages, scratchpad tiles only -------
    for tk in tks:
        for tm in _aligned_factors(g.M, pe, 16 * pe):
            # largest tn fitting scratchpad: (tm*tk + tk*tn + tm*tn)*eb <= sp
            rem = sp // eb - tm * tk
            if rem <= 0:
                continue
            tn = min(align_up(g.N, pe), (rem // (tk + tm)) // pe * pe)
            if tn < pe:
                continue
            a = r * g.a_bytes_one * ceil_div(g.N, tn)
            b = r * g.b_bytes_one * ceil_div(g.M, tm)
            c = r * g.c_bytes_one
            consider((a + b + c) * eb, 0, ("m", "n", "k"), tm, tn, tk,
                     Residency.STREAM, True, True)

    if budget > 0:
        # --- subspace A_PANEL: Tm x K panel cache-resident ---------------
        for tm in _aligned_factors(g.M, pe, 64 * pe):
            panel = tm * g.K * eb
            if panel > budget or panel == 0:
                continue
            tk = tks[-1]
            rem = sp // eb
            tn = min(align_up(g.N, pe), (rem // (tk + tm)) // pe * pe) if (tk + tm) else 0
            if tn < pe:
                continue
            a = r * g.a_bytes_one
            b = r * g.b_bytes_one * ceil_div(g.M, tm)
            c = r * g.c_bytes_one
            consider((a + b + c) * eb, panel, ("m", "n", "k"), tm, tn, tk,
                     Residency.A_PANEL, False, True)

        # --- subspace B_PANEL: whole B (weights) cache-resident ----------
        bbytes = g.b_bytes_one * eb
        if 0 < bbytes <= budget:
            tk = tks[-1]
            tm = pe
            rem = sp // eb - tm * tk
            tn = min(align_up(g.N, pe), max(pe, (rem // (tk + tm)) // pe * pe)) if rem > 0 else pe
            b = g.b_bytes_one * (1 if g.b_reused else r)
            a = r * g.a_bytes_one
            c = r * g.c_bytes_one
            consider((a + b + c) * eb, bbytes, ("n", "m", "k"), tm, tn, tk,
                     Residency.B_PANEL, True, False)

            # --- subspace BOTH: B + A-panel resident ----------------------
            for tm2 in _aligned_factors(g.M, pe, 64 * pe):
                panel = tm2 * g.K * eb
                if bbytes + panel > budget:
                    continue
                consider((a + b + c) * eb, bbytes + panel, ("n", "m", "k"),
                         tm2, tn, tk, Residency.BOTH, False, False)
                break  # first (smallest) feasible panel suffices: traffic equal

    plan = None
    if best is not None:
        dram, resident, order, tm, tn, tk, res, sa, sb = best
        plan = _GemmPlan(LoopTable(order, tm, tn, tk, res),
                         dram, resident, sa, sb, g.flops)
    _GEMM_PLAN_CACHE[key] = plan
    return plan


def map_layer_lwm(layer: LayerSpec, budget: int, cfg: MapperConfig) -> MappingCandidate:
    """One LWM candidate for ``layer`` under ``budget`` bytes of cache.
    Memoized on ``(layer, budget, cfg)``; the returned candidate is
    frozen and shared by every caller."""
    key = (layer, budget, cfg)
    if key in _LWM_CACHE:
        return _LWM_CACHE[key]
    eb = layer.elem_bytes
    if layer.kind == LayerKind.ELEMENTWISE or not layer.gemms:
        dram = layer.input_bytes + layer.output_bytes
        m = MappingCandidate(
            kind="LWM", p_need=0, dram_bytes=dram, flops=layer.flops,
            loops=(), cache_map=(
                CacheMapEntry("in", 0, 0, bypass=True),
                CacheMapEntry("out", 0, 0, bypass=True)),
            usage_limit_bytes=budget)
        _LWM_CACHE[key] = m
        return m

    plans: List[_GemmPlan] = []
    # split the budget greedily: biggest-B GEMM first claims residency
    remaining = budget
    order = sorted(range(len(layer.gemms)),
                   key=lambda i: -(layer.gemms[i].b_bytes_one * layer.gemms[i].reps))
    chosen: Dict[int, _GemmPlan] = {}
    for i in order:
        p = _plan_gemm(layer.gemms[i], eb, remaining, cfg)
        assert p is not None
        chosen[i] = p
        remaining -= p.resident_bytes
    plans = [chosen[i] for i in range(len(layer.gemms))]

    resident = sum(p.resident_bytes for p in plans)
    dram = sum(p.dram_bytes for p in plans)
    pages = _pages(resident, cfg.page_bytes)
    cmap: List[CacheMapEntry] = []
    vbase = 0
    for i, p in enumerate(plans):
        pg = _pages(p.resident_bytes, cfg.page_bytes)
        cmap.append(CacheMapEntry(f"g{i}.panel", vbase, pg, bypass=False))
        vbase += pg
        if p.stream_a:
            cmap.append(CacheMapEntry(f"g{i}.A", 0, 0, bypass=True))
        if p.stream_b:
            cmap.append(CacheMapEntry(f"g{i}.B", 0, 0, bypass=True))
    m = MappingCandidate(
        kind="LWM", p_need=pages, dram_bytes=dram, flops=layer.flops,
        loops=tuple(p.loop for p in plans), cache_map=tuple(cmap),
        usage_limit_bytes=budget)
    _LWM_CACHE[key] = m
    return m


def build_mct(layer: LayerSpec, cfg: MapperConfig,
              lbm: Optional[MappingCandidate] = None) -> MCT:
    """All LWM candidates (one per usage limit, deduplicated by footprint)
    plus the optional LBM candidate supplied by the block segmenter."""
    cands: List[MappingCandidate] = []
    seen = set()
    for lim in cfg.usage_limits:
        m = map_layer_lwm(layer, lim, cfg)
        key = (m.p_need, m.dram_bytes)
        if key not in seen:
            seen.add(key)
            cands.append(m)
    # dominance pruning (heuristic rule): drop candidates that use more
    # pages without reducing DRAM traffic
    cands.sort(key=lambda m: (m.p_need, m.dram_bytes))
    pruned: List[MappingCandidate] = []
    for m in cands:
        if not pruned or m.dram_bytes < pruned[-1].dram_bytes:
            pruned.append(m)
    return MCT(layer_name=layer.name, lwms=pruned, lbm=lbm)
