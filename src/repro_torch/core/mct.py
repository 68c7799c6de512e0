# Verbatim copy of src/repro/core/mct.py (the JAX package's framework-free
# scheduling code); only the package name in imports differs.
"""Mapping candidate tables (MCT), paper Section III-C(3).

An MCT is the per-layer output of the offline mapping phase.  Instead of
unrolled NPU instruction streams it stores each candidate compactly as

  * a *loop table*: loop permutation + tile factors (Tm, Tn, Tk) and the
    residency class (which operand panels stay cache-resident), and
  * a *cache map table*: tensor name -> (vcpn base, page count) placement
    inside the tenant's virtual cache address space.

The dynamic allocator (Algorithm 1) consumes only the summary fields
(``p_need``, ``dram_bytes``, ``t_est``); the NPU program generator and
the TPU bridge (core/vmem.py) consume the loop/cache tables.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Tuple

import numpy as np


class Residency(enum.Enum):
    """Which operand stays resident in the shared-cache region across the
    tile loop (the 'disjoint problem subspaces' of the hybrid mapper)."""
    STREAM = "stream"      # nothing resident beyond double buffers (min pages)
    A_PANEL = "a_panel"    # A row-panel (Tm x K) resident; B streamed once
    B_PANEL = "b_panel"    # B (K x N) fully resident; A streamed once
    BOTH = "both"          # A panel + B resident (largest budget)


@dataclasses.dataclass(frozen=True)
class LoopTable:
    permutation: Tuple[str, ...]      # e.g. ("n", "m", "k")
    tm: int
    tn: int
    tk: int
    residency: Residency


@dataclasses.dataclass(frozen=True)
class CacheMapEntry:
    tensor: str
    base_vcpn: int
    pages: int
    bypass: bool = False  # True => streamed around the cache (NEC bypass)


@dataclasses.dataclass(frozen=True)
class MappingCandidate:
    """One mapping of one layer under one cache-usage limit."""
    kind: str                      # "LWM" or "LBM"
    p_need: int                    # shared-cache pages required
    dram_bytes: int                # predicted DRAM traffic for the layer
    flops: int
    loops: Tuple[LoopTable, ...]   # one per GEMM in the layer
    cache_map: Tuple[CacheMapEntry, ...]
    usage_limit_bytes: int         # the budget this candidate was solved for

    def t_est(self, compute_bps: float, dram_bps: float) -> float:
        """Profiling-style latency estimate (seconds): roofline max of
        compute and memory time — multi-tenant DNNs are memory bound, so
        DRAM time usually dominates (paper II-C)."""
        ct = self.flops / compute_bps if compute_bps else 0.0
        mt = self.dram_bytes / dram_bps if dram_bps else 0.0
        return max(ct, mt)


@dataclasses.dataclass
class MCT:
    """All candidates for one layer: several LWMs (ascending p_need) and
    at most one LBM."""
    layer_name: str
    lwms: List[MappingCandidate]
    lbm: Optional[MappingCandidate] = None

    def __post_init__(self):
        self.lwms.sort(key=lambda m: (m.p_need, m.dram_bytes))
        for m in self.lwms:
            if m.kind != "LWM":
                raise ValueError("lwms must contain LWM candidates")
        if self.lbm is not None and self.lbm.kind != "LBM":
            raise ValueError("lbm must be an LBM candidate")

    @property
    def min_pages(self) -> int:
        return self.lwms[0].p_need

    def best_fit(self, pages_avail: int) -> MappingCandidate:
        """Largest-footprint LWM with p_need <= pages_avail (Algorithm 1
        lines 18-21); falls back to the smallest candidate."""
        best = self.lwms[0]
        for m in self.lwms:
            if best.p_need < m.p_need <= pages_avail:
                best = m
        return best

    def _fit_tables(self) -> Tuple[np.ndarray, np.ndarray]:
        """Sorted p_need array + first-occurrence map for vectorized
        best-fit.  ``lwms`` is sorted by (p_need, dram_bytes), so the first
        occurrence of a tied p_need is exactly the candidate the scalar
        ``best_fit`` loop keeps (strict ``<`` skips later ties)."""
        tables = getattr(self, "_fit_cache", None)
        if tables is None:
            p = np.array([m.p_need for m in self.lwms], dtype=np.int64)
            first = np.zeros(len(p), dtype=np.int64)
            for i in range(1, len(p)):
                first[i] = first[i - 1] if p[i] == p[i - 1] else i
            tables = (p, first)
            self._fit_cache = tables
        return tables

    def best_fit_batch(self, pages_avail: np.ndarray) -> List[MappingCandidate]:
        """Vectorized ``best_fit`` over an array of page budgets."""
        p, first = self._fit_tables()
        idx = np.searchsorted(p, pages_avail, side="right") - 1
        idx = np.maximum(idx, 0)
        return [self.lwms[int(first[i])] for i in idx]

    def next_smaller(self, current: MappingCandidate) -> MappingCandidate:
        """On timeout, downgrade to the candidate with the next smaller
        footprint (paper III-D: 'updates the candidate to the one that
        requires fewer pages')."""
        smaller = [m for m in self.lwms if m.p_need < current.p_need]
        return smaller[-1] if smaller else self.lwms[0]


@dataclasses.dataclass
class ModelMapping:
    """'Model mapping file': the MCTs of every layer plus the layer-block
    segmentation used by LBM (paper Fig. 6)."""
    model_name: str
    mcts: List[MCT]
    blocks: List[Tuple[int, int]]  # [start, end) layer index ranges

    def __post_init__(self):
        # layer -> block index and block-head set, precomputed: both are
        # queried on every layer selection of every inference
        self._block_of: Dict[int, Tuple[int, int]] = {}
        self._heads = set()
        for b in self.blocks:
            self._heads.add(b[0])
            for i in range(b[0], b[1]):
                self._block_of[i] = b

    def block_of(self, layer_idx: int) -> Tuple[int, int]:
        b = self._block_of.get(layer_idx)
        if b is None:
            raise IndexError(f"layer {layer_idx} not covered by any block")
        return b

    def is_head_of_block(self, layer_idx: int) -> bool:
        return layer_idx in self._heads
