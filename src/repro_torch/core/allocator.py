# Verbatim copy of src/repro/core/allocator.py (the JAX package's framework-free
# scheduling code); only the package name in imports differs.
"""Dynamic cache allocation — Algorithm 1 of the paper, line-faithful.

Invoked at the beginning of every layer.  Predicts near-future available
pages from per-task profiles (T_next, P_next, P_alloc — updated at the
end of each layer), prefers enabling LBM for a block when its footprint
fits the prediction, otherwise best-fit LWM selection; emits a timeout
threshold ``T_ahead`` used by the runtime's page-request loop.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cache import SharedCache
from repro_torch.core.mct import MCT, MappingCandidate, ModelMapping

INF = math.inf
AHEAD_FRACTION = 0.2  # Algorithm 1 lines 11/16: T_ahead = T_cur + 0.2 * T_est


@dataclasses.dataclass
class TaskProfile:
    """Per-task allocator state (the paper's global Data arrays)."""
    t_next: float = 0.0    # predicted next reallocation time
    p_next: int = 0        # predicted pages needed at next reallocation
    p_alloc: int = 0       # pages currently allocated


@dataclasses.dataclass
class Selection:
    candidate: MappingCandidate
    p_cur: int
    t_ahead: float


class DynamicCacheAllocator:
    """Algorithm 1 + the end-of-layer profile updates it relies on."""

    def __init__(self, cache: SharedCache):
        self.cache = cache
        self.profiles: Dict[str, TaskProfile] = {}
        self._lbm_enabled: Dict[str, bool] = {}   # task -> LBM active for current block

    # -- task lifecycle --------------------------------------------------
    def register_task(self, task: str) -> None:
        self.profiles[task] = TaskProfile()
        self._lbm_enabled[task] = False

    def remove_task(self, task: str) -> None:
        self.profiles.pop(task, None)
        self._lbm_enabled.pop(task, None)

    def has_enabled_lbm(self, task: str) -> bool:
        return self._lbm_enabled.get(task, False)

    def set_lbm(self, task: str, on: bool) -> None:
        self._lbm_enabled[task] = on

    # -- Algorithm 1, lines 1-6 -------------------------------------------
    def pred_avail_pages(self, t_ahead: float, t_cur: str) -> int:
        p_ahead = self.cache.free_pages  # idlePages()
        for task, prof in self.profiles.items():
            if task != t_cur and prof.t_next < t_ahead:
                p_ahead += prof.p_alloc - prof.p_next
        return p_ahead

    # -- Algorithm 1, lines 7-22 -------------------------------------------
    def select(self, task: str, mct: MCT, now: float,
               layer_t_est: float, block_t_est: float,
               is_head_of_block: bool) -> Selection:
        # lines 7-9: LBM already enabled for this block
        if self.has_enabled_lbm(task) and mct.lbm is not None:
            m = mct.lbm
            return Selection(m, m.p_need, INF)
        # lines 10-15: head of block — try to enable LBM
        if is_head_of_block and mct.lbm is not None:
            t_ahead = now + block_t_est * AHEAD_FRACTION
            p_ahead = self.pred_avail_pages(t_ahead, task)
            if mct.lbm.p_need < p_ahead:
                return Selection(mct.lbm, mct.lbm.p_need, t_ahead)
        # lines 16-22: best-fit LWM
        t_ahead = now + layer_t_est * AHEAD_FRACTION
        p_ahead = self.pred_avail_pages(t_ahead, task)
        m = mct.best_fit(p_ahead)
        return Selection(m, m.p_need, t_ahead)

    # -- batched Algorithm 1 ------------------------------------------------
    def profile_arrays(self) -> Tuple[List[str], np.ndarray, np.ndarray]:
        """Snapshot the profile table as (names, t_next, p_alloc - p_next)
        arrays — the Data arrays of Algorithm 1, columnar."""
        names = list(self.profiles.keys())
        t_next = np.array([self.profiles[n].t_next for n in names],
                          dtype=np.float64)
        delta = np.array([self.profiles[n].p_alloc - self.profiles[n].p_next
                          for n in names], dtype=np.int64)
        return names, t_next, delta

    def quiescent(self) -> bool:
        """True when no registered profile predicts a pending reallocation
        delta (p_alloc == p_next everywhere).  Under quiescence
        ``pred_avail_pages`` degenerates to ``cache.free_pages`` for every
        horizon, which is what makes epoch planning batchable."""
        return all(p.p_alloc == p.p_next for p in self.profiles.values())

    def pred_avail_pages_batch(self, t_aheads: np.ndarray,
                               tasks: Sequence[str]) -> np.ndarray:
        """Vectorized Algorithm 1 lines 1-6: predicted available pages for
        a batch of (task, t_ahead) queries in one pass over the profile
        arrays.  Integer contributions sum exactly, so this is bit-identical
        to the scalar loop regardless of summation order."""
        names, t_next, delta = self.profile_arrays()
        free = self.cache.free_pages
        if not names:
            return np.full(len(t_aheads), free, dtype=np.int64)
        mask = t_next[None, :] < np.asarray(t_aheads, np.float64)[:, None]
        contrib = (mask * delta[None, :]).sum(axis=1)
        index = {n: i for i, n in enumerate(names)}
        for b, task in enumerate(tasks):
            j = index.get(task)
            if j is not None and mask[b, j]:
                contrib[b] -= delta[j]
        return free + contrib

    def select_batch(self, tasks: Sequence[str], mcts: Sequence[MCT],
                     now: float, layer_t_ests: Sequence[float],
                     block_t_ests: Sequence[float],
                     is_heads: Sequence[bool],
                     lbm_enabled: Optional[Sequence[bool]] = None
                     ) -> List[Selection]:
        """Batched Algorithm 1 lines 7-22: one numpy pass over the profile
        arrays for every tenant's candidate grant.  Pure (no state
        mutation), and bit-identical to per-task ``select`` calls — the
        float expressions keep the exact scalar evaluation order
        (``now + t_est * AHEAD_FRACTION``) and page sums are integer.

        ``lbm_enabled`` overrides the live per-task LBM flags — the epoch
        planner simulates later layers of a block before committing the
        first, tracking would-be flags analytically."""
        t_ahead_blk = now + np.asarray(block_t_ests, np.float64) * AHEAD_FRACTION
        t_ahead_lyr = now + np.asarray(layer_t_ests, np.float64) * AHEAD_FRACTION
        p_ahead_blk = self.pred_avail_pages_batch(t_ahead_blk, tasks)
        p_ahead_lyr = self.pred_avail_pages_batch(t_ahead_lyr, tasks)

        # Vectorized best-fit, grouped by shared MCT object (tenants of the
        # same arch share memoized MCTs, so the searchsorted runs once per
        # distinct table, not per tenant).
        fits: List[Optional[MappingCandidate]] = [None] * len(tasks)
        groups: Dict[int, List[int]] = {}
        for i, mct in enumerate(mcts):
            groups.setdefault(id(mct), []).append(i)
        for idxs in groups.values():
            mct = mcts[idxs[0]]
            for i, m in zip(idxs, mct.best_fit_batch(p_ahead_lyr[idxs])):
                fits[i] = m

        out: List[Selection] = []
        for i, (task, mct) in enumerate(zip(tasks, mcts)):
            enabled = (self.has_enabled_lbm(task) if lbm_enabled is None
                       else lbm_enabled[i])
            # lines 7-9: LBM already enabled for this block
            if enabled and mct.lbm is not None:
                out.append(Selection(mct.lbm, mct.lbm.p_need, INF))
                continue
            # lines 10-15: head of block — try to enable LBM
            if (is_heads[i] and mct.lbm is not None
                    and mct.lbm.p_need < int(p_ahead_blk[i])):
                out.append(Selection(mct.lbm, mct.lbm.p_need,
                                     float(t_ahead_blk[i])))
                continue
            # lines 16-22: best-fit LWM
            m = fits[i]
            out.append(Selection(m, m.p_need, float(t_ahead_lyr[i])))
        return out

    # -- end-of-layer bookkeeping (paper III-D: 'updated at the end of
    # each layer') ----------------------------------------------------------
    def update_profile(self, task: str, now: float,
                       next_realloc_in: float, next_p_need: int,
                       p_alloc: int) -> None:
        prof = self.profiles[task]
        prof.t_next = now + next_realloc_in
        prof.p_next = next_p_need
        prof.p_alloc = p_alloc

    def on_timeout_downgrade(self, mct: MCT, current: MappingCandidate
                             ) -> MappingCandidate:
        """Every time a page-request timeout fires, fall back to the
        candidate requiring fewer pages (paper III-D)."""
        if current.kind == "LBM":
            # abandon LBM for this block; largest LWM below current need
            return mct.best_fit(max(0, current.p_need - 1))
        return mct.next_smaller(current)
