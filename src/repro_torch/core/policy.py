# Verbatim copy of src/repro/core/policy.py (the JAX package's framework-free
# scheduling code); only the package name in imports differs.
"""Pluggable cache policies: the strategy layer of the unified
multi-tenant runtime.

Every scheduler the paper compares — the transparent-LLC baselines
(``baseline`` / ``moca`` / ``aurora``, defined in sim/schedulers.py) and
the NPU-controlled CaMDN variants (``camdn_hw`` / ``camdn``, defined
here) — implements one :class:`CachePolicy` protocol and drives the
*same* :class:`~repro.core.runtime.TenantTask` state machine:

  select(task, now)        -> Selection      (which candidate, how many
                                              pages, timeout horizon)
  on_timeout(task, now)    -> Selection      (downgrade after a failed
                                              page wait)
  on_grant(task, now)      -> ExecutionPlan  (price the layer, charge
                                              traffic through the NEC
                                              ledger)
  on_layer_end(task, now)  -> None           (release pages, advance the
                                              cursor, update profiles)

plus ``attach``/``detach`` for dynamic tenancy (open-loop arrivals and
departures with page reclamation).  Keeping one protocol means every
comparison is apples-to-apples: one task state machine, one traffic
ledger, one event engine — the policies differ only in *decisions*.

Fleet serving (launch/serve.py FleetServer) scales the co-design across
a device mesh: every replica chip owns a full control stack — its own
SharedCache page pool, NEC ledger, DynamicCacheAllocator, and
CamdnPolicy — bundled as a :class:`ReplicaControl` and handed out by a
:class:`ReplicaAllocators` registry keyed by replica id.  Nothing is
shared between replicas: one chip's grant pressure can never starve a
tenant on another chip, which is exactly the paper's model-exclusive
region guarantee lifted to the fleet level.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Protocol, Sequence, Tuple, runtime_checkable

import numpy as np

from repro_torch.core.allocator import AHEAD_FRACTION, DynamicCacheAllocator, Selection
from repro_torch.core.mct import MCT, MappingCandidate
from repro_torch.core.nec import layer_charge
from repro_torch.core.types import LayerSpec


@dataclasses.dataclass
class ExecutionPlan:
    compute_s: float
    dram_read_bytes: int
    dram_write_bytes: int
    access_bytes: int      # logical NPU->cache request bytes (for hit rate)


@runtime_checkable
class CachePolicy(Protocol):
    """Structural protocol every scheduler policy implements."""

    name: str

    def attach(self, task) -> None: ...
    def detach(self, task) -> None: ...
    def select(self, task, now: float) -> Selection: ...
    def on_timeout(self, task, now: float) -> Selection: ...
    def on_grant(self, task, now: float) -> ExecutionPlan: ...
    def on_layer_end(self, task, now: float) -> None: ...


# ---------------------------------------------------------------------------
# shared pricing helpers (identical math for every NPU-controlled policy)
# ---------------------------------------------------------------------------
def split_layer_traffic(task, cand: MappingCandidate) -> Tuple[int, int]:
    """(dram_read, dram_write) for the task's current layer under
    ``cand``: writes are the part of the layer output that reaches DRAM
    (an LBM block keeps intermediates cache-resident until the tail)."""
    i = task.layer_idx
    layer: LayerSpec = task.model.graph.layers[i]
    if cand.kind == "LBM":
        blk = task.model.mapping.block_of(i)
        wr = layer.output_bytes if i == blk[1] - 1 else 0
    else:
        wr = layer.output_bytes
    rd = max(0, cand.dram_bytes - wr)
    return rd, wr


def release_after_layer(task) -> bool:
    """End-of-layer page release shared by the NPU-controlled policies:
    LWM pages free immediately, LBM pages persist to the block tail.
    Returns whether the release happened (the block ended)."""
    release = True
    if task.selection.candidate.kind == "LBM" and task.lbm_block is not None:
        release = (task.layer_idx == task.lbm_block[1] - 1)
        if release:
            task.lbm_block = None
    if release:
        task.release_pages()
    return release


def charge_and_plan(task, cand: MappingCandidate,
                    cache: Optional[Dict] = None) -> ExecutionPlan:
    """Charge the layer through the NEC traffic ledger and build the
    engine-facing plan.  Used by every NPU-controlled policy so CaMDN
    variants price layers identically.

    ``cache`` (policy-instance dict) memoizes the pricing per
    (model, layer, candidate, group): the same candidate is re-priced on
    every inference of every tenant of a model, so grant-time work drops
    to one dict hit plus the (mandatory, per-execution) ledger charge.
    Keyed on ``id(cand)``, which is stable for the policy's lifetime —
    candidates are pinned by the model mappings the driving sim/server
    holds at least as long as it holds the policy.

    The ledger charge goes through :meth:`TenantTask.charge`, which
    folds in the task's ``charge_repeat`` (epoch-granular serving: one
    grant covering K decode steps charges once with repeat=K).  The
    returned ExecutionPlan always prices a SINGLE execution."""
    key = None
    if cache is not None:
        key = (task.model.graph.name, task.layer_idx, id(cand),
               task.group_size)
        hit = cache.get(key)
        if hit is not None:
            plan, charge = hit
            task.charge(charge)
            return plan
    rd, wr = split_layer_traffic(task, cand)
    access = task.model.stream_bytes[task.layer_idx]
    charge = layer_charge(rd, wr, access, task.group_size,
                          task.nec.config.line_bytes)
    compute_s = cand.flops / (task.model.mcfg.compute_flops * task.group_size)
    plan = ExecutionPlan(compute_s, rd, wr, access)
    if key is not None:
        cache[key] = (plan, charge)
    task.charge(charge)
    return plan


def price_layer_batch(items: Sequence[Tuple[object, MappingCandidate, int]],
                      cache: Optional[Dict] = None
                      ) -> List[Tuple[ExecutionPlan, Tuple[int, ...]]]:
    """Pure batched layer pricing: evaluate every (task, candidate,
    layer_idx) triple in one pass — memo lookups first, then ONE
    vectorized :func:`repro.core.nec.layer_charge` over the miss set.
    Returns (ExecutionPlan, charge-tuple) per item and mutates nothing but
    the memo, so the caller controls exactly when each charge lands on the
    ledger (the batched epoch planner charges at the oracle's on-grant
    points).  Bit-identical to scalar pricing: numpy int64 floor-division
    matches Python ``//`` for the non-negative byte volumes here, and the
    memo keys/values are exactly :func:`charge_and_plan`'s."""
    if cache is None:
        cache = {}
    keys = [(task.model.graph.name, layer_idx, id(cand), task.group_size)
            for task, cand, layer_idx in items]
    miss = [i for i, k in enumerate(keys) if k not in cache]
    if miss:
        n = len(miss)
        rd = np.empty(n, np.int64)
        wr = np.empty(n, np.int64)
        access = np.empty(n, np.int64)
        group = np.empty(n, np.int64)
        line = np.empty(n, np.int64)
        for j, i in enumerate(miss):
            task, cand, layer_idx = items[i]
            rd[j], wr[j] = split_layer_traffic_at(task, cand, layer_idx)
            access[j] = task.model.stream_bytes[layer_idx]
            group[j] = task.group_size
            line[j] = task.nec.config.line_bytes
        noc = access * np.maximum(1, group)
        hits = np.maximum(0, access - rd - wr) // line
        accesses = np.maximum(1, access // line)
        for j, i in enumerate(miss):
            task, cand, _ = items[i]
            compute_s = cand.flops / (task.model.mcfg.compute_flops
                                      * task.group_size)
            plan = ExecutionPlan(compute_s, int(rd[j]), int(wr[j]),
                                 int(access[j]))
            charge = (int(rd[j]), int(wr[j]), int(noc[j]), int(hits[j]),
                      int(accesses[j]))
            cache[keys[i]] = (plan, charge)
    return [cache[k] for k in keys]


def charge_and_plan_batch(items: Sequence[Tuple[object, MappingCandidate]],
                          cache: Optional[Dict] = None) -> List[ExecutionPlan]:
    """Batched :func:`charge_and_plan`: price every (task, candidate) pair
    at the task's current layer cursor in one numpy pass, then charge each
    task's ledger in the given order.  Bit-identical to sequential
    ``charge_and_plan`` calls — same memo, same charge tuples, and
    per-tenant ledger counters are independent across tasks."""
    priced = price_layer_batch(
        [(task, cand, task.layer_idx) for task, cand in items], cache)
    plans: List[ExecutionPlan] = []
    for (task, _), (plan, charge) in zip(items, priced):
        task.charge(charge)
        plans.append(plan)
    return plans


def split_layer_traffic_at(task, cand: MappingCandidate,
                           layer_idx: int) -> Tuple[int, int]:
    """:func:`split_layer_traffic` for an explicit layer index — what-if
    pricing prices layers the task cursor is not currently on."""
    layer: LayerSpec = task.model.graph.layers[layer_idx]
    if cand.kind == "LBM":
        blk = task.model.mapping.block_of(layer_idx)
        wr = layer.output_bytes if layer_idx == blk[1] - 1 else 0
    else:
        wr = layer.output_bytes
    rd = max(0, cand.dram_bytes - wr)
    return rd, wr


def project_epoch_dram(task, cands: Sequence[MappingCandidate],
                       k: int = 1) -> int:
    """What-if DRAM bytes for one epoch (``k`` executions of the task's
    graph) under a per-layer candidate assignment — pure: prices through
    the same :func:`split_layer_traffic` math as the ledger path but
    mutates nothing.  Used by the predictive grant lookahead to compare
    assignments one epoch ahead."""
    total = 0
    for i, cand in enumerate(cands):
        rd, wr = split_layer_traffic_at(task, cand, i)
        total += rd + wr
    return total * max(1, k)


# ---------------------------------------------------------------------------
# Precision-for-residency: the KV-precision ladder, highest fidelity
# first.  Admission walks it downward until a tenant's FULL KV
# reservation fits the free pool — dropping precision to keep residency
# beats keeping precision and spilling (degraded grants, starved
# prefill chunks).
# ---------------------------------------------------------------------------
KV_PRECISION_LADDER: Tuple[str, ...] = ("native", "fp8_e4m3", "int8")


def choose_kv_dtype(want_pages: Dict[str, int], free_pages: int,
                    ladder: Tuple[str, ...] = KV_PRECISION_LADDER) -> str:
    """Pick the highest-fidelity KV precision whose full reservation
    fits ``free_pages``.  ``want_pages`` maps each ladder rung to the
    tenant's KV page reservation at that precision (as priced by the
    serving layer's reservation math).  When nothing fits — the pool is
    oversubscribed outright — returns the ladder bottom, which
    maximizes the fraction of the reservation the degradation path can
    still satisfy."""
    for kv in ladder:
        if kv not in want_pages:
            continue
        if want_pages[kv] <= free_pages:
            return kv
    return ladder[-1]


# ---------------------------------------------------------------------------
# Preemption victim selection.  When the pool must be reclaimed (fault
# injection, pressure spikes, straggler mitigation) the serving layer
# asks a pluggable policy which tenant to pause.  Candidates are plain
# tuples so the policy stays decoupled from the serving layer's Tenant
# object: (tenant_id, qos_target_s, pages_held, tokens_served).
# ---------------------------------------------------------------------------
PreemptionCandidate = Tuple[str, Optional[float], int, int]


class PreemptionPolicy(Protocol):
    """Victim selection for tenant preemption."""

    def select(self, candidates: Sequence[PreemptionCandidate]
               ) -> Optional[str]:
        """Return the tenant id to preempt, or None to decline."""
        ...


class QosPreemptionPolicy:
    """QoS-aware victim selection: pause the tenant that hurts the SLO
    picture least and frees the most.  Order of preference:

      1. loosest QoS target first — a tenant with no target at all
         (best-effort) is always preferred over any tenant with one;
      2. among equals, the largest page reservation (frees the most
         pool per preemption);
      3. ties broken by tenant id for determinism.
    """

    name = "qos"

    def select(self, candidates: Sequence[PreemptionCandidate]
               ) -> Optional[str]:
        if not candidates:
            return None
        def rank(c: PreemptionCandidate):
            tid, qos, pages, _served = c
            # None (best-effort) sorts loosest; otherwise larger target
            # = looser SLO = better victim.
            return (0 if qos is None else 1, -(qos or 0.0), -pages, tid)
        return min(candidates, key=rank)[0]


# ---------------------------------------------------------------------------
class CamdnPolicy:
    """CaMDN(Full): Algorithm 1 dynamic allocation + LBM + timeouts,
    delegated to :class:`DynamicCacheAllocator`."""

    name = "camdn"

    def __init__(self, allocator: DynamicCacheAllocator):
        self.allocator = allocator
        self._price_cache: Dict = {}

    # -- tenancy -------------------------------------------------------
    def attach(self, task) -> None:
        self.allocator.register_task(task.id)

    def detach(self, task) -> None:
        self.allocator.remove_task(task.id)

    # -- per-layer decisions -------------------------------------------
    def select(self, task, now: float) -> Selection:
        i = task.layer_idx
        block = task.model.mapping.block_of(i)
        return self.allocator.select(
            task.id, task.mct(), now,
            layer_t_est=task.model.layer_t_est[i],
            block_t_est=task.model.block_t_est[block],
            is_head_of_block=task.model.mapping.is_head_of_block(i))

    def select_batch(self, tasks: Sequence, now: float) -> List[Selection]:
        """Batched :meth:`select` over many tasks at their current layer
        cursors — one numpy pass through the allocator's profile arrays.
        Pure; bit-identical to per-task ``select`` calls."""
        ids, mcts, lts, bts, heads = [], [], [], [], []
        for task in tasks:
            i = task.layer_idx
            block = task.model.mapping.block_of(i)
            ids.append(task.id)
            mcts.append(task.mct())
            lts.append(task.model.layer_t_est[i])
            bts.append(task.model.block_t_est[block])
            heads.append(task.model.mapping.is_head_of_block(i))
        return self.allocator.select_batch(ids, mcts, now, lts, bts, heads)

    def on_timeout(self, task, now: float) -> Selection:
        cand = self.allocator.on_timeout_downgrade(
            task.mct(), task.selection.candidate)
        t_ahead = now + task.model.layer_t_est[task.layer_idx] * AHEAD_FRACTION
        return Selection(cand, cand.p_need, t_ahead)

    def on_grant(self, task, now: float) -> ExecutionPlan:
        cand = task.selection.candidate
        if cand.kind == "LBM" and not self.allocator.has_enabled_lbm(task.id):
            self.allocator.set_lbm(task.id, True)
            task.lbm_block = task.model.mapping.block_of(task.layer_idx)
        return charge_and_plan(task, cand, self._price_cache)

    def on_layer_end(self, task, now: float) -> None:
        lbm_was_on = task.lbm_block is not None
        if release_after_layer(task) and lbm_was_on:
            self.allocator.set_lbm(task.id, False)
        task.advance_layer(now)
        # --- profile update (Algorithm 1 Data arrays) ------------------
        if not task.done:
            nxt = task.layer_idx
            mct_next = task.model.mapping.mcts[nxt]
            if self.allocator.has_enabled_lbm(task.id) and mct_next.lbm is not None:
                # LBM continues: the allocation persists unchanged
                next_need = task.held_pages
            else:
                # steady-state prediction: a task tends to re-select the
                # candidate class matching its current allocation
                next_need = mct_next.best_fit(
                    max(task.held_pages, mct_next.min_pages)).p_need
            self.allocator.update_profile(
                task.id, now, next_realloc_in=task.model.layer_t_est[nxt],
                next_p_need=next_need, p_alloc=task.held_pages)
        else:
            self.allocator.update_profile(task.id, now, 0.0, 0, 0)


# ---------------------------------------------------------------------------
class StaticQuotaPolicy:
    """CaMDN(HW-only): NPU-controlled exclusive regions with an equal
    static page split; best-fit candidate selection inside the fixed
    quota, no dynamic borrowing.  The quota is recomputed when tenants
    arrive or depart (an equal split over the *current* tenant set)."""

    name = "camdn_hw"

    def __init__(self, cache):
        self.cache = cache
        self._attached: Dict[str, object] = {}
        self._price_cache: Dict = {}

    @property
    def quota(self) -> int:
        return self.cache.config.num_pages // max(1, len(self._attached))

    # -- tenancy -------------------------------------------------------
    def attach(self, task) -> None:
        self._attached[task.id] = task

    def detach(self, task) -> None:
        self._attached.pop(task.id, None)

    # -- per-layer decisions -------------------------------------------
    def select(self, task, now: float) -> Selection:
        i = task.layer_idx
        mct: MCT = task.mct()
        cand: Optional[MappingCandidate] = None
        if (mct.lbm is not None and task.lbm_block is not None
                and i < task.lbm_block[1]):
            cand = mct.lbm        # block already running under LBM
        elif (mct.lbm is not None and task.model.mapping.is_head_of_block(i)
              and mct.lbm.p_need <= self.quota):
            cand = mct.lbm
        if cand is None:
            cand = mct.best_fit(self.quota)
        t_ahead = now + task.model.layer_t_est[i] * AHEAD_FRACTION
        return Selection(cand, cand.p_need, t_ahead)

    def on_timeout(self, task, now: float) -> Selection:
        mct = task.mct()
        cur = task.selection.candidate
        if cur.kind == "LBM":
            cand = mct.best_fit(max(0, cur.p_need - 1))
        else:
            cand = mct.next_smaller(cur)
        t_ahead = now + task.model.layer_t_est[task.layer_idx] * AHEAD_FRACTION
        return Selection(cand, cand.p_need, t_ahead)

    def on_grant(self, task, now: float) -> ExecutionPlan:
        cand = task.selection.candidate
        if cand.kind == "LBM" and task.lbm_block is None:
            task.lbm_block = task.model.mapping.block_of(task.layer_idx)
        return charge_and_plan(task, cand, self._price_cache)

    def on_layer_end(self, task, now: float) -> None:
        release_after_layer(task)
        task.advance_layer(now)


# ---------------------------------------------------------------------------
# Per-replica control stacks (fleet serving).
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ReplicaControl:
    """One replica chip's full CaMDN control stack: the page pool it
    exclusively owns plus the NEC ledger / allocator / policy arbitrating
    it.  Constructed via :meth:`build` so every replica gets the same
    cache geometry with zero sharing."""

    replica: str
    cache: "SharedCache"
    nec: "Nec"
    alloc: DynamicCacheAllocator
    policy: CachePolicy
    prefix: "PrefixIndex"

    @classmethod
    def build(cls, replica: str, cache_config) -> "ReplicaControl":
        from repro_torch.core.cache import PrefixIndex, SharedCache
        from repro_torch.core.nec import Nec
        cache = SharedCache(cache_config)
        nec = Nec(cache)
        alloc = DynamicCacheAllocator(cache)
        # the index registers itself as the pool's pressure hook, so
        # grants under pressure first reclaim cold shared prefixes
        prefix = PrefixIndex(cache)
        return cls(replica, cache, nec, alloc, CamdnPolicy(alloc), prefix)

    # -- feedback the fleet router consumes ----------------------------
    @property
    def used_pages(self) -> int:
        return self.cache.config.num_pages - self.cache.free_pages

    @property
    def utilization(self) -> float:
        return self.used_pages / max(1, self.cache.config.num_pages)

    @property
    def dram_bytes(self) -> int:
        return self.nec.traffic.dram_total


class ReplicaAllocators:
    """Registry of per-replica control stacks, keyed by replica id.
    ``get`` builds a replica's stack on first use — every chip in the
    serving mesh gets an identical-geometry, fully independent pool."""

    def __init__(self, cache_config):
        self.cache_config = cache_config
        self._controls: Dict[str, ReplicaControl] = {}

    def get(self, replica: str) -> ReplicaControl:
        ctl = self._controls.get(replica)
        if ctl is None:
            ctl = self._controls[replica] = ReplicaControl.build(
                replica, self.cache_config)
        return ctl

    def __iter__(self):
        return iter(self._controls.values())

    def utilizations(self) -> Dict[str, float]:
        return {r: c.utilization for r, c in self._controls.items()}
