# Verbatim copy of src/repro/core/runtime.py (the JAX package's framework-free
# scheduling code); only the package name in imports differs.
"""Multi-tenant runtime: the page-request / timeout / execute loop that
wraps Algorithm 1 (paper Fig. 6, right side).

The runtime is deliberately *time-agnostic*: a discrete-event engine
(sim/engine.py) or a real serving loop (launch/serve.py) drives it by
calling the state-machine methods and owning the clock.  The *decisions*
— which candidate to run, how many pages to request, when to downgrade,
when to release — are delegated to a pluggable
:class:`~repro.core.policy.CachePolicy`, so the CaMDN variants and the
transparent-LLC baselines all drive this one state machine.  Per layer:

  1. ``begin_layer(now)``   -> policy.select (Algorithm 1 for CaMDN)
  2. engine tries to allocate ``p_cur`` pages; if unavailable it waits
     until ``t_ahead``; on timeout calls ``on_timeout`` which downgrades
     the candidate; repeats.
  3. ``start_execution(now, granted)`` installs CPT mappings and returns
     an ExecutionPlan (compute seconds + DRAM bytes) for the engine's
     bandwidth-shared resource; traffic is charged through the NEC's
     traffic ledger.
  4. ``end_layer(now)``     -> frees LWM pages (LBM pages persist to the
     block tail), updates the allocator profiles, advances the layer
     cursor.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple, Union

from repro_torch.core.allocator import DynamicCacheAllocator, Selection
from repro_torch.core.cache import SharedCache
from repro_torch.core.cpt import CachePageTable
from repro_torch.core.lbm import build_model_mapping
from repro_torch.core.mapping import MapperConfig, map_layer_lwm
from repro_torch.core.mct import MCT, ModelMapping
from repro_torch.core.nec import Nec
from repro_torch.core.policy import CachePolicy, CamdnPolicy, ExecutionPlan
from repro_torch.core.types import ModelGraph


# ---------------------------------------------------------------------------
# Tenant lifecycle states.  The runtime itself only distinguishes
# RUNNING from PREEMPTED (a preempted task holds no pages and must not
# be scheduled); the remaining states exist so the serving layer and the
# fault-injection harness share one vocabulary for the admission state
# machine: ADMITTED -> RUNNING -> (PREEMPTED -> RESUMED ->)* departed,
# with SHED the terminal state for arrivals rejected by overload
# admission control.
# ---------------------------------------------------------------------------
STATE_ADMITTED = "ADMITTED"
STATE_RUNNING = "RUNNING"
STATE_PREEMPTED = "PREEMPTED"
STATE_RESUMED = "RESUMED"
STATE_SHED = "SHED"

TENANT_STATES = (STATE_ADMITTED, STATE_RUNNING, STATE_PREEMPTED,
                 STATE_RESUMED, STATE_SHED)


# The offline mapping phase is a pure function of (layer graph, mapper
# config), and the benchmark harness instantiates the same handful of
# model graphs in every one of dozens of sim runs — so the solved
# mapping plus its derived profiling tables are memoized process-wide on
# the graph's *content* (LayerSpec is frozen/hashable).  This is the
# single biggest wall-time lever in fig2/fig7: MCT construction drops
# from per-sim to once per distinct (model, config).
_DERIVED_CACHE: Dict[tuple, tuple] = {}


class TenantModel:
    """A model prepared for multi-tenant execution: graph + mapping +
    profiling tables (t_est per layer/block, STREAM-plan access bytes)."""

    def __init__(self, graph: ModelGraph, mcfg: Optional[MapperConfig] = None,
                 mapping: Optional[ModelMapping] = None):
        self.graph = graph
        self.mcfg = mcfg or MapperConfig()
        key = (graph.name, tuple(graph.layers), self.mcfg)
        cached = _DERIVED_CACHE.get(key) if mapping is None else None
        if cached is None:
            self.mapping = mapping or build_model_mapping(graph, self.mcfg)
            cf, df = self.mcfg.compute_flops, self.mcfg.dram_bps
            self.layer_t_est: List[float] = [
                mct.lwms[-1].t_est(cf, df) for mct in self.mapping.mcts]
            self.block_t_est: Dict[Tuple[int, int], float] = {
                b: sum(self.layer_t_est[b[0]:b[1]]) for b in self.mapping.blocks}
            # STREAM-plan bytes = logical cache-request traffic per layer
            self.stream_bytes: List[int] = [
                map_layer_lwm(l, 0, self.mcfg).dram_bytes for l in graph.layers]
            if mapping is None:
                _DERIVED_CACHE[key] = (self.mapping, self.layer_t_est,
                                       self.block_t_est, self.stream_bytes)
        else:
            (self.mapping, self.layer_t_est, self.block_t_est,
             self.stream_bytes) = cached

    @property
    def num_layers(self) -> int:
        return len(self.graph.layers)


class TenantTask:
    """One running instance of a model on (a group of) NPUs.

    Pure mechanism: page/CPT bookkeeping and the layer cursor.  All
    decisions go through ``self.policy``; passing a
    :class:`DynamicCacheAllocator` instead of a policy wraps it in
    :class:`CamdnPolicy` (the paper's full system, and the historical
    constructor signature)."""

    def __init__(self, task_id: str, model: TenantModel, cache: SharedCache,
                 nec: Nec,
                 policy: Union[CachePolicy, DynamicCacheAllocator],
                 group_size: int = 1, deadline_s: float = math.inf,
                 replica: str = ""):
        self.id = task_id
        self.model = model
        self.cache = cache
        self.nec = nec
        # fleet serving: which replica chip's control stack this task
        # allocates against ("" on a single-device server) — the label
        # the allocation trace and the fleet router key on
        self.replica = replica
        # Epoch-granular serving: how many identical executions of the
        # current layer the next grant covers.  A serving loop that holds
        # one grant for a K-step decode epoch sets this to K so the
        # block's NEC traffic is charged ONCE with repeat=K — exactly the
        # counters of K sequential charges — instead of re-running the
        # scheduler per token.  The simulator leaves it at 1.
        self.charge_repeat: int = 1
        if isinstance(policy, DynamicCacheAllocator):
            policy = CamdnPolicy(policy)
        self.policy: CachePolicy = policy
        self.group_size = group_size
        self.deadline_s = deadline_s
        self.cpt = CachePageTable(cache.config)
        self._n_layers = model.num_layers
        self.layer_idx = 0
        self.selection: Optional[Selection] = None
        self._held_pages: List[int] = []
        self.lbm_block: Optional[Tuple[int, int]] = None
        self.started_at: float = 0.0
        self.finished_at: Optional[float] = None
        self.state: str = STATE_ADMITTED
        self.policy.attach(self)

    # ------------------------------------------------------------------
    @property
    def done(self) -> bool:
        return self.layer_idx >= self._n_layers

    @property
    def held_pages(self) -> int:
        return len(self._held_pages)

    def mct(self) -> MCT:
        return self.model.mapping.mcts[self.layer_idx]

    def begin_layer(self, now: float) -> Selection:
        assert self.state != STATE_PREEMPTED, \
            f"{self.id}: preempted task scheduled"
        self.state = STATE_RUNNING
        self.selection = self.policy.select(self, now)
        return self.selection

    def on_timeout(self, now: float) -> Selection:
        assert self.selection is not None
        self.selection = self.policy.on_timeout(self, now)
        return self.selection

    def pages_to_request(self) -> int:
        assert self.selection is not None
        return max(0, self.selection.p_cur - len(self._held_pages))

    # ------------------------------------------------------------------
    def start_execution(self, now: float, granted: List[int]) -> ExecutionPlan:
        """Install CPT mappings for granted pages, then let the policy
        price the layer and charge traffic through the NEC ledger."""
        assert self.selection is not None
        if granted:
            base = len(self._held_pages)
            self._held_pages.extend(granted)
            self.cpt.map_pages(granted, base_vcpn=base)
        return self.policy.on_grant(self, now)

    def adopt_grant(self, selection: Selection, granted: List[int]) -> None:
        """Batched-commit path (launch/serve.py): install a Selection that
        ``select_batch`` precomputed, plus its granted pages — page/CPT
        bookkeeping identical to ``begin_layer`` + ``start_execution``
        minus the policy calls (the batched epoch planner prices through
        :func:`repro.core.policy.price_layer_batch` and replays the
        policy's grant side effects itself)."""
        assert self.state != STATE_PREEMPTED, \
            f"{self.id}: preempted task scheduled"
        self.state = STATE_RUNNING
        self.selection = selection
        if granted:
            base = len(self._held_pages)
            self._held_pages.extend(granted)
            self.cpt.map_pages(granted, base_vcpn=base)

    def charge(self, charge: Tuple[int, int, int, int, int]) -> None:
        """Charge one layer execution through the NEC ledger, folded by
        :attr:`charge_repeat`: the single point where epoch-granular
        serving multiplies a per-execution charge tuple (dram_read,
        dram_write, noc, hits, accesses) into the K executions the
        current grant covers.  Bulk layer pricing is linear in the
        repeat count, so this is bit-identical to K individual calls."""
        rep = self.charge_repeat
        if rep != 1:
            charge = tuple(c * rep for c in charge)
        self.nec.ledger.charge_bulk(self.id, *charge)

    # ------------------------------------------------------------------
    def end_layer(self, now: float) -> None:
        assert self.selection is not None
        self.policy.on_layer_end(self, now)

    def release_pages(self) -> None:
        """Return every held page to the pool and drop residency + CPT
        mappings (also the departure/reclamation path)."""
        if self._held_pages:
            self.cache.free(self.id, self._held_pages)
            self.nec.invalidate_tenant(self.id)
            self._held_pages = []
            self.cpt.clear()

    def advance_layer(self, now: float) -> None:
        self.layer_idx += 1
        if self.done:
            self.finished_at = now

    def depart(self) -> None:
        """Dynamic tenancy: leave the system, reclaiming all pages and
        detaching from the policy (allocator profiles, quotas)."""
        self.release_pages()
        self.policy.detach(self)

    # ------------------------------------------------------------------
    def preempt(self) -> None:
        """Pause the task: every held page returns to the pool and the
        allocator forgets the tenant's profile (so survivors' grants can
        grow into the freed space), but — unlike :meth:`depart` — the
        task object stays alive so :meth:`resume` can re-attach it.
        Only legal between inferences (``done`` or at layer 0): the
        serving layer preempts at epoch boundaries, never mid-block."""
        assert self.done or self.layer_idx == 0, \
            f"{self.id}: preempt mid-block (layer {self.layer_idx})"
        self.release_pages()
        self.policy.detach(self)
        self.selection = None
        self.state = STATE_PREEMPTED

    def resume(self) -> None:
        """Undo :meth:`preempt`: re-attach to the policy (fresh profile
        — page residency was surrendered, so the allocator restarts this
        tenant's reuse history) and make the task schedulable again."""
        assert self.state == STATE_PREEMPTED, f"{self.id}: not preempted"
        self.policy.attach(self)
        if self.done:
            self.reset_for_next_inference()
        self.state = STATE_RESUMED

    def reset_for_next_inference(self) -> None:
        """Re-arm the task for another inference of the same model."""
        assert self.done
        self.layer_idx = 0
        self.finished_at = None
        self.selection = None
