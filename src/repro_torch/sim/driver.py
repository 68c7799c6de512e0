# Verbatim copy of src/repro/sim/driver.py (lines 1-529: the multi-tenant
# simulator and the arrival vocabulary the serving port accepts; SimConfig
# :44, TenantSpec :54, PoissonArrivals :93, BackoffPolicy :118,
# SessionArrivals :139, FleetScenario :186, TaskResult :201, SimResult :232,
# TenantDriver :281, MultiTenantSim :453, isolated_latencies :518); only the
# package name in its imports differs. It imports no framework.
"""Multi-tenant simulation driver: wires the event engine, the DRAM
processor-sharing pool, the NPU core pool, the unified CachePolicy
runtime and the metrics together.

Every scheduler — transparent-LLC baselines and CaMDN variants alike —
drives the *same* :class:`~repro.core.runtime.TenantTask` state machine
through one :class:`TenantDriver`; the policies differ only in the
decisions they make (see core/policy.py and sim/schedulers.py), and all
traffic flows through the NEC's :class:`~repro.core.nec.TrafficLedger`.

Tenancy is dynamic: tenants may arrive mid-run (open-loop Poisson
arrivals), run a bounded number of inferences, and depart — reclaiming
every cache page they held.

Usage:
    sim = MultiTenantSim(models=[...], scheduler="camdn")
    result = sim.run(duration_s=0.2)

    # open-loop arrivals joining a resident tenant mix:
    sim = MultiTenantSim([g0], "camdn",
                         arrivals=PoissonArrivals(rate_per_s=200,
                                                  models=[g1, g2]))
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Dict, List, Optional, Tuple, Union

from repro_torch.core.allocator import DynamicCacheAllocator
from repro_torch.core.cache import CacheConfig, SharedCache
from repro_torch.core.mapping import MapperConfig
from repro_torch.core.nec import Nec, Traffic
from repro_torch.core.runtime import TenantModel, TenantTask
from repro_torch.core.types import ModelGraph
from repro_torch.sim.engine import CorePool, DramResource, Engine
from repro_torch.sim.schedulers import (SCHEDULERS, BandwidthPolicy, CorePolicy,
                                        SchedulerSpec, TransparentParams,
                                        make_policy)


@dataclasses.dataclass
class SimConfig:
    cache: CacheConfig = dataclasses.field(default_factory=CacheConfig)
    n_cores: int = 16
    dram_bps: float = 102.4e9
    mapper: MapperConfig = dataclasses.field(default_factory=MapperConfig)
    qos_level: float = 1.0           # x latency target (0.8=H, 1.0=M, 1.2=L)
    seed: int = 0


@dataclasses.dataclass
class TenantSpec:
    """One tenant of a dynamic-tenancy scenario.

    ``model`` is the tenant's layer graph in the analytic simulator; the
    real serving path (:class:`repro.launch.serve.MultiTenantServer`)
    accepts the same spec with an *arch id string* instead, plus a
    ``prompt_len``: the tenant then arrives mid-run with a real prompt
    that is prefilled (chunked, cache-aware) before it decodes
    ``n_inferences`` tokens and departs — one arrival vocabulary shared
    by the simulator and the server."""
    model: Union[ModelGraph, str]
    arrive_at: float = 0.0           # seconds into the run
    n_inferences: Optional[int] = None   # depart after this many (None = horizon)
    qos_ms: Optional[float] = None   # per-tenant latency target override
    group_size: int = 1
    prompt_len: int = 0              # serving: prompt tokens to prefill
    # serving: tenant identity/PRNG seed.  None -> the server stamps its
    # admission counter.  The fleet router pins the GLOBAL admission
    # index here when it routes a spec to a replica, so replaying one
    # replica's scenario on a fresh single-device server reproduces the
    # exact params/prompt (and tenant id) — the bit-identical contract.
    seed: Optional[int] = None
    # serving, session replay: decoupled content identities.  When
    # ``param_seed`` is set, the tenant's parameters come from
    # PRNGKey(param_seed) rather than the admission seed, so several
    # arrivals can SHARE a model instance — the precondition for
    # cross-tenant KV dedup, which the server only attempts when this
    # field is set.  ``prefix_len`` tokens of the prompt are drawn from
    # the shared PRNGKey(104729 + prefix_seed) stream (the "system
    # prompt"), the remainder from PRNGKey(7919 + prompt_seed); both are
    # sliced from fixed-cap streams so a longer prompt with the same
    # seeds *extends* a shorter one bit-exactly (multi-turn re-arrivals).
    param_seed: Optional[int] = None
    prompt_seed: Optional[int] = None
    prefix_len: int = 0
    prefix_seed: int = 0


@dataclasses.dataclass
class PoissonArrivals:
    """Open-loop arrival process: ``n_arrivals`` tenants drawn from
    ``models`` join at exponential inter-arrival gaps and depart after
    ``n_inferences`` inferences (pages reclaimed on departure).
    ``prompt_len`` rides along to the serving path (ignored by the
    analytic simulator, whose inferences carry no token prompts)."""
    rate_per_s: float
    models: List[Union[ModelGraph, str]]
    n_arrivals: int = 8
    n_inferences: Optional[int] = 4
    seed: int = 0
    prompt_len: int = 0

    def specs(self) -> List[TenantSpec]:
        rng = random.Random(self.seed)
        t, out = 0.0, []
        for _ in range(self.n_arrivals):
            t += rng.expovariate(self.rate_per_s)
            out.append(TenantSpec(rng.choice(self.models), arrive_at=t,
                                  n_inferences=self.n_inferences,
                                  prompt_len=self.prompt_len))
        return out


@dataclasses.dataclass
class BackoffPolicy:
    """Deterministic jittered exponential backoff for deferred
    admissions.  When the serving layer's overload control *defers* an
    arrival (bounded queue, pool can't back even the cheapest KV
    reservation), the retry delay is ``base_s * factor**attempt`` capped
    at ``max_s``, scaled down by up to ``jitter`` — the jitter draw is a
    pure function of ``(seed, attempt, key)``, so replays are
    bit-identical while co-arriving retries still de-synchronize."""
    base_s: float = 1.0
    factor: float = 2.0
    max_s: float = 8.0
    jitter: float = 0.5
    seed: int = 0

    def delay_s(self, attempt: int, key: int = 0) -> float:
        d = min(self.base_s * self.factor ** max(0, attempt), self.max_s)
        rng = random.Random(self.seed * 1_000_003 + attempt * 8191 + key)
        return d * (1.0 - self.jitter * rng.random())


@dataclasses.dataclass
class SessionArrivals:
    """Session-replay workload: ``n_sessions`` chat sessions share
    ``n_prompts`` system prompts (session s uses prompt ``s % n_prompts``
    as its first ``prefix_len`` tokens) and re-arrive for ``turns``
    turns.  Turn t's prompt is the *whole* turn-(t-1) prompt extended by
    ``turn_tokens`` fresh tokens — exactly the traffic shape prefix-hash
    KV dedup targets: the first arrival per system prompt prefills it
    cold, every later arrival (same prompt, or a later turn of any
    session on it) attaches to resident pages and prefills only its
    private suffix.  All sessions of one system prompt share
    ``param_seed`` (same model instance — dedup's precondition)."""
    models: List[str]
    n_sessions: int = 4
    turns: int = 2
    n_prompts: int = 2
    prefix_len: int = 256
    turn_tokens: int = 128
    gap_s: float = 2.0               # inter-arrival gap
    n_inferences: Optional[int] = 8
    param_seed: int = 11
    seed: int = 0

    def specs(self) -> List[TenantSpec]:
        rng = random.Random(self.seed)
        out: List[TenantSpec] = []
        t = 0.0
        # arrivals interleave turns round-robin so warm re-arrivals land
        # while earlier sessions' prefixes are still resident
        for turn in range(self.turns):
            for s in range(self.n_sessions):
                prompt_id = s % self.n_prompts
                t += self.gap_s * (0.5 + rng.random())
                out.append(TenantSpec(
                    # arch follows the system prompt: dedup needs every
                    # session on one prompt to share arch AND params
                    self.models[prompt_id % len(self.models)],
                    arrive_at=t,
                    n_inferences=self.n_inferences,
                    prompt_len=self.prefix_len + (turn + 1) * self.turn_tokens,
                    param_seed=self.param_seed + prompt_id,
                    prompt_seed=1000 * self.seed + s,
                    prefix_len=self.prefix_len,
                    prefix_seed=prompt_id))
        return out


@dataclasses.dataclass
class FleetScenario:
    """A fleet run reduced to its routing decisions: per-replica lists of
    routed TenantSpecs (``seed`` pinned to the global admission index,
    ``arrive_at`` rebased to the admitting replica's logical clock) plus
    the route log.  Replaying ``per_replica[r]`` on a fresh single-device
    :class:`~repro.launch.serve.MultiTenantServer` must reproduce replica
    ``r``'s decode token streams bit-identically — the fleet's
    correctness contract, asserted by tests and the fleet benchmark."""
    n_replicas: int
    per_replica: List[List[TenantSpec]] = dataclasses.field(
        default_factory=list)
    routes: List[Tuple[str, int]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class TaskResult:
    task_id: str
    model: str
    qos_ms: float
    latencies: List[float] = dataclasses.field(default_factory=list)
    deadline_met: int = 0
    inferences: int = 0
    traffic: Traffic = dataclasses.field(default_factory=Traffic)
    arrived_at: float = 0.0
    departed_at: Optional[float] = None

    # Zero-completion contract: a tenant can legitimately finish a run
    # with NO completed inferences (admitted then preempted and never
    # resumed, or shed by overload control, or its replica was killed) —
    # every stat below must degrade to a sentinel instead of dividing by
    # zero, and every aggregator in SimResult filters on ``latencies`` /
    # ``inferences`` so the inf sentinel never poisons a mean.
    @property
    def dram_per_inference(self) -> float:
        return self.traffic.dram_total / self.inferences if self.inferences else 0.0

    @property
    def avg_latency(self) -> float:
        return sum(self.latencies) / len(self.latencies) if self.latencies else math.inf

    @property
    def sla_rate(self) -> float:
        return self.deadline_met / self.inferences if self.inferences else 0.0


@dataclasses.dataclass
class SimResult:
    scheduler: str
    tasks: List[TaskResult]
    traffic: Traffic
    duration_s: float
    dram_utilization: float

    @property
    def total_inferences(self) -> int:
        return sum(t.inferences for t in self.tasks)

    def avg_latency_by_model(self) -> Dict[str, float]:
        by: Dict[str, List[float]] = {}
        for t in self.tasks:
            by.setdefault(t.model, []).extend(t.latencies)
        return {m: sum(v) / len(v) for m, v in by.items() if v}

    @property
    def avg_latency(self) -> float:
        lats = [l for t in self.tasks for l in t.latencies]
        return sum(lats) / len(lats) if lats else math.inf

    @property
    def dram_bytes_per_inference(self) -> float:
        n = self.total_inferences
        return self.traffic.dram_total / n if n else 0.0

    @property
    def throughput(self) -> float:
        """Completed inferences per second of simulated time."""
        return self.total_inferences / self.duration_s if self.duration_s else 0.0

    @property
    def sla_rate(self) -> float:
        tot = sum(t.inferences for t in self.tasks)
        met = sum(t.deadline_met for t in self.tasks)
        return met / tot if tot else 0.0

    def stp(self, isolated: Dict[str, float]) -> float:
        """System throughput: sum of normalized progress rates."""
        return sum(isolated[t.model] / t.avg_latency
                   for t in self.tasks if t.latencies)

    def fairness(self, isolated: Dict[str, float]) -> float:
        np_ = [isolated[t.model] / t.avg_latency for t in self.tasks if t.latencies]
        return min(np_) / max(np_) if np_ else 0.0


# ---------------------------------------------------------------------------
class TenantDriver:
    """Event-loop glue for one tenant: acquire cores, walk the layer
    state machine (with page waits/timeouts), race compute against the
    shared DRAM pool, record per-inference metrics, and depart when the
    tenant's work (or the horizon) is done.  Policy-agnostic: all cache
    decisions go through ``sim.policy`` via the TenantTask."""

    def __init__(self, sim: "MultiTenantSim", task_id: str,
                 model: TenantModel, spec: TenantSpec):
        self.sim = sim
        self.id = task_id
        self.model = model
        self.spec = spec
        # a per-tenant qos_ms override IS the target; the global
        # qos_level multiplier applies only to model-default targets
        if spec.qos_ms is not None:
            qos = spec.qos_ms
        else:
            qos = model.graph.qos_ms * sim.config.qos_level
        self.qos_target_s = qos * 1e-3
        self.result = TaskResult(task_id, model.graph.name, qos,
                                 arrived_at=sim.engine.now)
        self.task = TenantTask(task_id, model, sim.cache, sim.nec,
                               sim.policy, group_size=spec.group_size)
        self.n_layers = model.num_layers
        self.layer_idx = 0
        self.infer_start = 0.0
        self.cores_held = 0
        self._compute_end = 0.0
        self._timeout_gen = 0
        self._waiting = False
        self.stopped = False

    # -- inference lifecycle -------------------------------------------
    def start(self) -> None:
        self._begin_inference()

    def _begin_inference(self) -> None:
        done_quota = (self.spec.n_inferences is not None
                      and self.result.inferences >= self.spec.n_inferences)
        if done_quota or self.sim.engine.now >= self.sim.horizon:
            self._depart()
            return
        cores = self._cores_wanted()
        self.sim.cores.acquire(cores, lambda: self._on_cores(cores))

    def _on_cores(self, cores: int) -> None:
        if self.task.done:
            self.task.reset_for_next_inference()
        self.cores_held = cores
        self.infer_start = self.sim.engine.now
        self.layer_idx = 0
        self._enter_layer()

    def _finish_inference(self) -> None:
        now = self.sim.engine.now
        lat = now - self.infer_start
        self.result.latencies.append(lat)
        self.result.inferences += 1
        if lat <= self.qos_target_s:
            self.result.deadline_met += 1
        self.sim.cores.release(self.cores_held)
        self.cores_held = 0
        self._begin_inference()

    def _depart(self) -> None:
        """Leave the system: reclaim pages, detach from the policy, fold
        this tenant's ledger entry into its result."""
        if self.stopped:
            return
        self.stopped = True
        if self._waiting and self in self.sim.page_waiters:
            self.sim.page_waiters.remove(self)
        self.task.depart()
        self.result.departed_at = self.sim.engine.now
        self.result.traffic = self.result.traffic.merged(
            self.sim.nec.ledger.drop_tenant(self.id))
        self.sim.wake_page_waiters()

    # -- layer lifecycle ------------------------------------------------
    def _enter_layer(self) -> None:
        self.task.begin_layer(self.sim.engine.now)
        self._try_alloc()

    def _try_alloc(self) -> None:
        need = self.task.pages_to_request()
        granted = self.sim.cache.alloc(self.id, need) if need else []
        if granted is None:
            if not self._waiting:
                self._waiting = True
                self.sim.page_waiters.append(self)
            self._arm_timeout()
            return
        if self._waiting:
            self._waiting = False
            if self in self.sim.page_waiters:
                self.sim.page_waiters.remove(self)
        self._timeout_gen += 1  # cancel pending timeout
        plan = self.task.start_execution(self.sim.engine.now, granted)
        comp = plan.compute_s / max(1, self.cores_held)
        self._execute(comp, plan.dram_read_bytes + plan.dram_write_bytes)

    def _arm_timeout(self) -> None:
        sel = self.task.selection
        assert sel is not None
        if math.isinf(sel.t_ahead):
            return
        self._timeout_gen += 1
        self.sim.engine.at(sel.t_ahead, self._on_timeout, self._timeout_gen)

    def _on_timeout(self, gen: int) -> None:
        if gen != self._timeout_gen or not self._waiting:
            return
        self.task.on_timeout(self.sim.engine.now)
        self._try_alloc()

    def retry(self) -> None:
        if self._waiting:
            self._try_alloc()

    def _execute(self, compute_s: float, dram_bytes: float) -> None:
        # the layer finishes at max(compute_done, dram_done); compute is
        # a private per-core resource, so it needs no heap event of its
        # own — the DRAM completion checks the precomputed end time and
        # only schedules the residual wait when compute is the laggard
        eng = self.sim.engine
        self._compute_end = eng.now + compute_s
        w = self._bw_weight()
        # service-time inflation for the scheduler's DRAM efficiency
        # (traffic counters stay pure byte counts)
        eff = self.sim.spec.dram_efficiency
        self.sim.dram.submit(dram_bytes / eff, self._on_dram_done, weight=w)

    def _on_dram_done(self) -> None:
        remaining = self._compute_end - self.sim.engine.now
        if remaining > 0:
            self.sim.engine.schedule(remaining, self._layer_done)
        else:
            self._layer_done()

    def _layer_done(self) -> None:
        self.task.end_layer(self.sim.engine.now)
        if self.sim.page_waiters:
            self.sim.wake_page_waiters()
        self.layer_idx = self.task.layer_idx
        if self.task.done:
            self._finish_inference()
        else:
            self._enter_layer()

    # -- policies ---------------------------------------------------------
    def _slack_ratio(self) -> float:
        target = self.qos_target_s
        elapsed = self.sim.engine.now - self.infer_start
        progress = max(self.layer_idx / max(1, self.n_layers), 0.05)
        predicted = elapsed / progress
        return predicted / target if target > 0 else 1.0

    def _bw_weight(self) -> float:
        # fair sharing never inspects slack — skip computing it
        if self.sim.bw_policy.kind == "fair":
            return 1.0
        return self.sim.bw_policy.weight(self._slack_ratio())

    def _cores_wanted(self) -> int:
        if not self.sim.core_policy.enabled:
            return 1
        last = self._slack_ratio() if self.result.inferences else 1.0
        return self.sim.core_policy.cores_for(last, self.sim.cores.free)


# ---------------------------------------------------------------------------
class MultiTenantSim:
    def __init__(self, models: Optional[List[ModelGraph]] = None,
                 scheduler: str = "camdn",
                 config: Optional[SimConfig] = None,
                 tparams: Optional[TransparentParams] = None,
                 tenants: Optional[List[TenantSpec]] = None,
                 arrivals: Optional[PoissonArrivals] = None):
        self.config = config or SimConfig()
        self.spec: SchedulerSpec = SCHEDULERS[scheduler]
        self.tparams = tparams or TransparentParams()
        self.engine = Engine()
        self.dram = DramResource(self.engine, self.config.dram_bps)
        self.cores = CorePool(self.engine, self.config.n_cores)
        self.bw_policy = BandwidthPolicy(self.spec.bandwidth)
        self.core_policy = CorePolicy(self.spec.core_scaling)
        self.horizon = math.inf
        self.page_waiters: List[TenantDriver] = []

        self.cache = SharedCache(self.config.cache)
        self.nec = Nec(self.cache)
        self.allocator = DynamicCacheAllocator(self.cache)
        self.policy = make_policy(self.spec, self.cache, self.allocator,
                                  self.config.mapper, self.tparams)

        self._specs: List[TenantSpec] = [TenantSpec(g) for g in (models or [])]
        self._specs += list(tenants or [])
        if arrivals is not None:
            self._specs += arrivals.specs()
        self._specs.sort(key=lambda s: s.arrive_at)

        self._tenant_models: Dict[str, TenantModel] = {}
        self.drivers: List[TenantDriver] = []

    def _model_for(self, graph: ModelGraph) -> TenantModel:
        tm = self._tenant_models.get(graph.name)
        if tm is None:
            tm = self._tenant_models[graph.name] = TenantModel(
                graph, self.config.mapper)
        return tm

    def _admit(self, spec: TenantSpec) -> None:
        tid = f"t{len(self.drivers)}:{spec.model.name}"
        d = TenantDriver(self, tid, self._model_for(spec.model), spec)
        self.drivers.append(d)
        d.start()

    def wake_page_waiters(self) -> None:
        for d in list(self.page_waiters):
            d.retry()

    def run(self, duration_s: float = 0.2) -> SimResult:
        self.horizon = duration_s
        for spec in self._specs:
            if spec.arrive_at <= 0.0:
                self._admit(spec)
            elif spec.arrive_at < self.horizon:
                self.engine.at(spec.arrive_at, self._admit, spec)
        self.engine.run(until=math.inf)
        for d in self.drivers:
            d._depart()   # idempotent; folds any residual ledger entry
        return SimResult(self.spec.name, [d.result for d in self.drivers],
                         self.nec.ledger.total, self.engine.now,
                         self.dram.utilization)


def isolated_latencies(models: List[ModelGraph],
                       config: Optional[SimConfig] = None) -> Dict[str, float]:
    """Single-tenant latency per model (transparent cache, full capacity)
    — the normalization base for STP / fairness."""
    out: Dict[str, float] = {}
    for g in models:
        if g.name in out:
            continue
        sim = MultiTenantSim([g], "baseline", config)
        res = sim.run(duration_s=0.5)
        out[g.name] = res.tasks[0].avg_latency
    return out
