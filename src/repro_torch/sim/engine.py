# Verbatim copy of src/repro/sim/engine.py (lines 1-255: the event engine
# and the simulated SoC's DRAM and core pools; Engine :19, DramResource :99,
# CorePool :232); only the package name in its imports differs. It imports
# no framework.
"""Discrete-event engine with a processor-sharing DRAM resource.

The paper evaluates CaMDN on an in-door cycle-accurate simulator
(DRAMsim3-based).  We model the same system at event granularity, which
is sufficient for layer-level traffic/latency accounting: DRAM is a
processor-sharing bandwidth pool (weights settable per job for the
MoCA-style bandwidth schedulers); compute per NPU core is private, so a
layer finishes at max(compute_done, dram_done).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from typing import Callable, Dict, List, Optional, Tuple


class Engine:
    """Event heap plus registered *clocks*: a clock is a resource whose
    next event time changes on every interaction (the processor-sharing
    DRAM pool re-targets its completion on every membership change).
    Modelling it as a polled ``next_t``/``fire()`` pair instead of heap
    events removes the push-then-invalidate churn such resources would
    otherwise inflict on the heap — the run loop just takes whichever of
    heap-top / clocks is earliest (heap wins ties)."""

    def __init__(self):
        self.now = 0.0
        self._heap: List[Tuple[float, int, Callable, object]] = []
        self._seq = itertools.count()
        self._clocks: List = []   # objects exposing .next_t and .fire()

    def add_clock(self, clock) -> None:
        self._clocks.append(clock)

    def schedule(self, delay: float, fn: Callable, arg: object = None) -> None:
        """Fire ``fn()`` — or ``fn(arg)`` when ``arg`` is given — after
        ``delay`` seconds.  Passing the argument through the heap entry
        lets hot callers avoid allocating a closure per event."""
        if delay < 0 or math.isnan(delay):
            raise ValueError(f"bad delay {delay}")
        if math.isinf(delay):
            return  # never fires
        heapq.heappush(self._heap, (self.now + delay, next(self._seq), fn, arg))

    def at(self, t: float, fn: Callable, arg: object = None) -> None:
        self.schedule(max(0.0, t - self.now), fn, arg)

    def push_at(self, t: float, fn: Callable, arg: object = None) -> None:
        """Unchecked absolute-time push for internal hot paths whose
        delay is already known finite and non-negative."""
        heapq.heappush(self._heap, (t, next(self._seq), fn, arg))

    def run(self, until: float = math.inf, max_events: int = 50_000_000) -> None:
        heap = self._heap
        clocks = self._clocks
        inf = math.inf
        n = 0
        while n < max_events:
            t_best = heap[0][0] if heap else inf
            src = None
            for c in clocks:
                tc = c.next_t
                if tc < t_best:
                    t_best = tc
                    src = c
            if t_best == inf:
                return
            if t_best > until:
                self.now = until
                return
            self.now = t_best
            if src is None:
                _, _, fn, arg = heapq.heappop(heap)
                if arg is None:
                    fn()
                else:
                    fn(arg)
            else:
                src.fire()
            n += 1
        raise RuntimeError("event budget exhausted (livelock?)")

    @property
    def idle(self) -> bool:
        return not self._heap and all(
            math.isinf(c.next_t) for c in self._clocks)


@dataclasses.dataclass(slots=True)
class _DramJob:
    job_id: int
    weight: float
    on_done: Callable[[], None]
    v_target: float   # virtual time at which the job completes


class DramResource:
    """Weighted processor-sharing over ``total_bps`` bytes/second,
    simulated in *virtual time* (the classic PS/GPS formulation): virtual
    time V advances at ``total_bps / sum(weights)``, so a job admitted at
    V0 with ``nbytes`` and ``weight`` completes exactly when V reaches
    ``V0 + nbytes / weight`` — a constant, membership changes
    notwithstanding.  Completions therefore live in one heap ordered by
    V-target and every operation is O(log jobs) with no per-job scans
    (this pool is the innermost loop of every sim run).  Weight changes
    re-target the job (remaining virtual service rescales by
    old/new weight) with lazy deletion of the stale heap entry.

    The pool is an Engine *clock*: ``next_t`` is the wall time of the
    earliest completion and ``fire()`` delivers it, so re-targeting on a
    membership change is a plain assignment — no heap event to push or
    invalidate."""

    def __init__(self, engine: Engine, total_bps: float):
        self.engine = engine
        self.total_bps = total_bps
        self.jobs: Dict[int, _DramJob] = {}
        self._vheap: List[Tuple[float, int]] = []   # (v_target, job_id)
        self._v = 0.0
        self._ids = itertools.count()
        self._last = 0.0
        self._wsum = 0.0   # incrementally-maintained sum of job weights
        self.next_t = math.inf   # wall time of the earliest completion
        self.busy_seconds = 0.0
        self.bytes_served = 0.0
        engine.add_clock(self)

    # -- internals ------------------------------------------------------
    def _advance(self) -> None:
        dt = self.engine.now - self._last
        self._last = self.engine.now
        if dt <= 0 or not self.jobs:
            return
        self._v += dt * self.total_bps / self._wsum
        self.busy_seconds += dt
        self.bytes_served += dt * self.total_bps

    # Jobs with less than a cache line left are done (prevents float
    # asymptotes); ticks are floored at 1ns so equal-timestamp re-arms
    # can never livelock the event loop.
    DRAIN_BYTES = 64.0
    MIN_TICK = 1e-9

    def _top(self) -> Optional[Tuple[float, int]]:
        """Heap top, dropping lazily-deleted (re-targeted / completed)
        entries."""
        heap = self._vheap
        while heap:
            vt, jid = heap[0]
            j = self.jobs.get(jid)
            if j is not None and j.v_target == vt:
                return heap[0]
            heapq.heappop(heap)
        return None

    def _rearm(self) -> None:
        if not self.jobs:
            self._wsum = 0.0   # swallow any float drift at quiescence
            self._v = 0.0
            self.next_t = math.inf
            return
        top = self._top()
        eta = (top[0] - self._v) * self._wsum / self.total_bps
        if eta < self.MIN_TICK:
            eta = self.MIN_TICK
        self.next_t = self.engine.now + eta

    def fire(self) -> None:
        """Deliver the completion(s) due at ``next_t`` (Engine clock
        protocol)."""
        self._advance()
        done = []
        while True:
            top = self._top()
            if top is None:
                break
            vt, jid = top
            j = self.jobs[jid]
            if (vt - self._v) * j.weight > self.DRAIN_BYTES:
                break
            heapq.heappop(self._vheap)
            del self.jobs[jid]
            self._wsum -= j.weight
            done.append(j)
        self._rearm()
        for j in done:
            j.on_done()

    # -- API -------------------------------------------------------------
    def submit(self, nbytes: float, on_done: Callable[[], None],
               weight: float = 1.0) -> int:
        self._advance()
        jid = next(self._ids)
        if nbytes <= 0:
            self.engine.push_at(self.engine.now, on_done)
            return jid
        weight = max(weight, 1e-6)
        j = _DramJob(jid, weight, on_done, self._v + nbytes / weight)
        self.jobs[jid] = j
        self._wsum += weight
        heapq.heappush(self._vheap, (j.v_target, jid))
        # always re-arm: the clock must fire only at computed completion
        # times, because the DRAIN_BYTES tolerance assumes a firing IS a
        # completion (an early firing could otherwise finish a
        # nearly-done job a line short)
        self._rearm()
        return jid

    def set_weight(self, job_id: int, weight: float) -> None:
        j = self.jobs.get(job_id)
        if j is not None:
            self._advance()
            weight = max(weight, 1e-6)
            # remaining virtual service rescales with the weight ratio
            j.v_target = self._v + (j.v_target - self._v) * j.weight / weight
            self._wsum += weight - j.weight
            j.weight = weight
            heapq.heappush(self._vheap, (j.v_target, job_id))
            self._rearm()

    @property
    def active_jobs(self) -> int:
        return len(self.jobs)

    @property
    def utilization(self) -> float:
        return (self.bytes_served / self.total_bps) / self.engine.now if self.engine.now else 0.0


class CorePool:
    """NPU cores; tasks acquire ``n`` cores per inference, FIFO waiting."""

    def __init__(self, engine: Engine, num_cores: int):
        self.engine = engine
        self.free = num_cores
        self.num_cores = num_cores
        self._waiters: List[Tuple[int, Callable[[], None]]] = []

    def acquire(self, n: int, cb: Callable[[], None]) -> None:
        if n > self.num_cores:
            raise ValueError("request exceeds pool size")
        if self.free >= n and not self._waiters:
            self.free -= n
            self.engine.schedule(0.0, cb)
        else:
            self._waiters.append((n, cb))

    def release(self, n: int) -> None:
        self.free += n
        while self._waiters and self._waiters[0][0] <= self.free:
            need, cb = self._waiters.pop(0)
            self.free -= need
            self.engine.schedule(0.0, cb)
