# Verbatim copy of src/repro/sim/faults.py (the fault schedule: FaultEvent
# :33, FaultPlan :67, FaultLog :126); only the package name in its
# cross-references differs.  It imports no framework.
"""Deterministic fault injection for the serving stack.

A :class:`FaultPlan` is a seeded, *logical-clock-scheduled* list of
:class:`FaultEvent`\\ s — replica death, page-pool pressure spikes,
straggler epochs, malformed/oversized prompts, explicit tenant
preemption — consumed by :class:`~repro_torch.launch.serve.MultiTenantServer`
and :class:`~repro_torch.launch.serve.FleetServer` at their epoch boundaries.
Scheduling on the logical step clock (the same clock that makes
admission points deterministic across admission modes) is what makes
every recovery path repeatable: the same plan against the same workload
fires the same faults at the same epochs, on CPU CI's forced 4-device
mesh or on real chips.

The servers do the *reacting* (checkpoint/restore, failover re-routing,
admission backpressure); this module only decides *what goes wrong
when*, and records what happened in a :class:`FaultLog` so tests and
the ``--faults`` benchmark can assert on the injected timeline.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Any, Dict, List, Optional, Sequence

# Every fault kind the servers know how to inject.  ``replica_kill`` is
# fleet-level (ignored by a standalone server); the rest apply to any
# MultiTenantServer — the fleet forwards them to the target replica.
FAULT_KINDS = ("replica_kill", "pool_pressure", "straggler",
               "bad_prompt", "preempt")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.

    ``step``   logical-clock step at (or after) which the fault fires.
    ``kind``   one of :data:`FAULT_KINDS`.
    ``target`` replica id ("r1") for fleet-level kinds / forwarding, or
               a tenant id for ``preempt``; None lets the server pick
               (preemption goes through the victim-selection policy).
    ``pages``  pool_pressure: pages seized from the free pool (the
               pool's pressure hook may reclaim cold prefixes to serve
               the spike, exactly like a real burst of grants).
    ``hold_epochs``  pool_pressure: epochs before the seized pages are
               released; preempt: epochs before the victim resumes;
               straggler: consecutive epochs slowed by ``factor``.
    ``factor`` straggler: synthetic slowdown multiplier applied to the
               observed epoch duration.  The default trips the seed
               StragglerPolicy (threshold 2.5x EWMA, 3 strikes) even as
               its clamped EWMA catches up during the strike run.
    ``spec``   bad_prompt: the malformed TenantSpec to enqueue; None
               synthesizes an oversized prompt for ``target``'s arch.
    """
    step: int
    kind: str
    target: Optional[str] = None
    pages: int = 0
    hold_epochs: int = 2
    factor: float = 8.0
    spec: Any = None

    def __post_init__(self) -> None:
        assert self.kind in FAULT_KINDS, self.kind
        assert self.step >= 0, self.step


class FaultPlan:
    """An ordered fault schedule with pop-when-due semantics.

    ``due(clock)`` returns (and consumes) every event whose step has
    passed; ``peek_step()`` is the next unfired step, which the
    servers' idle fast-forward treats as a wake-up source so a fault
    scheduled into an idle gap still fires."""

    def __init__(self, events: Sequence[FaultEvent] = ()):
        # stable total order: step, then kind rank, then target —
        # deterministic even when events share a step
        self.events: List[FaultEvent] = sorted(
            events, key=lambda e: (e.step, FAULT_KINDS.index(e.kind),
                                   e.target or ""))
        self._cursor = 0

    def due(self, clock: int) -> List[FaultEvent]:
        out: List[FaultEvent] = []
        while (self._cursor < len(self.events)
               and self.events[self._cursor].step <= clock):
            out.append(self.events[self._cursor])
            self._cursor += 1
        return out

    def peek_step(self) -> Optional[int]:
        if self._cursor < len(self.events):
            return self.events[self._cursor].step
        return None

    @property
    def exhausted(self) -> bool:
        return self._cursor >= len(self.events)

    def reset(self) -> None:
        self._cursor = 0

    @classmethod
    def seeded(cls, seed: int, horizon: int, epoch_len: int = 8,
               kinds: Sequence[str] = ("pool_pressure", "straggler",
                                       "preempt"),
               n_events: int = 3, n_replicas: int = 0,
               pages: int = 16) -> "FaultPlan":
        """A reproducible random plan: ``n_events`` faults drawn from
        ``kinds`` on the epoch grid of ``[epoch_len, horizon)``.  With
        ``n_replicas > 0``, each event targets a random replica (and
        ``replica_kill`` becomes drawable)."""
        rng = random.Random(seed)
        steps = max(1, (horizon - 1) // epoch_len)
        events = []
        for _ in range(n_events):
            kind = rng.choice(list(kinds))
            step = epoch_len * rng.randrange(1, steps + 1)
            target = (f"r{rng.randrange(n_replicas)}" if n_replicas > 0
                      else None)
            events.append(FaultEvent(step=step, kind=kind, target=target,
                                     pages=pages))
        return cls(events)


class FaultLog:
    """Append-only record of injected faults and the recovery actions
    they triggered — the observable timeline tests assert against."""

    def __init__(self) -> None:
        self.records: List[Dict[str, Any]] = []

    def record(self, step: int, kind: str, **detail: Any) -> None:
        rec = {"step": int(step), "kind": str(kind)}
        rec.update(detail)
        self.records.append(rec)

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for rec in self.records:
            out[rec["kind"]] = out.get(rec["kind"], 0) + 1
        return out

    def of_kind(self, kind: str) -> List[Dict[str, Any]]:
        return [r for r in self.records if r["kind"] == kind]
