"""The server's tracer: spans of its host work and marks on the device,
on one clock.

One :class:`Tracer` per server (``MultiTenantServer.tracer``), off until
:meth:`Tracer.start`.  Off, a span site checks ``tracer.on`` and records
nothing: no span, no device event, no ``record_function``.  On, each
span is kept in memory (at most ``limit``; later ones are dropped and
counted) with its name, start and end on ``time.perf_counter_ns()``,
its own id, the id of the span open around it (its cause), the ids of
the tenants it serves and a kind; each is also a
``torch.profiler.record_function``, so inside a profiler's slice the
server's spans label the device's idle gaps.

The device joins the host's clock at :meth:`Tracer.start`: it drains
the device, records a reference event, waits for it and reads
``perf_counter_ns`` at once.  A later timing event then lies at the
reference's host time plus ``reference.elapsed_time(event)``
(:meth:`Tracer.host_ns`), wrong by the host's wake-up after the
reference (the wait's return) plus the two clocks' drift since.

A capture of a server program leaves one :class:`Crossing`: ``d0``, an
event on the serving stream as the capture begins (the device has
finished everything queued before it), ``d1``, one just before the
program's first replay (the device has reached the new program), and
the capture's warm-up, recording and first-replay spans.
:meth:`Tracer.crossings` puts each on the host clock and splits the
device's gap ``d1 - d0`` by what the host was doing in it.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

import torch

LIMIT = 1 << 18          # spans (and crossings) kept while on
OFF = contextlib.nullcontext()     # the span of a site whose tracer is off
WARMUP, RECORD, FIRST_REPLAY = ("serve.capture.warmup", "serve.capture.record",
                                "serve.capture.first_replay")


class Span:
    """One interval of host work; a context manager that opens and
    closes it on its tracer."""

    __slots__ = ("tracer", "id", "parent", "name", "tids", "kind",
                 "start_ns", "end_ns", "_rf")

    def __init__(self, tracer: "Tracer", name: str, tids: Tuple[str, ...],
                 kind: Optional[str]):
        self.tracer, self.name, self.tids, self.kind = tracer, name, tids, kind
        self.id = self.parent = None
        self.start_ns = self.end_ns = None
        self._rf = None

    def __enter__(self) -> "Span":
        tr = self.tracer
        self.parent = tr._open[-1].id if tr._open else None
        self.id = tr._next_id
        tr._next_id += 1
        if len(tr._spans) < tr.limit:
            tr._spans.append(self)
        else:
            tr.dropped += 1
        tr._open.append(self)
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()
        self._rf.__exit__(*exc)
        self._rf = None
        self.tracer._open.pop()

    def as_dict(self) -> Dict[str, Any]:
        return {"id": self.id, "parent": self.parent, "name": self.name,
                "tids": list(self.tids), "kind": self.kind,
                "start_ns": self.start_ns, "end_ns": self.end_ns}


class Crossing:
    """One capture: its device marks and its host spans (by name)."""

    __slots__ = ("kind", "tids", "compile_ns", "d0", "d1", "spans")

    def __init__(self, kind: str, tids: Tuple[str, ...], compile_ns: int,
                 d0: Any):
        self.kind, self.tids, self.compile_ns = kind, tids, compile_ns
        self.d0, self.d1 = d0, None
        self.spans: Dict[str, Span] = {}


def _inside(span: Optional[Span], lo: int, hi: int) -> float:
    """Seconds of ``span`` that lie in [lo, hi] (ns)."""
    if span is None or span.end_ns is None:
        return 0.0
    return max(0, min(span.end_ns, hi) - max(span.start_ns, lo)) * 1e-9


def _seconds(span: Optional[Span]) -> float:
    if span is None or span.end_ns is None:
        return 0.0
    return (span.end_ns - span.start_ns) * 1e-9


class Tracer:
    """Spans and device marks of one server, off until :meth:`start`."""

    def __init__(self, device: Any, limit: int = LIMIT):
        self.device = torch.device(device)
        self.limit = int(limit)
        self.on = False
        self.dropped = 0
        self._spans: List[Span] = []
        self._open: List[Span] = []
        self._next_id = 0
        self._crossings: List[Crossing] = []
        self._ref = None            # the reference event (card only)
        self._ref_ns = 0            # its host time

    def start(self) -> None:
        """Turn tracing on; on the card, tie the device's clock to the
        host's first (see the module docstring)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            ref = torch.cuda.Event(enable_timing=True)
            ref.record(torch.cuda.current_stream(self.device))
            ref.synchronize()
            self._ref_ns = time.perf_counter_ns()
            self._ref = ref
        self.on = True

    # ------------------------------------------------------------ clock --
    def host_ns(self, event: Any) -> int:
        """The host time (``perf_counter_ns``) at which the device reached
        ``event``, a timing event recorded after :meth:`start` that the
        device has passed."""
        return self._ref_ns + round(self._ref.elapsed_time(event) * 1e6)

    def event(self) -> Any:
        """A timing event, recorded now on the current stream."""
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    # ------------------------------------------------------------ spans --
    def span(self, name: str, tids: Tuple[str, ...] = (),
             kind: Optional[str] = None,
             crossing: Optional[Crossing] = None) -> Span:
        """A span to open with ``with``; one of a capture's spans when
        ``crossing`` is given (its tenants and kind)."""
        if crossing is None:
            return Span(self, name, tuple(tids), kind)
        sp = Span(self, name, crossing.tids, crossing.kind)
        crossing.spans[name] = sp
        return sp

    def spans(self) -> List[Dict[str, Any]]:
        """Every span kept, in the order they opened (``end_ns`` None for
        one still open)."""
        return [s.as_dict() for s in self._spans]

    def summary(self, since_ns: int = 0,
                until_ns: Optional[int] = None) -> Dict[str, Dict[str, Any]]:
        """By name, over the closed spans that open in [since, until]:
        their count, total seconds and self seconds (each span's length
        less its children's)."""
        until = until_ns if until_ns is not None else time.perf_counter_ns()
        closed = [s for s in self._spans if s.end_ns is not None]
        children: Dict[int, int] = defaultdict(int)
        for s in closed:
            if s.parent is not None:
                children[s.parent] += s.end_ns - s.start_ns
        out: Dict[str, Dict[str, Any]] = {}
        for s in closed:
            if not since_ns <= s.start_ns <= until:
                continue
            d = out.setdefault(s.name, {"count": 0, "total_s": 0.0,
                                        "self_s": 0.0})
            length = s.end_ns - s.start_ns
            d["count"] += 1
            d["total_s"] += length * 1e-9
            d["self_s"] += (length - children[s.id]) * 1e-9
        return out

    # -------------------------------------------------------- crossings --
    def crossing(self, kind: str, tids: Tuple[str, ...]) -> Crossing:
        """A capture begins: its record, with ``d0`` recorded now."""
        rec = Crossing(kind, tuple(tids), time.perf_counter_ns(),
                       self.event())
        if len(self._crossings) < self.limit:
            self._crossings.append(rec)
        else:
            self.dropped += 1
        return rec

    def crossings(self, since_ns: int = 0,
                  until_ns: Optional[int] = None) -> List[Dict[str, Any]]:
        """Every capture that began in [since, until] and has replayed,
        on the host clock: ``d0_ns``, ``d1_ns`` and the gap between them
        (``gap_s``), the host seconds of its warm-up and recording inside
        the gap (``warmup_in_s``, ``record_in_s``) and whole
        (``warmup_s``, ``record_s``, ``first_replay_s``).  Waits for the
        device to pass each mark."""
        until = until_ns if until_ns is not None else time.perf_counter_ns()
        out = []
        for c in self._crossings:
            if c.d1 is None or not since_ns <= c.compile_ns <= until:
                continue
            c.d0.synchronize()
            c.d1.synchronize()
            d0, d1 = self.host_ns(c.d0), self.host_ns(c.d1)
            warm, rec = c.spans.get(WARMUP), c.spans.get(RECORD)
            out.append({"kind": c.kind, "tids": list(c.tids),
                        "compile_ns": c.compile_ns, "d0_ns": d0,
                        "d1_ns": d1, "gap_s": (d1 - d0) * 1e-9,
                        "warmup_in_s": _inside(warm, d0, d1),
                        "record_in_s": _inside(rec, d0, d1),
                        "warmup_s": _seconds(warm), "record_s": _seconds(rec),
                        "first_replay_s": _seconds(
                            c.spans.get(FIRST_REPLAY))})
        return out
