"""The device trace of a traced run: ``torch.profiler`` (CUPTI) over a
steady slice of the window, reduced to what the per-layer readers and
the result's ``breakdown`` need.

The profiler runs only over the slice, which starts and ends with the
device synchronised, so the slice's length is the host clock's and every
device activity in the trace lies inside it.  Busy time is the union of
every device activity (kernels, copies, sets); an idle gap is a stretch
between two of them, labelled by the innermost host event at its
middle, where two marks (``perfbench.slice.start`` / ``.stop``) show the trace's
host clock agreeing with the slice's: a span the harness records around the
server's calls (``serve.*``), a runtime call, an operator, or, where no
traced event covers it, the host's own Python.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Tuple

START, STOP = "perfbench.slice.start", "perfbench.slice.stop"
PYTHON = "host python (no traced call)"
UNALIGNED = "host (the trace's host clock disagrees with the slice)"
OVERHEAD = ("Buffer Flush", "Command Buffer Full", "Activity Buffer Request")


def _ns(e, which: str) -> int:
    return int(getattr(e, f"{which}_ns")())


def _is_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def _skipped(e) -> bool:
    """Not work: the profiler's own overhead records and the device-side
    copies of host spans (user annotations)."""
    kind = str(getattr(e, "activity_type", lambda: "")()).lower()
    name = e.name()
    if name in OVERHEAD or "overhead" in kind:
        return True
    return _is_device(e) and ("annotation" in kind or name.startswith(
        ("serve.", "perfbench.")))


def summarize(prof, window_s: float) -> Dict[str, Any]:
    """Reduce a profiler stopped at the end of a slice of ``window_s``
    host seconds (the device synchronised at both ends, so every device
    activity in the trace lies inside it) to device seconds by operation
    name, busy seconds and the ten longest idle gaps between two device
    activities, each labelled by what the host was doing."""
    events = prof.profiler.kineto_results.events()
    marks = {e.name(): _ns(e, "start") for e in events
             if not _is_device(e) and e.name() in (START, STOP)}
    if len(marks) != 2:
        raise RuntimeError(f"the trace lacks its marks {START} / {STOP}")
    dev: List[Tuple[int, int, str]] = []
    host: List[Tuple[int, int, str]] = []
    for e in events:
        if e.name() in (START, STOP) or _skipped(e):
            continue
        (dev if _is_device(e) else host).append(
            (_ns(e, "start"), _ns(e, "end"), e.name()))
    by_name: Dict[str, float] = defaultdict(float)
    for s, t, n in dev:
        by_name[n] += (t - s) * 1e-9
    dev.sort()
    merged: List[List[int]] = []
    for s, t, _ in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged) * 1e-9
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    gaps.sort(key=lambda g: g[0] - g[1])
    # the host's events carry the trace's clock only where its span of the
    # slice agrees with the host's own
    span = (marks[STOP] - marks[START]) * 1e-9
    aligned = abs(span - window_s) <= 0.1 * window_s
    return {"window_s": window_s, "busy_s": busy, "kernel_s": dict(by_name),
            "idle_gaps": [[_label(g, host) if aligned else UNALIGNED,
                           (g[1] - g[0]) * 1e-9] for g in gaps[:10]]}


def _label(gap: Tuple[int, int], host: List[Tuple[int, int, str]]) -> str:
    """The innermost host event at the middle of ``gap`` (the shortest that
    spans it), or :data:`PYTHON`."""
    mid = (gap[0] + gap[1]) // 2
    spans = [(t - s, n) for s, t, n in host if s <= mid <= t]
    return min(spans)[1] if spans else PYTHON


def mark(name: str) -> None:
    """An empty host span: a point on the trace's clock."""
    from torch.profiler import record_function
    with record_function(name):
        pass


def top_ops(kernel_s: Dict[str, float], n: int = 10) -> List[List[Any]]:
    """The ``n`` device operations that took most time, [name, seconds]."""
    return [[k, v] for k, v in sorted(kernel_s.items(),
                                      key=lambda kv: -kv[1])[:n]]


def seconds_matching(kernel_s: Dict[str, float], *needles: str) -> float:
    """Device seconds of the operations whose name holds any needle."""
    return sum(v for k, v in kernel_s.items()
               if any(x in k for x in needles))
