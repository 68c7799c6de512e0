"""Run one cell as ``perfbench/run.py`` does, with the server's own tracer
on (``repro_torch.launch.spans``).

    python3 perfbench/run_tracer.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The harness does not start the program's tracer.  This applies, around
the unchanged harness, the three additions that reading the captures'
crossings needs: the tracer started in set-up (as the server is made),
``server.counters()`` in every state the window records, and the
crossing records of the captures begun between the window's open and
close as ``run["window"]["crossings"]``.  A traced run (``--trace 1``)
then reports ``capture_gap_share``, ``capture_warmup_share`` and
``capture_record_share`` beside the cell's per-layer metrics, and the
profiled slice holds the server's spans.  With ``--trace 0`` the metrics
are the end-to-end ones, with the tracer on: against ``run.py``'s
untraced runs, its cost.  The info line gains ``crossings`` (the
table), ``spans`` (count, total and self seconds by name in the window),
``counters`` (their change across the window) and ``clock_error_ns``
(host minus tracer time of device events waited for, at the tracer's
start and after the run).
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path.cwd()
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

CROSSING_METRICS = ("capture_gap_share", "capture_warmup_share",
                    "capture_record_share")
PROBES = 32


def clock_error_ns(tracer) -> dict:
    """``perf_counter_ns`` read as each of ``PROBES`` events is waited
    for, less the tracer's host time of the event: the host's wake-up
    after an event, against the reference's, plus the clocks' drift."""
    errs = []
    for _ in range(PROBES):
        ev = tracer.event()
        ev.synchronize()
        errs.append(time.perf_counter_ns() - tracer.host_ns(ev))
    return {"min": min(errs), "median": statistics.median(errs),
            "max": max(errs)}


def patch(harness, readers, run) -> dict:
    """Wrap the harness's entry points with the three additions; returns
    the state they share (the window, the tracer, the clock probes)."""
    state: dict = {}
    load_cell, server_class = harness.load_cell, harness.server_class
    run_cell, read, Window = harness.run_cell, readers.read, harness.Window

    def bounds():
        w = state["window"]
        return int(w.open["pc"] * 1e9), int(w.close["pc"] * 1e9)

    def traced_load_cell(name, path):
        cell = load_cell(name, path)
        have = {m["name"] for m in cell["per_layer"]}
        cell["per_layer"] += [{"name": n, "unit": "%"}
                              for n in CROSSING_METRICS if n not in have]
        return cell

    def traced_server_class():
        class Traced(server_class()):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                self.tracer.start()
                state["tracer"] = self.tracer
                if self.device.type == "cuda":
                    state["clock_start"] = clock_error_ns(self.tracer)
        return Traced

    class CountedWindow(Window):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            state["window"] = self

        def _state(self, server):
            out = super()._state(server)
            out["counters"] = server.counters()
            return out

    def traced_read(name, run_):
        if "crossings" not in run_["window"]:
            run_["window"]["crossings"] = state["tracer"].crossings(*bounds())
        return read(name, run_)

    def traced_run_cell(*a, **k):
        out = run_cell(*a, **k)
        w, tr = state["window"], state["tracer"]
        lo, hi = bounds()
        info = out["info"]
        info["crossings"] = tr.crossings(lo, hi)
        info["spans"] = tr.summary(lo, hi)
        info["counters"] = {n: w.close["counters"][n] - w.open["counters"][n]
                            for n in w.close["counters"]}
        if tr.device.type == "cuda":
            info["clock_error_ns"] = {"start": state["clock_start"],
                                      "end": clock_error_ns(tr)}
        info["spans_dropped"] = tr.dropped
        return out

    harness.load_cell, harness.server_class = traced_load_cell, \
        traced_server_class
    harness.Window, harness.run_cell = CountedWindow, traced_run_cell
    readers.read = traced_read
    run.T_PROCESS = T_PROCESS
    return state


def main(argv=None) -> int:
    from perfbench import harness, run
    from perfbench import metrics as readers
    patch(harness, readers, run)
    return run.main(argv)


if __name__ == "__main__":
    sys.exit(main())
