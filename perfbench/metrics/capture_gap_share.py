"""Share of the window in which the device waited across the captures of
served programs: over the crossing records of the captures begun in the
window (``window["crossings"]``, from the server's tracer), the sum of
``d1 - d0``, from the device finishing the work queued before a capture
to its reaching the new program's first replay, over the window's
seconds (the profiler's own start and stop out, as
``window_stall_share`` has them).  None where no capture fell in the
window or the run kept no crossing records."""


def read(run):
    w = run["window"]
    crossings = w.get("crossings")
    if not crossings or w["seconds"] <= 0:
        return None
    return 100.0 * sum(c["gap_s"] for c in crossings) / w["seconds"]
