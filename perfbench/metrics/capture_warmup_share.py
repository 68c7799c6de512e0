"""Share of the window in which the device waited on the host's eager
warm-ups of captures: over the crossing records of the captures begun in
the window (``window["crossings"]``), the host seconds of each warm-up
that fall inside its capture's device gap [``d0``, ``d1``], over the
window's seconds (as ``capture_gap_share``).  None where no capture fell
in the window or the run kept no crossing records."""


def read(run):
    w = run["window"]
    crossings = w.get("crossings")
    if not crossings or w["seconds"] <= 0:
        return None
    return 100.0 * sum(c["warmup_in_s"] for c in crossings) / w["seconds"]
