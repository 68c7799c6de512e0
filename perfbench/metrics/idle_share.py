"""Share of the traced slice in which no operation ran on the device
(torch.profiler's device activity against the slice's host clock)."""


def read(run):
    t = run["trace"]
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
