"""Share of the traced slice's device time taken by the gather of the
routed experts' weights (``models/moe.py::_expert_rows``: ``wg[e]``,
``wu[e]``, ``wd[e]``, PyTorch's ``vectorized_gather_kernel``)."""
from perfbench import trace


def read(run):
    t = run["trace"]
    total = sum(t["kernel_s"].values()) if t else 0.0
    if total <= 0:
        return None
    secs = trace.seconds_matching(t["kernel_s"], "vectorized_gather_kernel")
    return 100.0 * secs / total if secs > 0 else None
