"""cache_matmul's gemv kind against its roofline in the traced slice:
the bytes its launches must move (each B [K, N] of the launch counters'
weight shapes, and A and C at the cell's decode rows) at the card's
bandwidth, over the device time of the gemv kernels (``gemv_kernel``
and its split-K ``gemv_reduce``).  Nothing where no gemv ran, or where
cache_matmul also ran another kind (its bytes could not be told
apart)."""
from perfbench import roofline, trace


def read(run):
    t = run["trace"]
    if not t:
        return None
    n = t["launches"]
    gemv, total = n.get("cache_matmul.gemv", 0), n.get("cache_matmul", 0)
    if gemv == 0 or gemv != total:
        return None
    rows = run["batch"]
    nbytes = 0
    for key, count in n.items():
        if key.startswith("cache_matmul@"):
            k, nn = (int(x) for x in key.split("@", 1)[1].split("x"))
            nbytes += count * roofline.gemv_bytes(rows, k, nn)
    secs = trace.seconds_matching(t["kernel_s"], "gemv_kernel", "gemv_reduce")
    if secs <= 0:
        return None
    return 100.0 * nbytes / roofline.HBM_BYTES_PER_S / secs
