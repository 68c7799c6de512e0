"""Device time per tenant-step of decode in the traced slice: every
device operation's time (the decode cells run nothing else once warm)
over the decode steps of every tenant in the slice."""


def read(run):
    t = run["trace"]
    busy = sum(t["kernel_s"].values()) if t else 0.0
    if not t or t["tenant_steps"] <= 0 or busy <= 0:
        return None
    return 1e3 * busy / t["tenant_steps"]
