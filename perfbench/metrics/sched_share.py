"""Share of the window's wall time the server's host spent planning
epochs (the change in ``sched_wall_s``: grants, plans, buckets;
admission apart)."""


def read(run):
    w = run["window"]
    if w["seconds"] <= 0:
        return None
    return 100.0 * w["sched_s"] / w["seconds"]
