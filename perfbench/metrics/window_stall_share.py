"""Share of the window in which the device ran no replay of a served
program: the captures at each 128-token kv window (and at each change
of a bucket's members), with their eager warm-ups, and the host's
stalls.  Read as 1 - (the replays' device time) / window seconds; each
replay lies between two CUDA events on its stream (traced runs on the
card), and the profiler's own start and stop are out of the window."""


def read(run):
    w = run["window"]
    if not w.get("replay_s") or w["seconds"] <= 0:
        return None
    return 100.0 * (1.0 - w["replay_s"] / w["seconds"])
