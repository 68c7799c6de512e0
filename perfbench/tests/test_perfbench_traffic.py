"""The traffic generator: a seed gives the same run; seeds differ only
in order and tokens; every arrival is sent inside the window."""
import math
from collections import Counter

import numpy as np

from perfbench.traffic import generator as gen

MIX = {"batch": 8,
       "sessions": {"per_instance": 1, "prompt_len": 256, "output_len": 1792},
       "arrivals": {"rate_per_s": 0.7,
                    "prompt_len": {"min": 512, "max": 2048, "grid": 256},
                    "output_len": 64}}


def _run(seed, seconds=40.0):
    return gen.Traffic(MIX, 3, 49155, seed, seconds)


def test_same_seed_same_schedule_and_prompts():
    a, b = _run(2 ** 31 + 7), _run(2 ** 31 + 7)
    assert [vars(r) for r in a.arrivals] == [vars(r) for r in b.arrivals]
    assert [vars(r) for r in a.sessions] == [vars(r) for r in b.sessions]
    for ra, rb in zip(a.sessions + a.arrivals, b.sessions + b.arrivals):
        assert np.array_equal(a.prompt(ra), b.prompt(rb))


def test_seeds_share_sizes_in_another_order():
    a, b = _run(11), _run(12)
    for field in ("prompt_len", "instance"):
        assert Counter(getattr(r, field) for r in a.arrivals) == \
            Counter(getattr(r, field) for r in b.arrivals)

    def gaps(t):
        sends = [0.0] + [r.send_s for r in t.arrivals]
        return sorted(round(y - x, 9) for x, y in zip(sends, sends[1:]))
    assert gaps(a) == gaps(b)
    assert [r.send_s for r in a.arrivals] != [r.send_s for r in b.arrivals]
    assert not np.array_equal(a.prompt(a.sessions[0]), b.prompt(b.sessions[0]))


def test_arrivals_inside_the_window_at_the_rate():
    t = _run(5, seconds=40.0)
    n = round(0.7 * 40.0)
    assert len(t.arrivals) == n
    assert all(0 < r.send_s < 40.0 for r in t.arrivals)
    assert math.isclose(t.arrivals[-1].send_s, 40.0 * (n - 0.5) / n)
    lens = {r.prompt_len for r in t.arrivals}
    assert lens <= set(range(512, 2049, 256)) and {512, 2048} <= lens
    assert len({r.index for r in t.sessions + t.arrivals}) == \
        len(t.sessions) + len(t.arrivals)


def test_closed_loop_sessions():
    t = _run(3)
    assert [r.instance for r in t.sessions] == [0, 1, 2]
    nxt = t.next_session(1)
    assert (nxt.instance, nxt.prompt_len, nxt.output_len) == (1, 256, 1792)
    assert nxt.index not in {r.index for r in t.sessions}
    p = t.prompt(nxt)
    assert p.shape == (8, 256) and p.dtype == np.int32
    assert 0 <= p.min() and p.max() < 49155
