"""The server's tracer (``launch/spans.py``) and counters on the CPU.

A pipelined run of reduced yi-9b tenants (two residents and an arrival
with a prompt) with the tracer off records nothing and serves the same
tokens, bitwise, as the same run with it on; on, its spans form a tree
whose request spans carry their tenants.  The device's side (crossing
records, the clock) runs on the card only: its arithmetic is held here
on fake events, the card's own in ``tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest

from repro_torch.launch import serve as PS
from repro_torch.launch import spans
from repro_torch.sim.driver import TenantSpec

SERVER = dict(batch=1, max_len=128, epoch_len=4, total_pages=32,
              device="cpu")
ARRIVAL = dict(arrive_at=2.0, prompt_len=64, n_inferences=8)
STEPS = 12
REQUEST_SPANS = {"serve.admit", "serve.prefill_chunk", "serve.replay"}
COUNTERS = {"captures", "capture_s", "warmups", "warmup_s", "record_s",
            "first_replay_s", "epochs", "sched_wall_s", "dispatch_wall_s",
            "admit_wall_s"}


def _server():
    return PS.MultiTenantServer(["yi-9b", "yi-9b"],
                                tenants=[TenantSpec("yi-9b", **ARRIVAL)],
                                **SERVER)


@pytest.fixture(scope="module")
def runs():
    """(server, run()) with the tracer off, then on; the off run fails if
    it opens a span or marks the device."""
    off = _server()

    def refuse(*a, **k):
        raise AssertionError("the tracer recorded while off")
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(spans.Span, "__enter__", refuse)
        for name in ("event", "crossing"):
            mp.setattr(spans.Tracer, name, refuse)
        off_out = off.run(steps=STEPS)
    finally:
        mp.undo()
    on = _server()
    on.tracer.start()
    return (off, off_out), (on, on.run(steps=STEPS))


def test_tracer_off_records_nothing_and_on_serves_the_same_tokens(runs):
    (off, off_out), (on, on_out) = runs
    assert not off.tracer.on
    assert off.tracer.spans() == [] and off.tracer.crossings() == []
    assert on.tracer.spans()
    assert off_out["tenants"].keys() == on_out["tenants"].keys()
    for tid, o in off_out["tenants"].items():
        assert o["tokens"] > 0
        np.testing.assert_array_equal(o["output"],
                                      on_out["tenants"][tid]["output"],
                                      err_msg=tid)


def test_span_tree_is_well_formed(runs):
    _, (on, _) = runs
    tr = on.tracer
    got = tr.spans()
    ids = [s["id"] for s in got]
    assert len(set(ids)) == len(ids) and tr.dropped == 0
    by_id = {s["id"]: s for s in got}
    for s in got:
        assert s["name"] in REQUEST_SPANS
        assert s["tids"], s
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] is not None:
            p = by_id[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
    assert {s["name"] for s in got} == REQUEST_SPANS
    # the arrival's spans share its tenant id, from admission on
    arrival = next(t.tid for t in on.tenants if t.prompt_len)
    mine = {s["name"] for s in got if arrival in s["tids"]}
    assert mine == REQUEST_SPANS
    # a chunk's replay lies inside its chunk; a bucket's names its tenants
    for s in got:
        if s["name"] == "serve.replay" and s["kind"] == "prefill":
            assert by_id[s["parent"]]["name"] == "serve.prefill_chunk"
        if s["kind"] == "bucket":
            assert len(s["tids"]) == 2
    # self time: each span's length less its children's
    want = {}
    for s in got:
        kids = sum(c["end_ns"] - c["start_ns"] for c in got
                   if c["parent"] == s["id"])
        d = want.setdefault(s["name"], [0, 0, 0])
        d[0] += 1
        d[1] += s["end_ns"] - s["start_ns"]
        d[2] += s["end_ns"] - s["start_ns"] - kids
    summary = tr.summary()
    assert summary.keys() == want.keys()
    for name, (n, total, self_ns) in want.items():
        assert summary[name]["count"] == n
        assert summary[name]["total_s"] == pytest.approx(total * 1e-9)
        assert summary[name]["self_s"] == pytest.approx(self_ns * 1e-9)
    assert summary["serve.prefill_chunk"]["self_s"] < \
        summary["serve.prefill_chunk"]["total_s"]


def test_spans_past_the_limit_are_dropped_whole():
    tr = spans.Tracer("cpu", limit=2)
    tr.start()
    with tr.span("a", ("t0",)):
        with tr.span("b", ("t0",)):
            with tr.span("c", ("t0",)):
                pass
        with tr.span("d"):
            pass
    assert [s["name"] for s in tr.spans()] == ["a", "b"]
    assert tr.dropped == 2
    assert tr.spans()[1]["parent"] == tr.spans()[0]["id"]


class _Event:
    """A timing event the device passed ``ms`` after some origin."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms

    def synchronize(self):
        pass


def test_device_marks_on_the_host_clock(monkeypatch):
    """An event's host time is the reference's plus the device time
    between them; a crossing's gap is split by the host spans inside it."""
    ms = 1_000_000
    tr = spans.Tracer("cpu")
    tr.on = True
    tr._ref, tr._ref_ns = _Event(5.0), 1_000 * ms
    assert tr.host_ns(_Event(5.0)) == 1_000 * ms
    assert tr.host_ns(_Event(7.25)) == 1_002 * ms + 250_000
    marks = iter([_Event(15.0), _Event(45.0)])      # host 1010 ms, 1040 ms
    monkeypatch.setattr(tr, "event", lambda: next(marks))
    rec = tr.crossing("bucket", ("t0", "t1"))
    # the warm-up straddles d0, the recording lies inside, the first
    # replay after d1
    for name, a, b in ((spans.WARMUP, 1_000, 1_020),
                       (spans.RECORD, 1_025, 1_035),
                       (spans.FIRST_REPLAY, 1_040, 1_041)):
        sp = tr.span(name, crossing=rec)
        sp.start_ns, sp.end_ns = a * ms, b * ms
    assert tr.crossings() == []                 # not replayed yet
    rec.d1 = tr.event()
    (c,) = tr.crossings()
    assert (c["d0_ns"], c["d1_ns"]) == (1_010 * ms, 1_040 * ms)
    assert c["kind"] == "bucket" and c["tids"] == ["t0", "t1"]
    assert c["gap_s"] == pytest.approx(0.030)
    assert c["warmup_in_s"] == pytest.approx(0.010)
    assert c["record_in_s"] == pytest.approx(0.010)
    assert (c["warmup_s"], c["record_s"], c["first_replay_s"]) == \
        pytest.approx((0.020, 0.010, 0.001))
    # only the captures that began in the window
    assert tr.crossings(since_ns=rec.compile_ns + 1) == []
    assert tr.crossings(until_ns=rec.compile_ns) == [c]


def test_counters_keep_their_keys_and_only_grow():
    srv = _server()
    seen = [srv.counters()]
    outs = []
    for _ in range(2):
        outs.append(srv.run(steps=4))
        seen.append(srv.counters())
    for a, b in zip(seen, seen[1:]):
        assert a.keys() == b.keys() == COUNTERS
        assert all(b[k] >= a[k] for k in COUNTERS), (a, b)
    assert seen[-1]["epochs"] > seen[1]["epochs"] > 0
    for out, a, b in zip(outs, seen, seen[1:]):
        h = out["host"]
        assert h["epochs"] == b["epochs"] - a["epochs"] == \
            len(h["epoch_compiles"])
        for k in ("sched_wall_s", "dispatch_wall_s", "admit_wall_s"):
            assert h[k] == pytest.approx(b[k] - a[k])
        assert "device_wall_s" not in h and "epoch_sched_walls" not in h
    # perfbench's harness sums the scheduling wall
    assert sum(srv._sched_walls) == seen[-1]["sched_wall_s"]
