"""The capture-crossing shares: their readers' arithmetic on synthetic
runs, and ``run_tracer.py``'s additions around a tiny cell's run (on the
CPU, where the server captures nothing, and on the card)."""
import time

import pytest
import torch

from perfbench import harness, run, run_tracer
from perfbench import metrics as readers


def _crossing(gap, warm, rec):
    return {"gap_s": gap, "warmup_in_s": warm, "record_in_s": rec}


def test_crossing_shares():
    w = {"seconds": 10.0, "crossings": [_crossing(2.0, 0.5, 0.25),
                                        _crossing(1.0, 0.25, 0.5)]}
    run_ = {"window": w, "trace": None}
    assert readers.read("capture_gap_share", run_) == pytest.approx(30.0)
    assert readers.read("capture_warmup_share", run_) == pytest.approx(7.5)
    assert readers.read("capture_record_share", run_) == pytest.approx(7.5)
    # no capture in the window, no records kept, an empty window
    for window in ({"seconds": 10.0, "crossings": []}, {"seconds": 10.0},
                   dict(w, seconds=0.0)):
        for name in run_tracer.CROSSING_METRICS:
            assert readers.read(name, {"window": window}) is None


@pytest.fixture
def traced(monkeypatch):
    """``run_tracer``'s additions applied to the harness for one test."""
    for mod, names in ((harness, ("load_cell", "server_class", "Window",
                                  "run_cell")),
                       (readers, ("read",)), (run, ("T_PROCESS",))):
        for name in names:
            monkeypatch.setattr(mod, name, getattr(mod, name))
    run_tracer.patch(harness, readers, run)

    def go(cell, device):
        c = cell("tiny-dense", "tiny-decode")
        c["per_layer"] = [{"name": n, "unit": "%"}
                          for n in run_tracer.CROSSING_METRICS + (
                              "window_stall_share",)]
        return harness.run_cell(c, 5, 2.0, True, device, time.perf_counter())
    return go


def test_a_traced_run_keeps_the_servers_spans(cell, traced):
    out = traced(cell, "cpu")
    r, info = out["result"], out["info"]
    assert r["correct"], r["checks"]
    assert {"serve.replay"} <= set(info["spans"])
    assert info["spans"]["serve.replay"]["count"] > 0
    assert info["counters"]["epochs"] > 0 and info["spans_dropped"] == 0
    # the CPU captures nothing: no crossing, no share
    assert info["crossings"] == [] and info["counters"]["captures"] == 0
    assert not set(r["metrics"]) & set(run_tracer.CROSSING_METRICS)


@pytest.mark.gpu
def test_a_traced_run_on_the_card_splits_its_crossings(cell, traced):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = traced(cell, "cuda:0")
    r, info = out["result"], out["info"]
    assert r["correct"], r["checks"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(run_tracer.CROSSING_METRICS) <= set(m), m
    assert m["capture_warmup_share"] + m["capture_record_share"] <= \
        m["capture_gap_share"] + 0.5
    assert m["capture_gap_share"] <= m["window_stall_share"] + 0.5
    assert info["crossings"] and all(c["d0_ns"] <= c["d1_ns"]
                                     for c in info["crossings"])
