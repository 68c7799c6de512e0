"""The comparison that decides ``correct``, on whole runs of tiny cells on
the CPU (the harness's look for a card skipped): sound runs pass, the
fp8 control fails its limits, and so does a run whose served path is
broken underneath, once for each fault a serving cell can have.  The
exchange between chips is not among them: every cell runs on one chip."""
import time

import pytest
import torch

from perfbench import harness


def _run(cell, seed=5, control=False, config="tiny-dense"):
    return harness.run_cell(cell(config, "tiny-decode"), seed, 1.5, False,
                            "cpu", time.perf_counter(), control=control)


@pytest.mark.parametrize("config", ["tiny-dense", "tiny-moe"])
def test_sound_runs_pass_and_the_control_fails(cell, config):
    out = _run(cell, control=True, config=config)
    checks = out["result"]["checks"]
    assert out["result"]["correct"], checks
    assert list(out["result"])[-1] == "checks"
    assert checks["replay_mismatch"]["value"] == 0
    limits = {k: c["limit"] for k, c in checks.items()
              if k in out["info"]["control"]}
    assert any(out["info"]["control"][k] > v for k, v in limits.items())
    assert not out["info"]["control_correct"], out["info"]["control_checks"]
    assert set(out["info"]["control_checks"]) == set(limits)


def _token_altered(monkeypatch):
    from repro_torch.launch.serve import MultiTenantServer
    feed = MultiTenantServer._feed

    def bad(self, t, toks, advance):
        return feed(self, t, (toks + 7) % t.cfg.vocab_size, advance)
    monkeypatch.setattr(MultiTenantServer, "_feed", bad)


def _state_unchanged(monkeypatch):
    from repro_torch.models import attention
    monkeypatch.setattr(attention, "_write_rows", lambda buf, pos, rows: None)


def _half_the_batch(monkeypatch):
    from repro_torch.models import model
    epoch = model.decode_epoch

    def bad(*a, **k):
        toks, caches = epoch(*a, **k)
        half = toks.shape[0] // 2
        toks = torch.cat([toks[:half], toks[:toks.shape[0] - half]])
        return toks, caches
    monkeypatch.setattr(model, "decode_epoch", bad)


@pytest.mark.parametrize("fault", [_token_altered, _state_unchanged,
                                   _half_the_batch])
def test_a_broken_served_path_is_not_correct(cell, monkeypatch, fault):
    fault(monkeypatch)
    out = _run(cell)
    assert not out["result"]["correct"], out["result"]["checks"]


def test_the_replay_check_sees_a_dispatch_unlike_the_model(cell,
                                                           monkeypatch):
    _token_altered(monkeypatch)
    out = _run(cell)
    assert out["result"]["checks"]["replay_mismatch"]["value"] > 0
    assert out["info"]["replay"]["steps"] > 0


@pytest.mark.parametrize("launches, ok", [
    ({"cache_matmul": 12, "cache_matmul.gemv": 12}, True),
    ({"cache_matmul": 12, "cache_matmul.gemv": 10,
      "cache_matmul.simt": 2}, False),
    ({"cache_matmul": 12, "cache_matmul.gemv": 12,
      "block_fused_ffn": 1, "block_fused_ffn.gemv": 1}, False),
    ({"cache_matmul": 0, "cache_matmul.gemv": 0}, False),
    ({"cache_matmul@4096x12800": 12}, False),
])
def test_the_launch_gate(launches, ok):
    checks = harness.launch_checks({"cache_matmul": ["gemv"]}, launches)
    assert set(checks) == {"launches.cache_matmul.gemv",
                           "launches_unexpected"}
    assert all(c["value"] >= c["limit"] if c.get("min")
               else c["value"] <= c["limit"]
               for c in checks.values()) is ok


def test_a_gate_of_no_kernels_takes_no_launch():
    assert harness.launch_checks({}, {"flash_attention": 0})[
        "launches_unexpected"]["value"] == 0
    assert harness.launch_checks({}, {"flash_attention": 2})[
        "launches_unexpected"]["value"] == 2


@pytest.mark.gpu
def test_a_tiny_cell_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = harness.run_cell(cell("tiny-dense", "tiny-decode"), 5, 2.0, True,
                           "cuda:0", time.perf_counter())
    r = out["result"]
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0


def test_an_arrivals_mix_reports_its_ttft(cell):
    """The open-loop path a data-only arrivals cell would take: arrivals
    are sent on the wall clock, timed from their send, sampled for the
    reference, and the warm-up arrival leaves before the window."""
    out = harness.run_cell(cell("tiny-dense", "tiny-arrivals"), 9, 3.0,
                           False, "cpu", time.perf_counter())
    r, info = out["result"], out["info"]
    assert r["correct"], r["checks"]
    assert info["window"]["arrivals"] == round(4.0 * 3.0)
    assert len(info["ttft_s"]) == 12 and min(info["ttft_s"]) > 0
    assert r["metrics"]["ttft_mean_s"]["value"] > 0
    kinds = [q["kind"] for q in info["reference"]]
    assert kinds.count("arrival") == 2 and kinds.count("session") == 2
