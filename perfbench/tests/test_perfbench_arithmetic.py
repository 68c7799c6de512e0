"""The FLOP count (the gqa_swiglu family's), roofline, mfu and trace
arithmetic, on synthetic numbers and a synthetic trace."""
import math
import types

import pytest

from perfbench import metrics as readers
from perfbench import roofline, trace
from perfbench.families import gqa_swiglu

ARCH = {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
        "d_ff": 96, "vocab_size": 100, "num_experts": 0}


def test_span_flops_sums_its_tokens():
    per_token = gqa_swiglu.matmul_flops_per_token(ARCH)
    d, hd = 64, 16
    attn = 2 * (d * 4 * hd + 2 * d * 2 * hd + 4 * hd * d)
    assert per_token == 2 * 2 * (attn // 2 + 3 * d * 96) + 2 * d * 100
    want = sum(per_token + 4 * 2 * 4 * hd * (p + 1) for p in range(5, 17))
    assert gqa_swiglu.span_flops(ARCH, 5, 17) == want
    assert gqa_swiglu.span_flops(ARCH, 7, 7) == 0


def test_moe_counts_routed_experts_only():
    moe = dict(ARCH, num_experts=8, experts_per_token=2, d_ff=32)
    dense = dict(ARCH, d_ff=2 * 32)
    extra = 2 * 2 * 64 * 8           # the router, both layers
    assert gqa_swiglu.matmul_flops_per_token(moe) == \
        gqa_swiglu.matmul_flops_per_token(dense) + extra


def test_gemv_bytes_and_roofline_reader():
    assert roofline.gemv_bytes(8, 4096, 12800) == 2 * (4096 * 12800 + 8 * 4096
                                                        + 8 * 12800)
    launches = {"cache_matmul": 3, "cache_matmul.gemv": 3,
                "cache_matmul@4096x12800": 2, "cache_matmul@12800x4096": 1}
    nbytes = 2 * roofline.gemv_bytes(8, 4096, 12800) + \
        roofline.gemv_bytes(8, 12800, 4096)
    secs = nbytes / roofline.HBM_BYTES_PER_S / 0.5     # at half the roofline
    run = {"batch": 8, "trace": {"launches": launches, "kernel_s": {
        "void repro::gemv_kernel<8>(...)": secs * 0.9,
        "repro::gemv_reduce(...)": secs * 0.1, "other": 1.0}}}
    assert readers.read("gemv_roofline", run) == pytest.approx(50.0)
    run["trace"]["launches"]["cache_matmul"] = 4          # another kind ran
    assert readers.read("gemv_roofline", run) is None


def test_mfu_and_window_shares():
    w = {"seconds": 10.0, "flops": 0.01 * 10.0 * roofline.PEAK_BF16_FLOPS,
         "sched_s": 0.5, "tenant_steps": 300, "replay_s": 7.5}
    t = {"window_s": 2.0, "busy_s": 1.5, "tenant_steps": 60,
         "kernel_s": {"a": 1.0, "vectorized_gather_kernel<16>": 0.5}}
    run = {"window": w, "trace": t}
    assert readers.read("mfu", run) == pytest.approx(1.0)
    assert readers.read("sched_share", run) == pytest.approx(5.0)
    assert readers.read("idle_share", run) == pytest.approx(25.0)
    assert readers.read("decode_device_ms_per_step", run) == pytest.approx(25.0)
    assert readers.read("expert_gather_share", run) == pytest.approx(100 / 3)
    # replays ran 7.5 s of the 10 s window
    assert readers.read("window_stall_share", run) == pytest.approx(25.0)
    run["trace"] = None
    run["window"]["replay_s"] = None
    for name in ("idle_share", "decode_device_ms_per_step", "gemv_roofline",
                 "expert_gather_share", "window_stall_share"):
        assert readers.read(name, run) is None


class _Ev:
    def __init__(self, name, start, end, device, kind=""):
        self._v = (name, start, end, device, kind)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[3] else "DeviceType.CPU"

    def activity_type(self):
        return self._v[4]


def _prof(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


def test_trace_busy_gaps_and_labels():
    ms = 1_000_000
    ev = [_Ev(trace.START, 0, 1, False), _Ev(trace.STOP, 100 * ms, 100 * ms, False),
          _Ev("k1", 0, 30 * ms, True), _Ev("k2", 20 * ms, 40 * ms, True),
          _Ev("k1", 70 * ms, 90 * ms, True),
          _Ev("serve.compile", 40 * ms, 70 * ms, True, "gpu_user_annotation"),
          _Ev("Buffer Flush", 45 * ms, 46 * ms, False),
          _Ev("serve.dispatch_epoch", 35 * ms, 75 * ms, False, "user_annotation"),
          _Ev("serve.compile", 41 * ms, 69 * ms, False, "user_annotation")]
    s = trace.summarize(_prof(ev), 0.1)
    assert s["busy_s"] == pytest.approx(0.060)
    assert s["kernel_s"] == pytest.approx({"k1": 0.050, "k2": 0.020})
    assert s["idle_gaps"] == [["serve.compile", pytest.approx(0.030)]]
    assert trace.top_ops(s["kernel_s"])[0] == ["k1", pytest.approx(0.05)]
    # a host clock that disagrees with the slice labels nothing
    s = trace.summarize(_prof(ev), 0.5)
    assert s["idle_gaps"][0][0] == trace.UNALIGNED
    assert math.isclose(1 - s["busy_s"] / s["window_s"], 0.88)
