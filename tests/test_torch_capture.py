"""The server's capture path on the CPU: the eager warm-up is kept per
warm-up key (``launch/serve.py::_warmup_key``), the program key without
its kv window, so a later kv window of a warmed key is recorded at once.

The CPU captures nothing, so the capture test stubs the CUDA stream,
graph and capture calls: a stub "recording" runs the program and puts
back every tenant buffer it wrote (a real recording runs nothing), and a
stub "replay" runs the program.  The card's own captures are held in
``tests/test_torch_gpu.py``.
"""
import contextlib
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.core.vmem import LANE
from repro_torch.launch import serve as PS
from repro_torch.sim.driver import TenantSpec

SERVER = dict(batch=1, max_len=1024, epoch_len=4, total_pages=64,
              device="cpu")
# a prompt of chunks 256, 256 and 188 (kv windows 256, 512 and 768),
# arriving after the residents' first window
ARRIVAL = dict(arrive_at=140.0, prompt_len=700, n_inferences=40)
STEPS = 400          # the residents' kv windows 128 to 512


def _tenant(arch="yi-9b", kv_dtype="native"):
    return types.SimpleNamespace(cfg=types.SimpleNamespace(name=arch),
                                 kv_dtype=kv_dtype)


def test_warmup_key_drops_the_kv_window_and_tenant_ids():
    pair = [_tenant(), _tenant()]
    base = PS._warmup_key(("bucket", "yi-9b", "LWM@32p", 4, 128,
                           ("t0", "t1")), pair)
    assert base == ("bucket", "yi-9b", "LWM@32p", 4, 2, "native")
    for kv in (256, 384, 2048):
        assert PS._warmup_key(("bucket", "yi-9b", "LWM@32p", 4, kv,
                               ("t2", "t3")), pair) == base
    # each of kind, arch, plan, k, bucket size and KV dtype splits it
    splits = [
        PS._warmup_key(("single", "yi-9b", "LWM@32p", 4, 128, ("t0",)),
                       pair[:1]),
        PS._warmup_key(("bucket", "granite-3-8b", "LWM@32p", 4, 128,
                        ("t0", "t1")), [_tenant("granite-3-8b")] * 2),
        PS._warmup_key(("bucket", "yi-9b", "LBM@456p", 4, 128,
                        ("t0", "t1")), pair),
        PS._warmup_key(("bucket", "yi-9b", "LWM@32p", 2, 128,
                        ("t0", "t1")), pair),
        PS._warmup_key(("bucket", "yi-9b", "LWM@32p", 4, 128,
                        ("t0", "t1", "t2")), pair + [_tenant()]),
        PS._warmup_key(("bucket", "yi-9b", "LWM@32p", 4, 128,
                        ("t0", "t1")), [_tenant(kv_dtype="int8")] * 2),
    ]
    assert len({base, *splits}) == 1 + len(splits)
    # prompt chunks (tid, chunk, kv): one key across kv windows and
    # tenants of an arch and KV dtype, one per chunk length
    chunk = PS._warmup_key(("t0:yi-9b", 256, 256), pair[:1])
    assert chunk == ("prefill", "yi-9b", "native", 256)
    assert PS._warmup_key(("t5:yi-9b", 256, 1024), pair[:1]) == chunk
    assert PS._warmup_key(("t0:yi-9b", 44, 384), pair[:1]) != chunk
    assert PS._warmup_key(("t0:yi-9b", 256, 256),
                          [_tenant(kv_dtype="fp8_e4m3")]) != chunk


class _Stream:
    def wait_stream(self, other):
        pass


class _Graph:
    """A stub CUDA graph: recording runs the program on the tenants'
    buffers and then puts every one of them back; a replay runs it."""

    server = None

    def __init__(self):
        self.fn = None
        self._saved = None

    def _buffers(self):
        for t in self.server.tenants:
            for f in dataclasses.fields(t):
                v = getattr(t, f.name)
                if torch.is_tensor(v):
                    yield v
            for c in t.caches or []:
                yield from c.values()

    def capture_begin(self, pool=None):
        self._saved = [(b, b.clone()) for b in self._buffers()]

    def capture_end(self):
        for b, v in self._saved:
            b.copy_(v)
        self._saved = None

    def replay(self):
        self.fn()


class _Entry(PS._CompiledEntry):
    """Hands the program to its stub graph, whose replay runs it."""

    __slots__ = ()

    def __init__(self, fn, graph=None, launches=None, first=None):
        super().__init__(fn, graph, launches, first)
        if graph is not None:
            graph.fn = fn


def _server():
    return PS.MultiTenantServer(["yi-9b", "yi-9b"],
                                tenants=[TenantSpec("yi-9b", **ARRIVAL)],
                                **SERVER)


def test_later_kv_windows_reuse_the_first_warmup(monkeypatch):
    """Served through four kv windows with stubbed captures: one warm-up
    per warm-up key, a capture per program built, and the tokens of the
    same server dispatching eagerly."""
    plain = _server()
    want = plain.run(steps=STEPS)
    assert plain._captures == plain._warmups == 0

    srv = _server()
    srv._capture_graphs = True
    srv._anchor_graph = lambda: ("anchor", None)
    _Graph.server = srv
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(PS, "_CompiledEntry", _Entry)
    built = []
    key_of = PS._warmup_key

    def record(key, group):
        built.append((key, key_of(key, group)))
        return built[-1][1]
    monkeypatch.setattr(PS, "_warmup_key", record)
    got = srv.run(steps=STEPS)

    kvs = {key[4] for key, _ in built if len(key) == 6}
    assert len(kvs) >= 3, kvs
    # two chunks of one length, in two kv windows, share a warm-up
    chunks = [(w, key[2]) for key, w in built if len(key) == 3]
    assert len(chunks) > len({w for w, _ in chunks}), chunks
    assert len({kv for _, kv in chunks}) == len(chunks)
    assert srv._warmups == len({w for _, w in built}) == len(srv._warm_sigs)
    assert srv._captures == len(built) == srv.compile_misses()
    assert srv._captures - srv._warmups >= len(kvs) - 1
    assert srv.counters()["warmups"] == srv._warmups
    assert got["tenants"].keys() == want["tenants"].keys()
    for tid, o in want["tenants"].items():
        assert o["tokens"] > 0
        np.testing.assert_array_equal(got["tenants"][tid]["output"],
                                      o["output"], err_msg=tid)
    # the residents reached their fourth kv window
    assert max(t.index for t in srv.tenants) > 3 * LANE
