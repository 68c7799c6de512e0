"""One run of one cell: set-up, the measured window, the drain, the
comparison with the reference, the result line.

The system under test is ``repro_torch.launch.serve.MultiTenantServer``
at published widths (``reduced=False``), pipelined, with captured CUDA
graphs on the card.  The whole run is one ``run()`` call: set-up serves
the cell's first sessions until each has its first token (and the
warm-up arrival has left), then the window opens and lasts
``--seconds``, then the window closes and the server drains.

The server's ``run()`` returns only once every budgeted tenant has
finished, and takes arrivals only through ``enqueue()`` on its logical
step clock.  So the harness drives it through one subclass hook: at
every admission point (the start of each epoch's planning,
``_admit_due``) the window's clock advances, arrivals whose wall-clock
send time has passed are handed to ``enqueue()`` (due at once),
finished sessions are replaced on their instance, and at the close the
live sessions' budgets are set to 0 so that ``run()`` returns once the
arrivals in flight have finished.  The window opens and closes with the
device synchronised, so the tokens counted at the close are done.
"""
from __future__ import annotations

import gc
import json
import math
import random
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from perfbench import families
from perfbench import metrics as readers
from perfbench import trace
from perfbench.reference import compare
from perfbench.traffic import generator as gen

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
LANE = 128               # positions per kv window (repro_torch.core.vmem)
SAMPLE_ROWS = 4          # rows of each sampled request held to the reference
# server methods a traced run wraps in spans (a missing one is skipped)
SPANS = ("_plan_epoch", "_dispatch_epoch", "_compile", "_admit_spec",
         "_stamp_ttft", "_depart")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def load_cell(name: str, bench_path: Path) -> Dict[str, Any]:
    """The workload ``name`` of ``BENCHMARK.json`` with its config file,
    the model family it names, its mix and the metrics it reports."""
    bench = json.loads(bench_path.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_path}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    config = json.loads((bench_path.parent / conf["file"]).read_text())
    return {"name": name, "chips": cell["chips"], "config": config,
            "family": families.load(config), "mix": gen.load(cell["traffic"]),
            "end_to_end": e2e, "per_layer": per_layer}


def register_arch(config: Dict[str, Any]):
    """The program's ArchConfig for the config file's ``arch``: the
    registry's entry, which must equal the file, or, for a name the
    registry lacks, the file's, registered."""
    from repro_torch.models.base import ArchConfig, all_archs, register
    want = ArchConfig(**config["arch"])
    have = all_archs().get(want.name)
    if have is None:
        return register(want)
    if have != want:
        raise ValueError(f"the program's {want.name} is {have}, the config "
                         f"file says {want}")
    return have


def server_class():
    """``MultiTenantServer`` with the window's hook at each admission
    point."""
    from repro_torch.launch.serve import MultiTenantServer
    if not callable(getattr(MultiTenantServer, "_admit_due", None)):
        raise RuntimeError("MultiTenantServer has no _admit_due admission "
                           "point for the wall-clock arrival hook")

    class Served(MultiTenantServer):
        hook = None
        last_work = ()

        def _admit_due(self, steps):
            if self.hook is not None:
                self.hook(self)
            super()._admit_due(steps)

        def _dispatch_epoch(self, work):
            self.last_work = work
            super()._dispatch_epoch(work)
    return Served


def steps_to_crossing(server) -> Tuple[int, bool]:
    """Decode steps until the first decoding tenant enters its next
    128-token kv window (the server reads attention in windows of
    ``LANE`` positions and captures a program per window), and whether a
    tenant stands at a crossing now (its next epoch captures)."""
    idx = [t.index for t in server.tenants if t.fed and not t.departed]
    return (min((LANE - i % LANE for i in idx), default=LANE),
            any(i % LANE == 0 for i in idx))


def req_index(tid: str) -> int:
    """The request index of a tenant id (the server names a tenant
    ``t<spec.seed>:<arch>``, and the harness's seed is the index)."""
    head = tid.split(":", 1)[0]
    if not head.startswith("t") or not head[1:].isdigit():
        raise RuntimeError(f"unrecognised tenant id {tid!r}")
    return int(head[1:])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Window:
    """The admission hook: set-up until warm, then the measured window,
    then the close.  Everything the metrics read is recorded here."""

    def __init__(self, traffic: gen.Traffic, arch_id: str, seconds: float,
                 trace_on: bool, device: torch.device):
        self.traffic, self.arch_id, self.seconds = traffic, arch_id, seconds
        self.trace_on, self.device = trace_on, device
        self.requests: Dict[int, gen.Request] = {
            r.index: r for r in traffic.sessions + traffic.warmups}
        self.phase = "warm"
        self.next_arrival = 0
        self.replaced: set = set()
        self.open: Dict[str, Any] = {}
        self.close: Dict[str, Any] = {}
        self.slice: Dict[str, Any] = {}
        self.profiler = None
        self.hook_calls = 0
        self.hook_s = 0.0          # the hook's own time (the profiler's too)
        self.profiler_s = 0.0      # the profiler's own start and stop
        self.timeline: List[List[float]] = []
        # traced runs on the card: CUDA events around every replay
        self.replays: List[Tuple[Any, Any]] = []
        self.peak = 0
        self.replay: Dict[str, Any] = {}

    # ------------------------------------------------------- requests --
    def spec(self, r: gen.Request):
        from repro_torch.sim.driver import TenantSpec
        self.requests[r.index] = r
        # prompt token + (output_len - 1) decode steps = output_len tokens
        return TenantSpec(self.arch_id, arrive_at=0.0,
                          n_inferences=r.output_len - 1,
                          prompt_len=r.prompt_len, seed=r.index,
                          param_seed=r.instance)

    def request_of(self, t) -> gen.Request:
        return self.requests[req_index(t.tid)]

    # ---------------------------------------------------------- state --
    def _state(self, server) -> Dict[str, Any]:
        from repro_torch.kernels import counters as kcount
        tenants = {t.tid: {"index": t.index, "pf_pos": t.pf_pos,
                           "fed": t.fed, "tokens": t.tokens_served}
                   for t in server.tenants}
        return {"pc": time.perf_counter(), "wall": time.time(),
                "tenants": tenants,
                "tokens": sum(v["tokens"] for v in tenants.values()),
                "captures": server._captures,
                "capture_s": server._capture_s,
                "sched_s": float(sum(server._sched_walls)),
                "admit_s": float(server._admit_wall),
                "hook_s": self.hook_s,
                "launches": kcount.snapshot()}

    def _warm(self, server) -> bool:
        """Every session has its first token and the warm-up arrival has
        left: the window opens before the first decode epoch, so its
        first capture falls inside, as every later kv window's does."""
        for t in server.tenants:
            kind = self.request_of(t).kind
            if kind == gen.WARMUP and not t.departed:
                return False
            if kind == gen.SESSION and not t.fed:
                return False
        return True

    def __call__(self, server) -> None:
        t0 = time.perf_counter()
        try:
            self._step(server)
        finally:
            self.hook_s += time.perf_counter() - t0

    def _step(self, server) -> None:
        self.hook_calls += 1
        if self.phase == "warm":
            if self._warm(server):
                _sync(self.device)
                self.open = self._state(server)
                self.phase = "open"
            return
        if self.phase != "open":
            return
        elapsed = time.perf_counter() - self.open["pc"]
        self.timeline.append([round(elapsed, 3), sum(
            t.tokens_served for t in server.tenants), server._captures])
        if self.trace_on:
            self._trace_slice(server, elapsed)
        if elapsed >= self.seconds:
            self._close(server)
            return
        new = []
        for t in server.tenants:
            r = self.request_of(t)
            # a session whose budget is spent departs in this planning
            # step: its successor is admitted in the same one
            done = t.departed or (t.budget_left is not None
                                  and t.budget_left <= 0 and not t.prefilling)
            if r.kind == gen.SESSION and done and \
                    r.index not in self.replaced:
                self.replaced.add(r.index)
                new.append(self.spec(self.traffic.next_session(r.instance)))
        arrivals = self.traffic.arrivals
        while (self.next_arrival < len(arrivals)
               and arrivals[self.next_arrival].send_s <= elapsed):
            new.append(self.spec(arrivals[self.next_arrival]))
            self.next_arrival += 1
        if new:
            server.enqueue(new)

    def _trace_slice(self, server, elapsed: float) -> None:
        """A slice of decode between two kv-window crossings (each crossing
        captures the decode programs anew; ``window_stall_share`` reads what
        that costs).  The host queues a kv window's epochs far ahead of the
        device and then waits in the next capture, so the slice starts at
        the first admission point past 30% of the window that lies 24-48
        steps before the host's next crossing (past 60%: at the next point
        off a crossing) and stops at the point where the host reaches the
        crossing, before it captures (or after ``length`` seconds); the
        device then drains the epochs queued since the start."""
        length = min(2.0, 0.3 * self.seconds)
        ahead, boundary = steps_to_crossing(server)
        if self.profiler is None and not self.slice and not boundary and (
                (elapsed >= 0.3 * self.seconds and 24 <= ahead <= 48)
                or elapsed >= 0.6 * self.seconds):
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            _sync(self.device)
            t0 = time.perf_counter()
            self.profiler = profile(activities=acts)
            self.profiler.start()
            trace.mark(trace.START)
            self.profiler_s += time.perf_counter() - t0
            self.slice = {"start": self._state(server)}
        elif self.profiler is not None and (
                time.perf_counter() - self.slice["start"]["pc"] >= length
                or boundary or elapsed >= self.seconds):
            _sync(self.device)
            trace.mark(trace.STOP)
            self.slice["stop"] = self._state(server)
            t0 = time.perf_counter()
            self.profiler.stop()
            self.profiler_s += time.perf_counter() - t0
            self.slice["profile"] = self.profiler
            self.profiler = None

    def _close(self, server) -> None:
        _sync(self.device)
        self.close = self._state(server)
        self.phase = "closed"
        if self.device.type == "cuda":
            self.peak = torch.cuda.max_memory_allocated(self.device)
        item = live_decode_item(server)
        self.replay = (replay_vs_eager(server, item) if item is not None
                       else {"mismatches": 1, "why": "no live decode item"})
        for t in server.tenants:
            if self.request_of(t).kind == gen.SESSION and not t.departed:
                t.budget_left = 0


def live_decode_item(server):
    """The last decode item the server dispatched whose tenants are all
    still live and short of ``max_len``, or None."""
    for item in reversed(server.last_work):
        if item[0] == "prefill":
            continue
        group = item[1] if item[0] == "bucket" else [item[1]]
        if all(not t.departed and t.index < server.max_len for t in group):
            return item
    return None


def replay_vs_eager(server, item) -> Dict[str, Any]:
    """One decode item of the window at the close, as ``chip_smoke.py``'s
    serve gate has it: the model's epoch core runs eagerly on clones of
    its tenants' caches, feedback tokens and device positions, then the
    server dispatches the item through its program (captured on a miss,
    else replayed).  Counts the tokens, cache buffers, feedback tokens
    and positions that are not bitwise equal."""
    from repro_torch.kernels import counters as kcount
    kind, who, plan, _ = item
    group = who if kind == "bucket" else [who]
    n = min(min(server.epoch_len, LANE - t.index % LANE,
                server.max_len - t.index) for t in group)
    item = (kind, who, plan, n)
    kv = server._item_kv(item)
    clones = {t.tid: ([{name: b.clone() for name, b in c.items()}
                       for c in t.caches], t.token.clone(),
                      t.index_dev.clone(), server._device_pos(t))
              for t in group}
    want = {}
    for t in group:
        caches, tok, idx, _ = clones[t.tid]
        want[t.tid], _ = server._epoch_cores[t.cfg.name](
            t.params, caches, tok, idx, t.enc, plan=plan, k=n, kv_len=kv)
    captures = server._captures
    before = kcount.snapshot()
    server._fused_epoch_fn(item)()
    for t in group:
        server._advance(t, n)
    launches = kcount.delta(before)
    _sync(server.device)
    bad = 0
    for t in group:
        caches, _, _, pos = clones[t.tid]
        out = want[t.tid]
        bad += not torch.equal(t.log[:, pos + n - out.shape[1]:pos + n], out)
        bad += not torch.equal(t.token, out[:, -1:])
        bad += not (int(t.index_dev) == pos + n == server._device_pos(t))
        bad += sum(not torch.equal(c[name], e[name])
                   for c, e in zip(t.caches, caches) for name in c)
    del clones, want
    return {"mismatches": int(bad), "kind": kind, "tenants": len(group),
            "position": pos, "steps": n, "kv_len": kv,
            "captured": server._captures - captures, "launches": launches}


def launch_checks(gate: Dict[str, List[str]],
                  launches: Dict[str, int]) -> Dict[str, Dict[str, Any]]:
    """The config's ``launch_gate`` over the window's launch counts: each
    kernel it names launched, every launch of one of the kinds it lists,
    and no other hand-written kernel launched (``{}``: none at all)."""
    checks: Dict[str, Dict[str, Any]] = {}
    unexpected = 0
    kernels = {k for k in launches if "." not in k and "@" not in k}
    for k in sorted(kernels | set(gate)):
        n = launches.get(k, 0)
        if k in gate:
            ok = sum(launches.get(f"{k}.{kind}", 0) for kind in gate[k])
            checks[f"launches.{k}.{'+'.join(gate[k])}"] = {
                "value": ok, "limit": 1, "min": True}
            unexpected += n - ok
        else:
            unexpected += n
    checks["launches_unexpected"] = {"value": unexpected, "limit": 0}
    return checks


def _time_replays(server, window: Window) -> None:
    """Traced runs on the card: each program the server replays inside
    the window between two CUDA events on the current stream, so the
    window's replay time is read on the device's clock."""
    def wrap(get):
        def timed(*a, **k):
            entry = get(*a, **k)
            if window.phase != "open":
                return entry

            def call():
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                entry()
                stop.record()
                window.replays.append((start, stop))
            return call
        return timed
    for name in ("_fused_epoch_fn", "_prefill_fn"):
        setattr(server, name, wrap(getattr(server, name)))


def warm_profiler(device: torch.device) -> None:
    """Start and stop the profiler once in set-up: its first start loads
    and initialises the tracer, which would otherwise land in the
    window."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if device.type == "cuda" else [])
    with profile(activities=acts):
        torch.ones(8, device=device).sum()
    _sync(device)


def _wrap_spans(server) -> None:
    """Traced runs: each of :data:`SPANS` inside a ``serve.<name>`` span."""
    from torch.profiler import record_function

    def wrap(name, fn):
        def call(*a, **k):
            with record_function(f"serve.{name.lstrip('_')}"):
                return fn(*a, **k)
        return call
    for name in SPANS:
        fn = getattr(server, name, None)
        if callable(fn):
            setattr(server, name, wrap(name, fn))


def _window_flops(family: ModuleType, arch: Dict[str, Any], w: Window,
                  batch: int) -> float:
    """Model operations of the prompt and decode tokens done between the
    window's open and close, every row of every tenant, counted by the
    cell's family."""
    total = 0
    for tid, c in w.close["tenants"].items():
        o = w.open["tenants"].get(tid, {"index": 0, "pf_pos": 0})
        P = w.requests[req_index(tid)].prompt_len
        total += family.span_flops(arch, o["pf_pos"], c["pf_pos"])
        if c["fed"]:
            total += family.span_flops(arch, max(o["index"], P), c["index"])
    return float(total * batch)


def _decode_steps(w: Window, a: Dict[str, Any], b: Dict[str, Any]) -> int:
    """Tenant-steps of decode between two states."""
    n = 0
    for tid, s in b["tenants"].items():
        P = w.requests[req_index(tid)].prompt_len
        if s["fed"]:
            n += s["index"] - max(a["tenants"].get(tid, {"index": 0})["index"], P)
    return n


def _ttfts(w: Window, server) -> List[float]:
    """Seconds from each arrival's send to its first token; an arrival
    still without one at the close counts the time it has waited."""
    base = w.open["wall"]
    out = []
    by_req = {w.request_of(t).index: t for t in server.tenants}
    for r in w.traffic.arrivals[:w.next_arrival]:
        t = by_req.get(r.index)
        sent = base + r.send_s
        if t is not None and t.ttft is not None and \
                t.admitted_wall + t.ttft <= w.close["wall"]:
            out.append(t.admitted_wall + t.ttft - sent)
        else:
            out.append(w.close["wall"] - sent)
    return out


def end_to_end(name: str, setup_s: float, w: Window, ttfts: List[float],
               window_s: float) -> Optional[float]:
    """The harness's own end-to-end metrics, by name."""
    if name == "setup_s":
        return setup_s
    if name == "tokens_per_s":
        return (w.close["tokens"] - w.open["tokens"]) / window_s
    if name.startswith("ttft_") and ttfts:
        stat = name[len("ttft_"):].rsplit("_", 1)[0]
        if stat == "mean":
            return float(np.mean(ttfts))
        if stat.startswith("p") and stat[1:].isdigit():
            return float(np.percentile(ttfts, float(stat[1:])))
    return None


def nvidia_smi() -> str:
    q = "name,clocks.sm,clocks.max.sm,power.draw,power.limit,temperature.gpu"
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not available ({e})"


def _sample(w: Window, server_out: Dict[str, Any], seed: int,
            batch: int) -> List[Dict[str, Any]]:
    """The requests held to the reference: each instance's longest session
    and, of the arrivals sent in the window, the one with the longest
    prompt and one more drawn from the seed; ``SAMPLE_ROWS`` rows of each,
    drawn from the seed."""
    rng = random.Random(f"perfbench:sample:{seed}")
    tenants = server_out["tenants"]
    by_req = {req_index(tid): tid for tid in tenants}
    longest: Dict[int, int] = {}        # per instance, its longest session
    for i, r in w.requests.items():
        if r.kind == gen.SESSION and i in by_req:
            n = tenants[by_req[i]]["output"].shape[1]
            j = longest.get(r.instance)
            if j is None or n > tenants[by_req[j]]["output"].shape[1]:
                longest[r.instance] = i
    sessions = sorted(longest.values())
    sent = [r.index for r in w.traffic.arrivals[:w.next_arrival]
            if r.index in by_req and tenants[by_req[r.index]]["departed"]]
    picks = list(sessions)
    if sent:
        longest = max(sent, key=lambda i: (w.requests[i].prompt_len, -i))
        picks.append(longest)
        rest = [i for i in sent if i != longest]
        if rest:
            picks.append(rng.choice(rest))
    out = []
    for i in picks:
        r = w.requests[i]
        served = tenants[by_req[i]]["output"]
        if served.shape[1] < 1:
            continue
        out.append({"request": r, "served": served,
                    "rows": sorted(rng.sample(range(batch),
                                              min(SAMPLE_ROWS, batch)))})
    return out


def check(samples: List[Dict[str, Any]], traffic: gen.Traffic,
          weight_sets: Dict[int, Any], family: ModuleType,
          arch: Dict[str, Any], device,
          control: bool = False) -> Dict[str, Any]:
    """Every sampled row against the family's reference: the widest gap
    (and the control's, when asked), with the tokens compared."""
    results = []
    for s in samples:
        r, served = s["request"], s["served"]
        prompt = traffic.prompt(r)
        bad = (served < 0) | (served >= arch["vocab_size"])
        if bad.any():
            n = int(served[s["rows"]].size)
            results.append({"gap": math.inf, "missed": n, "tokens": n,
                            "control_gap": math.inf, "control_missed": n,
                            "where": "served token outside the vocabulary"})
            continue
        rows = [(prompt[i], served[i]) for i in s["rows"]]
        res = compare.gaps(family, weight_sets[r.instance], arch, rows,
                           device, control=control)
        res.update(request=r.index, kind=r.kind, prompt_len=r.prompt_len,
                   served=int(served.shape[1]))
        results.append(res)
    return {"readings": compare.readings(results),
            "control": compare.readings(results, "control_") if control
            else None,
            "tokens": sum(x["tokens"] for x in results),
            "requests": results}


def run_cell(cell: Dict[str, Any], seed: int, seconds: float, trace_on: bool,
             device: Any, t_process: float,
             control: bool = False) -> Dict[str, Any]:
    """Set up, serve, measure, drain, compare.  Returns the result line
    (and, with ``control``, the control's reading beside it)."""
    device = torch.device(device)
    config, mix, family = cell["config"], cell["mix"], cell["family"]
    arch = config["arch"]
    cfg = register_arch(config)
    # the config sizes the server for its decode mix; a mix with longer
    # requests gives its own max_len and total_pages under "server"
    srv = {**config["server"], **mix.get("server", {})}
    batch = int(mix["batch"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
        from repro_torch.kernels import build
        built = build.build()
        if built:
            print(f"[perfbench] built {sorted(built)}", file=sys.stderr)
    marks = {"imported": time.perf_counter() - t_process}
    instances = int(config["instances"])
    weight_sets = {i: family.make(arch, seed, i, device)
                   for i in range(instances)}
    _sync(device)
    marks["weights"] = time.perf_counter() - t_process
    traffic = gen.Traffic(mix, instances, arch["vocab_size"], seed, seconds)
    window = Window(traffic, cfg.name, seconds, trace_on, device)
    prompts: Dict[int, np.ndarray] = {}

    def prompt_fn(spec, i, _cfg, _batch):
        r = window.requests[spec.seed]
        if r.index not in prompts:
            prompts[r.index] = traffic.prompt(r)
        return prompts.pop(r.index)

    def params_fn(_cfg, instance):
        return weight_sets[instance]

    Served = server_class()
    server = Served(
        batch=batch, max_len=int(srv["max_len"]),
        total_pages=int(srv["total_pages"]), epoch_len=int(srv["epoch_len"]),
        tenants=[window.spec(r) for r in traffic.sessions + traffic.warmups],
        prefill_chunk=int(srv["prefill_chunk"]), kv_dtype=srv["kv_dtype"],
        device=device, reduced=False, params_fn=params_fn,
        prompt_fn=prompt_fn)
    server.hook = window
    marks["server"] = time.perf_counter() - t_process
    if trace_on:
        _wrap_spans(server)
        warm_profiler(device)
        if device.type == "cuda":
            _time_replays(server, window)
    out = server.run(steps=1)
    if window.phase != "closed":
        raise RuntimeError(f"the server finished in phase {window.phase!r} "
                           f"after {window.hook_calls} admission points")
    found = forbidden_modules()
    if found:
        raise ImportError(f"modules loaded in the window: {found}")
    smi = nvidia_smi() if device.type == "cuda" else "cpu"
    peak = window.peak     # read at the close, before the replay check
    window_s = window.close["pc"] - window.open["pc"]
    setup_s = window.open["pc"] - t_process
    marks["open"] = setup_s
    ttfts = _ttfts(window, server)
    # the hook runs inside the server's planning: its own time is no
    # part of scheduling, and the profiler's own start and stop (the
    # device drained and idle) no part of the window
    hook_s = window.close["hook_s"] - window.open["hook_s"]
    replay_s = (sum(a.elapsed_time(b) for a, b in window.replays) / 1e3
                if window.replays else None)
    w = {"seconds": window_s - window.profiler_s,
         "tokens": window.close["tokens"] - window.open["tokens"],
         "arrivals": window.next_arrival,
         "flops": _window_flops(family, arch, window, batch),
         "tenant_steps": _decode_steps(window, window.open, window.close),
         **{k: window.close[k] - window.open[k]
            for k in ("capture_s", "captures", "sched_s", "admit_s")},
         "hook_s": hook_s, "profiler_s": window.profiler_s,
         "replay_s": replay_s, "replays": len(window.replays)}
    w["sched_s"] -= hook_s
    launches = {k: window.close["launches"][k]
                - window.open["launches"].get(k, 0)
                for k in window.close["launches"]}
    window.replays.clear()
    samples = _sample(window, out, seed, batch)
    shed = len(out["overload"]["shed"])
    attempted = (sum(1 for r in window.requests.values()
                     if r.kind == gen.SESSION) + window.next_arrival)
    traced = None
    if trace_on and "profile" in window.slice:
        s = window.slice
        summary = trace.summarize(s["profile"],
                                  s["stop"]["pc"] - s["start"]["pc"])
        in_slice = {k: s["stop"]["launches"][k]
                    - s["start"]["launches"].get(k, 0)
                    for k in s["stop"]["launches"]}
        summary.update(launches={k: v for k, v in in_slice.items() if v},
                       tenant_steps=_decode_steps(window, s["start"], s["stop"]))
        traced = summary
    del server, out
    window.slice.pop("profile", None)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = check(samples, traffic, weight_sets, family, arch, device,
                control=control)
    # each number compared, with its limit: at most, or at least (``min``)
    checks = {k: {"value": ref["readings"][k], "limit": float(v)}
              for k, v in config["limits"].items()}
    if "launch_gate" in config and device.type == "cuda":
        # the plain versions run on the CPU and count no launch
        checks.update(launch_checks(config["launch_gate"], launches))
    checks["replay_mismatch"] = {"value": window.replay["mismatches"],
                                 "limit": 0}
    checks["shed"] = {"value": shed, "limit": 0}
    checks["tokens_compared"] = {"value": ref["tokens"], "limit": 1,
                                 "min": True}
    checks["window_tokens"] = {"value": w["tokens"], "limit": 1, "min": True}
    correct = all(c["value"] >= c["limit"] if c.get("min")
                  else c["value"] <= c["limit"] for c in checks.values())
    run = {"arch": arch, "mix": mix, "batch": batch, "window": w,
           "trace": traced}
    metrics: Dict[str, Dict[str, Any]] = {}
    if trace_on:
        for m in cell["per_layer"]:
            v = readers.read(m["name"], run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell["end_to_end"]:
            v = end_to_end(m["name"], setup_s, window, ttfts, window_s)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    result: Dict[str, Any] = {"correct": correct, "attempted": attempted,
                              "failed": shed, "metrics": metrics,
                              "device": dev}
    if traced is not None:
        dev.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        result["breakdown"] = {"device_ops": trace.top_ops(traced["kernel_s"]),
                               "idle_gaps": traced["idle_gaps"]}
    result["checks"] = checks
    info = {"nvidia_smi": smi, "window": w, "setup_s": setup_s,
            "setup_marks_s": marks,
            "ttft_s": ttfts, "readings": ref["readings"],
            "reference": ref["requests"],
            "timeline": window.timeline,
            "launches": {k: v for k, v in launches.items() if v},
            "replay": {k: v for k, v in window.replay.items()
                       if k != "launches"},
            "tokens_compared": ref["tokens"]}
    if control:
        # the control in the program's place, held to the same limits
        ctl = {k: {"value": ref["control"][k], "limit": float(v)}
               for k, v in config["limits"].items()}
        info.update(control=ref["control"], control_checks=ctl,
                    control_correct=all(c["value"] <= c["limit"]
                                        for c in ctl.values()))
    return {"result": result, "info": info}
