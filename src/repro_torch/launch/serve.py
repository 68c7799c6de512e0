"""Multi-tenant server, dense, MoE and SSM families (port of
src/repro/launch/serve.py::MultiTenantServer and its ``main`` CLI).

Several LM tenants (dense decoders, MoE decoders and Mamba2 stacks,
mixed in one pool or not) share one device.  Each tenant's FFN block is a
small :class:`~repro_torch.core.types.ModelGraph` mapped by the CaMDN
core (LWM tile candidates per usage limit plus the fused-block LBM
candidate), and every epoch the same :class:`TenantTask` /
:class:`CamdnPolicy` state machine as the reference grants pages from
the modeled page pool.  The grant lowers to a KernelPlan, and the plan
decides which Hopper kernel each decode step's FFNs run:

  pages granted -> candidate (LBM block_fused_ffn vs LWM cache_matmul
  tiles) -> decode.

A Mamba2 tenant is scheduled the same way; its O(1) recurrent decode
step has no FFN, so its decode runs no plan (``_dec_plan``), and its
grant reaches the device through its prefill: every prompt chunk scans
through the ssd_chunk kernel, at chunk boundaries aligned to the SSD
chunk (``_chunk_align``).  Its reservation prices the recurrent state,
which is never quantized.  An MoE tenant's attention and KV are a dense
tenant's; its decode step runs the gathered-expert path, which ignores
the plan (``_dec_plan``), and its prompt chunks run the plain drop-free
buckets, as in the reference: no kernel of the server's MoE path is
hand-written, and the grant governs its NEC charge, chunk length and
plan trace.  Its grants are lowered at the experts' d_ff
(``_lower_width``).

The scheduling side is the reference's, line for line, on the copied
core: the grant, plan and NEC traces of a scenario equal the
reference's, at every width.  (At full width the reference's LBM
segmentation, capped at 2 ms of modeled NPU time per block, leaves no
LBM candidate, so full-width serving runs LWM grants only, as the
reference's does.)  What this port keeps: the serial
(``pipeline=False``) and epoch-pipelined loops, interleaved and sequential admission,
grant-sized prefill chunks, the ``kv_len`` attention windows, KV page
reservations and departures, QoS ordering, the batched Algorithm 1
planner (``batch_sched``), and quantized KV (``kv_dtype``: a pinned
int8 / fp8_e4m3 rung, or ``"auto"``, the precision ladder that prices
each arriving prompt tenant's reservation at every rung and takes the
first that fits the free pool; per-page dequant scales recorded in the
page table at the TTFT stamp).

Execution.  The pipelined loop dispatches every decode item and every
prompt chunk through a :class:`_CompiledEntry`, kept in a bounded LRU
(:class:`_LruCache`, the reference's, with its counters).  On the card
an entry holds one captured ``torch.cuda.CUDAGraph`` and a dispatch is
one replay; on the CPU it holds the same function as an eager closure,
and a dispatch calls it.  The serial loop (``pipeline=False``) stays
eager: it is the oracle that pipelined serving is held to.  Where the
reference compiles each epoch's decode work into one jitted program,
this port deviates so:

* Keys.  A decode item's key is the reference's per-item tuple (kind,
  arch, plan, k, kv window) plus the ids of the tenants it decodes; a
  prompt chunk's is (tid, chunk length, kv window).  A graph binds its
  tenants' params, caches and buffers by address, so it serves those
  tenants only, where the reference's programs take them as arguments.
* One graph per item, not per epoch.  With tenant ids in the key, a
  whole-epoch key would miss whenever any one tenant moved to another
  window or plan, and n replays cost the host microseconds each.
* A bucket runs its tenants' epochs in turn inside one graph
  (``make_decode_epoch_batched``).  The params are not stacked (one
  full-width yi-9b tenant's are ~17 GB) and the caches stay per tenant,
  so the reference's ``_bucket_caches`` / ``_unstack_bucket`` have no
  counterpart; ``_batched_params`` returns the group's params as a list.
* ``warm_aot`` (``aot_warmup=True``) captures the predicted keys on the
  run's own thread, before the first epoch and at a mid-run arrival,
  not on a daemon thread beside live launches.

Each tenant owns static device buffers, allocated at admission and
freed at departure: the feedback token [B, 1], its position (a device
int64 scalar) and a token log [B, max_len], where each epoch writes the
token it decodes at each position.  A graph advances the position
itself; the host keeps ``Tenant.index`` for scheduling, and the two
agree after every dispatch.  The log is read back once, after the run
(a departing tenant's served tokens are copied on the device first).
Nothing a graph allocates outlives its replay, so one server's graphs
share one memory pool.  A departure evicts every entry that names the
tenant before its buffers are freed; these evictions are counted apart
from the LRU's.

Capture on the card.  The first capture of a signature (a key without
its tenant ids) follows one eager run of the same function on the
capture stream, which loads the kernels' libraries, sets their
attributes and warms cuBLAS on that stream.  It runs on the tenants'
own buffers with their feedback tokens, positions and SSM states copied
aside and put back; the KV rows and log entries it writes lie at or
past the position, where the replay writes them again before anything
reads them.  Neither the warm-up's launches nor the capture's are
counted: each replay adds the launch counts its capture recorded
(``kernels/counters.py``).  A capture or replay that fails raises; on
the card nothing falls back to eager dispatch.  Nothing reads the
device back to the host except the TTFT stamp of a tenant's first
token, and the log once after the run.

Not ported here (raising ``NotImplementedError``): device meshes,
prefix dedup, fault injection and preemption, overload admission and
grant lookahead (each with its quantized-KV part).

Entry points run on ``device="cuda"`` unless the caller asks for the
CPU.  Without injected params / prompts the server draws params from a
seeded ``torch.Generator`` and prompts from ``np.random.default_rng``
(the reference's threefry draws cannot be reproduced); parity tests
inject the reference's through ``params_fn`` / ``prompt_fn``.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.allocator import AHEAD_FRACTION, INF, Selection
from repro_torch.core.cache import CacheConfig
from repro_torch.core.mapping import MapperConfig
from repro_torch.core.mct import MCT, ModelMapping
from repro_torch.core.plan import KernelPlan, lower_prefill_chunk
from repro_torch.core.policy import (KV_PRECISION_LADDER, CamdnPolicy,
                                     ReplicaControl, choose_kv_dtype,
                                     price_layer_batch)
from repro_torch.core.runtime import (STATE_ADMITTED, STATE_RUNNING,
                                      TenantModel, TenantTask)
from repro_torch.core.types import (GemmDims, LayerKind, LayerSpec, ModelGraph,
                                    ceil_div, elem_bytes)
from repro_torch.core.vmem import (LANE, PAGE_BYTES, VMEM_PAGES,
                                   fused_ffn_pages, kv_row_bytes,
                                   lower_selection)
from repro_torch.kernels import counters as kcount
from repro_torch.models import model as M
from repro_torch.models.base import ArchConfig, get_arch
from repro_torch.models.ssm import CONV_K
from repro_torch.models.transformer import (PORTED_FAMILIES, init_caches,
                                            num_groups)
from repro_torch.sim.driver import PoissonArrivals, TenantSpec

ParamsFn = Callable[[ArchConfig, int], Any]
PromptFn = Callable[[TenantSpec, int, ArchConfig, int], np.ndarray]


def _elem_bytes(cfg: ArchConfig) -> int:
    return elem_bytes(cfg.dtype)


def _ffn_width(cfg: ArchConfig) -> int:
    """The FFN width a tenant is scheduled at, as the reference's
    ``_ffn_graph`` and prefill-chunk lowering take it: max(d_ff,
    d_model).  Grants are lowered, and the fused working set quoted, at
    :func:`_lower_width` instead."""
    return max(cfg.d_ff, cfg.d_model)


def _lower_width(cfg: ArchConfig) -> int:
    """The FFN width a grant is lowered at and the LBM candidates quote
    the fused kernel's working set at: ``cfg.d_ff``, the width the
    kernels execute with (an olmoe expert's 1024 at d_model 2048), as in
    the reference.  An arch with no FFN (full-width mamba2, d_ff = 0)
    takes d_model, where the reference would divide by zero; its grant
    lowers only its SSD chunk and prefill chunk length."""
    return cfg.d_ff if cfg.d_ff > 0 else cfg.d_model


def _ffn_graph(name: str, cfg: ArchConfig, seq_block: int) -> ModelGraph:
    """One transformer layer's FFN as a schedulable layer graph (gate/up
    -> down), padded to the 128-lane tile the plans are sized on."""
    eb = _elem_bytes(cfg)
    seq_block = max(seq_block, LANE)
    d, f = cfg.d_model, _ffn_width(cfg)
    up = LayerSpec(
        "ffn.up", LayerKind.GEMM,
        (GemmDims(M=seq_block, N=f, K=d, reps=2, b_reused=False),),  # gate+up
        input_bytes=seq_block * d * eb, output_bytes=seq_block * f * eb,
        weight_bytes=2 * d * f * eb, elem_bytes=eb)
    down = LayerSpec(
        "ffn.down", LayerKind.GEMM,
        (GemmDims(M=seq_block, N=d, K=f),),
        input_bytes=seq_block * f * eb, output_bytes=seq_block * d * eb,
        weight_bytes=f * d * eb, elem_bytes=eb)
    return ModelGraph(f"{name}.ffn", [up, down])


def _vmem_mapper(total_pages: int) -> MapperConfig:
    return MapperConfig(page_bytes=PAGE_BYTES,
                        npu_subspace_bytes=total_pages * PAGE_BYTES)


def _tenant_model(graph: ModelGraph, mapper: MapperConfig) -> TenantModel:
    """A tenant's mapped FFN graph, built as the reference's server
    builds it (``TenantModel`` with the default ``LbmConfig``)."""
    return TenantModel(graph, mapper)


def _kv_reserve_pages(cfg: ArchConfig, batch: int, tokens: int,
                      kv_dtype: str = "native") -> int:
    """Pages an admitted prompt tenant reserves for its KV / state
    working set (held until departure).  Attention layers cache K and V
    rows, priced at the tenant's storage precision ``kv_dtype`` plus the
    per-row fp32 scales a quantized cache carries; an SSM layer's state
    (conv window in the compute dtype, fp32 recurrent state) is O(1) in
    the prompt."""
    eb = _elem_bytes(cfg)
    quantized = kv_dtype != "native"
    kv_eb = elem_bytes(kv_dtype) if quantized else eb
    G = num_groups(cfg)
    kv_groups, ssm_groups = (0, G) if cfg.family == "ssm" else (G, 0)
    row = kv_row_bytes(cfg.num_kv_heads, cfg.hd, kv_eb, scaled=quantized)
    kv = kv_groups * batch * tokens * row
    state = ssm_groups * batch * (
        (CONV_K - 1) * (cfg.d_inner + 2 * cfg.ssm_state) * eb
        + cfg.ssm_heads * cfg.ssm_state * cfg.ssm_head_dim * 4)
    return ceil_div(kv + state, PAGE_BYTES) if tokens > 0 else 0


def _prompt_tokens(spec: TenantSpec, i: int, cfg: ArchConfig,
                   batch: int) -> np.ndarray:
    """Deterministic prompt tokens for admission ``i`` (seeded numpy, not
    the reference's threefry stream)."""
    if spec.prompt_seed is not None:
        raise NotImplementedError("session prompts (prefix dedup) not yet "
                                  "ported; inject prompts with prompt_fn")
    rng = np.random.default_rng(7919 + i)
    return rng.integers(0, cfg.vocab_size, (batch, spec.prompt_len),
                        dtype=np.int32)


class _LruCache:
    """Bounded LRU map for the server's program caches (the reference's
    src/repro/launch/serve.py::_LruCache, without its lock: the port
    builds programs on the run's own thread only): under churning tenant
    mixes the key space grows without bound, so the coldest entry is
    evicted past ``capacity``.  Every miss is one program build (here:
    one capture on the card), so the hit/miss counters double as the
    server's compile counter."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._d: "OrderedDict" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key, default=None):
        if key in self._d:
            self._d.move_to_end(key)
            self.hits += 1
            return self._d[key]
        self.misses += 1
        return default

    def peek(self, key, default=None):
        """Counter-free lookup (no hit/miss accounting, no LRU touch)."""
        return self._d.get(key, default)

    def __setitem__(self, key, value) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)
            self.evictions += 1

    def pop(self, key, default=None):
        return self._d.pop(key, default)

    def __contains__(self, key) -> bool:
        return key in self._d

    def keys(self):
        return list(self._d.keys())


class _CompiledEntry:
    """One decode item's or prompt chunk's program: a captured
    ``torch.cuda.CUDAGraph`` with the kernel launches its capture
    recorded (``launches``, added to the counters at every replay), or,
    where the server captures nothing (the CPU, the serial loop), the
    eager closure itself.  ``aot`` marks an entry ``warm_aot`` built
    ahead of its first use; ``aot_hits`` counts its dispatches."""

    __slots__ = ("fn", "graph", "launches", "aot", "aot_hits")

    def __init__(self, fn: Callable[[], None], graph: Any = None,
                 launches: Optional[Dict[str, int]] = None):
        self.fn = fn
        self.graph = graph
        self.launches = launches or {}
        self.aot = False
        self.aot_hits = 0

    def __call__(self) -> None:
        if self.aot:
            self.aot_hits += 1
        if self.graph is None:
            self.fn()
        else:
            self.graph.replay()
            kcount.add(self.launches)


@dataclasses.dataclass
class Tenant:
    tid: str
    cfg: ArchConfig
    params: Any
    caches: Any
    decode: Any        # one-step closure (serial reference path)
    task: TenantTask
    token: Any         # [B, 1] int64 device buffer: the next input
    #                    (feedback), valid once ``fed``
    index: int = 0     # host position (scheduling)
    index_dev: Any = None  # the same position on the device (int64 [])
    log: Any = None        # [B, max_len] int64 device buffer: the token
    #                        decoded at each position
    fed: bool = False      # decoding: a resident from admission, a prompt
    #                        tenant from its first token on
    tokens_served: int = 0
    epochs_served: int = 0
    choices: List[str] = dataclasses.field(default_factory=list)
    plans: List[KernelPlan] = dataclasses.field(default_factory=list)
    # a departed tenant's served tokens (a device copy of its log's),
    # read back to the host once, after the serving loop finishes
    outputs: Any = None
    # ---- continuous batching ----------------------------------------
    prompt: Optional[np.ndarray] = None   # [B, P] int32 host tokens
    prompt_dev: Any = None                # the same, on the device
    prompt_len: int = 0
    pf_pos: int = 0                       # prompt tokens already in cache
    ptask: Optional[TenantTask] = None    # prefill-side task (chunk MCT)
    chunks: List[int] = dataclasses.field(default_factory=list)
    budget_left: Optional[int] = None     # decode steps before departure
    departed: bool = False
    qos_target: Optional[float] = None
    admitted_wall: Optional[float] = None
    ttft: Optional[float] = None          # seconds admission -> 1st token
    first_token_event: Any = None         # CUDA event after the 1st token
    run_steps: int = 0                    # decode steps this run() call
    kv_wanted: int = 0                    # pages the working set asks for
    kv_reserved: int = 0                  # pages actually reserved
    kv_dtype: str = "native"              # KV storage precision (plan axis)
    # per live prompt row, the max dequant scale over layers, K/V, batch
    # and KV heads; copied to the host before the first-token event and
    # read at the TTFT stamp
    scale_rows: Optional[torch.Tensor] = None
    pf_computed: int = 0                  # prompt tokens prefilled
    state: str = STATE_ADMITTED

    @property
    def prefilling(self) -> bool:
        return self.prompt is not None and self.pf_pos < self.prompt_len


class MultiTenantServer:
    """Decode across dense, MoE and SSM tenants with CaMDN page
    arbitration.

    The reference's constructor arguments keep their meaning.  Added:
    ``device`` (default ``"cuda"``), ``reduced`` (the reference always
    serves ``get_arch(aid).reduced()``; False serves the full-width
    config), and the injection hooks ``params_fn(cfg, param_seed)`` and
    ``prompt_fn(spec, admission_index, cfg, batch)``.  The reference
    features this slice has not ported raise ``NotImplementedError``.
    """

    def __init__(self, arch_ids: Optional[List[str]] = None, batch: int = 2,
                 max_len: int = 128, total_pages: int = VMEM_PAGES,
                 qos_targets: Optional[Dict[str, float]] = None,
                 epoch_len: int = 8, pipeline: bool = True,
                 tenants: Optional[List[TenantSpec]] = None,
                 arrivals: Optional[PoissonArrivals] = None,
                 admission: str = "interleaved",
                 prefill_chunk: int = 2 * LANE,
                 steps_per_s: float = 1.0,
                 device: Any = "cuda",
                 prefix_dedup: bool = False,
                 kv_dtype: str = "native",
                 batch_sched: bool = True,
                 lookahead: bool = False,
                 aot_warmup: bool = False,
                 faults: Any = None,
                 queue_limit: Optional[int] = None,
                 queue_deadline_s: Optional[float] = None,
                 reduced: bool = True,
                 params_fn: Optional[ParamsFn] = None,
                 prompt_fn: Optional[PromptFn] = None):
        if admission not in ("interleaved", "sequential"):
            raise ValueError(f"admission {admission!r}")
        if not isinstance(device, (str, torch.device)):
            raise NotImplementedError("device meshes not yet ported")
        for name, value, off in (
                ("prefix_dedup", prefix_dedup, False),
                ("lookahead", lookahead, False),
                ("faults", faults, None),
                ("queue_limit", queue_limit, None),
                ("queue_deadline_s", queue_deadline_s, None)):
            if value != off:
                raise NotImplementedError(f"{name} not yet ported")
        if kv_dtype not in KV_PRECISION_LADDER + ("auto",):
            raise ValueError(f"kv_dtype {kv_dtype!r}: want one of "
                             f"{KV_PRECISION_LADDER + ('auto',)}")
        self.device = torch.device(device)
        self.reduced = bool(reduced)
        self.aot_warmup = bool(aot_warmup)
        self._params_fn = params_fn
        self._prompt_fn = prompt_fn or _prompt_tokens
        self.qos_targets = qos_targets or {}
        self.kv_dtype = kv_dtype
        self.batch_sched = bool(batch_sched)
        self.epoch_len = max(1, int(epoch_len))
        self.pipeline = bool(pipeline)
        self.admission = admission
        self.prefill_block = max(LANE, int(prefill_chunk))
        self.steps_per_s = steps_per_s
        self.control = ReplicaControl.build(
            "solo", CacheConfig(
                total_bytes=total_pages * PAGE_BYTES,
                num_slices=1, num_ways=1, npu_ways=1,
                page_bytes=PAGE_BYTES))
        self.cache = self.control.cache
        self.nec = self.control.nec
        self.alloc = self.control.alloc
        self.policy = self.control.policy
        total_pages = self.cache.config.num_pages
        self.mapper = _vmem_mapper(total_pages)
        self.tenants: List[Tenant] = []
        self.batch = batch
        self.max_len = max_len
        self._clock = 0               # logical step clock (admissions)
        self._n_admitted = 0
        # model closures, shared per arch
        self._step_fns: Dict[str, Any] = {}
        self._epoch_cores: Dict[str, Any] = {}
        self._batched_cores: Dict[str, Any] = {}
        self._prefill_cores: Dict[str, Any] = {}
        self._groups: Dict[str, List[Tenant]] = {}
        # programs: decode items and prompt chunks, the reference's LRU
        # capacities; captured graphs on the card in the pipelined loop
        self._fused_jits = _LruCache(capacity=64)
        self._prefill_jits = _LruCache(capacity=16)
        self._capture_graphs = self.device.type == "cuda" and self.pipeline
        self._capture_stream = None
        self._graph_pool = None
        self._warm_sigs: set = set()
        self._captures = 0
        self._capture_s = 0.0
        self._warmups = 0
        self._warmup_s = 0.0
        self._depart_evictions = 0
        self._aot_compiled = 0
        self._run_steps = 0
        # host-path instrumentation: per-epoch scheduling wall and
        # dispatch wall, and admission (param / cache materialization)
        self._sched_walls: List[float] = []
        self._device_walls: List[float] = []
        self._admit_walls: List[float] = []
        self._admit_wall = 0.0
        self._epoch_compiles: List[int] = []
        self._batched_runs = 0
        self._oracle_runs = 0
        specs: List[TenantSpec] = [TenantSpec(aid) for aid in arch_ids or []]
        specs += list(tenants or [])
        if arrivals is not None:
            specs += arrivals.specs()
        specs.sort(key=lambda s: s.arrive_at)
        # queue entries are [spec, due_wall, arrive_step]
        self._queue: List[List] = []
        for spec in specs:
            if spec.arrive_at <= 0.0:
                self._admit_spec(spec)
            else:
                self.enqueue([spec])

    def enqueue(self, specs: List[TenantSpec]) -> None:
        """Queue arrivals relative to the current logical clock."""
        for spec in sorted(specs, key=lambda s: s.arrive_at):
            step = self._clock + int(math.ceil(spec.arrive_at
                                               * self.steps_per_s))
            self._queue.append([spec, None, step])
        self._queue.sort(key=lambda it: it[2])

    def active_count(self) -> int:
        return sum(1 for t in self.tenants if not t.departed)

    def page_utilization(self) -> float:
        return self.control.utilization

    # ------------------------------------------------------- admission --
    def _to_device(self, tokens: np.ndarray) -> torch.Tensor:
        """Host int32 tokens -> int64 device tensor, without blocking
        the host on the device (pinned, asynchronous copy)."""
        host = torch.from_numpy(np.array(tokens, dtype=np.int32))
        if self.device.type == "cuda":
            host = host.pin_memory()
        return host.to(self.device, non_blocking=True).long()

    def _admit_spec(self, spec: TenantSpec,
                    due_wall: Optional[float] = None) -> Tenant:
        """Create a tenant from a spec (resident at construction or
        arriving mid-run).  Prompt tenants get prompt tokens, a
        prefill-block TenantTask for chunk scheduling, and a KV page
        reservation held until departure."""
        aid = spec.model if isinstance(spec.model, str) else spec.model.name
        i = spec.seed if spec.seed is not None else self._n_admitted
        self._n_admitted += 1
        arch = get_arch(aid)
        if arch.family not in PORTED_FAMILIES:
            raise NotImplementedError(f"{aid}: family {arch.family!r} not "
                                      f"yet ported (have {PORTED_FAMILIES})")
        cfg = arch.reduced() if self.reduced else arch
        pkey = spec.param_seed if spec.param_seed is not None else i
        params = (self._params_fn(cfg, pkey) if self._params_fn is not None
                  else M.init_params(cfg, pkey, self.device))
        if cfg.name not in self._step_fns:
            self._step_fns[cfg.name] = M.make_decode_step(cfg)
        tid = f"t{i}:{aid}"
        tm = _tenant_model(_ffn_graph(aid, cfg, seq_block=self.batch),
                           self.mapper)
        self._align_lbm_to_vmem(tm, cfg, max(self.batch, LANE))
        task = TenantTask(tid, tm, self.cache, self.nec, self.policy)
        t = Tenant(tid, cfg, params, None, self._step_fns[cfg.name], task,
                   token=None)
        t.budget_left = spec.n_inferences
        if spec.qos_ms is not None:
            self.qos_targets[tid] = spec.qos_ms * 1e-3
        t.qos_target = self._resolve_qos(tid)
        if spec.prompt_len > 0:
            # the KV cache must hold the prompt plus every budgeted
            # decode step (a write past max_len is an error here)
            need = spec.prompt_len + (spec.n_inferences or 0)
            if need > self.max_len:
                raise ValueError(f"{tid}: prompt {spec.prompt_len} + decode "
                                 f"budget {spec.n_inferences or 0} > max_len "
                                 f"{self.max_len}")
            t.prompt_len = spec.prompt_len
            t.prompt = np.asarray(self._prompt_fn(spec, i, cfg, self.batch),
                                  np.int32)
            t.prompt_dev = self._to_device(t.prompt)
            t.kv_dtype = self._choose_kv_dtype(cfg, spec)
            # whole-prompt MCT for the sequential baseline, chunk-block
            # MCT for interleaved chunked prefill
            pf_block = (spec.prompt_len
                        if self.admission == "sequential" or not self.pipeline
                        else self.prefill_block)
            ptm = _tenant_model(_ffn_graph(aid, cfg, seq_block=pf_block),
                                self.mapper)
            self._align_lbm_to_vmem(ptm, cfg, max(pf_block, LANE))
            t.ptask = TenantTask(tid + "/pf", ptm, self.cache, self.nec,
                                 self.policy)
            want = _kv_reserve_pages(cfg, self.batch, spec.prompt_len,
                                     t.kv_dtype)
            t.kv_wanted = want
            # best-effort reservation: degrade to what the pool can spare
            # now; kv_reserved < kv_wanted records the degradation
            got = self.cache.alloc(tid + "#kv", want)
            if got is None:
                got = self.cache.alloc(tid + "#kv",
                                       min(want, self.cache.free_pages))
            t.kv_reserved = len(got or [])
        # the static buffers every program of the tenant reads and writes
        # (seed-token flow: no prompt, decode from token i)
        t.token = torch.full((self.batch, 1), i % cfg.vocab_size,
                             dtype=torch.long, device=self.device)
        t.fed = spec.prompt_len <= 0
        t.index_dev = torch.zeros((), dtype=torch.long, device=self.device)
        t.log = torch.zeros((self.batch, self.max_len), dtype=torch.long,
                            device=self.device)
        t.caches = init_caches(params, cfg, self.batch, self.max_len,
                               kv_dtype=t.kv_dtype, device=self.device)
        t.admitted_wall = due_wall if due_wall is not None else time.time()
        self.tenants.append(t)
        self._groups.setdefault(cfg.name, []).append(t)
        self._epoch_cores.setdefault(cfg.name, M.make_decode_epoch(cfg))
        self._prefill_cores.setdefault(cfg.name, M.make_prefill_chunk(cfg))
        if self.aot_warmup and self._run_steps > 0:
            # mid-run arrival: capture its predicted decode programs
            # while its prompt is still to prefill
            self.warm_aot(self._run_steps)
        return t

    def _choose_kv_dtype(self, cfg: ArchConfig, spec: TenantSpec) -> str:
        """KV storage precision for an arriving prompt tenant.  A fixed
        server policy pins the rung; ``auto`` prices the full reservation
        at every rung of the precision ladder and takes the first that
        fits the pool's free pages now (the ladder bottom when none
        does).  Resident (no-prompt) tenants stay native, and so does an
        SSM tenant: its decode carries recurrent fp state, not
        row-addressed KV."""
        if cfg.family == "ssm":
            return "native"
        if self.kv_dtype != "auto":
            return self.kv_dtype
        want = {kv: _kv_reserve_pages(cfg, self.batch, spec.prompt_len, kv)
                for kv in KV_PRECISION_LADDER}
        return choose_kv_dtype(want, self.cache.free_pages)

    def _due(self, item: List) -> bool:
        return item[2] <= self._clock

    def _admit_due(self, steps: int) -> None:
        """Admission, checked at epoch boundaries.  Requests whose
        arrive_at has passed on the logical clock are stamped due (their
        TTFT clock starts), then admitted: at once under interleaved
        admission, or — sequential admission, the static-batching
        baseline — only when every in-flight tenant has drained."""
        now = time.time()
        for item in self._queue:
            if item[1] is None and self._due(item):
                item[1] = now
        continuous = self.pipeline and self.admission == "interleaved"
        if not continuous:
            busy = any((not t.departed and t.prefilling)
                       or self._decodable(t, steps)
                       for t in self.tenants)
            if busy:
                return
        while self._queue and self._due(self._queue[0]):
            spec, due_wall, _ = self._queue.pop(0)
            a0 = time.perf_counter()
            self._admit_spec(spec, due_wall)
            self._admit_wall += time.perf_counter() - a0

    def _depart(self, t: Tenant) -> None:
        """The tenant leaves: its page grants, KV reservation and
        allocator profiles return to the pool, every program naming it is
        evicted (a graph outliving its buffers would replay into freed
        memory), and then its device buffers are released.  Its served
        tokens are copied on the device first (outputs and traces stay
        for the result)."""
        if t.departed:
            return
        t.departed = True
        t.task.depart()
        if t.ptask is not None:
            t.ptask.depart()
        self.cache.free(t.tid + "#kv", None)
        self._groups[t.cfg.name].remove(t)
        self._evict_programs(t.tid)
        t.outputs = self._served(t).clone()
        t.params = None
        t.caches = None
        t.prompt = None
        t.prompt_dev = None
        t.token = t.index_dev = t.log = None

    def _evict_programs(self, tid: str) -> None:
        """Drop every decode and prefill entry whose key names ``tid``."""
        for cache, tids in ((self._fused_jits, lambda key: key[5]),
                            (self._prefill_jits, lambda key: key[:1])):
            for key in cache.keys():
                if tid in tids(key):
                    cache.pop(key)
                    self._depart_evictions += 1

    def _served(self, t: Tenant) -> torch.Tensor:
        """[B, n] device view of the tokens served so far: the log from
        the first token (a prompt tenant's greedy token after its prompt,
        at position prompt_len - 1) up to the host position."""
        first = t.prompt_len - 1 if t.prompt_len > 0 else 0
        return t.log[:, first:max(first, t.index)]

    def _process_departures(self) -> None:
        for t in self.tenants:
            if (not t.departed and t.budget_left is not None
                    and t.budget_left <= 0 and not t.prefilling):
                self._depart(t)

    def _align_lbm_to_vmem(self, tm: TenantModel, cfg: ArchConfig,
                           seq_block: int) -> None:
        """Make the LBM candidates quote the fused kernel's working set
        at the tenant's lowering width (:func:`_lower_width`), so that an
        admitted LBM grant always lowers fused.  Copy-on-write: the
        mapping may be the process-wide memoized instance."""
        eb = _elem_bytes(cfg)
        need = fused_ffn_pages(seq_block, cfg.d_model, _lower_width(cfg), eb)
        mcts = []
        for mct in tm.mapping.mcts:
            if mct.lbm is not None and mct.lbm.p_need < need:
                mct = MCT(mct.layer_name, list(mct.lwms),
                          dataclasses.replace(mct.lbm, p_need=need))
            mcts.append(mct)
        tm.mapping = ModelMapping(tm.mapping.model_name, mcts,
                                  tm.mapping.blocks)

    # ------------------------------------------------------ scheduling --
    def _schedule_block(self, t: Tenant, now: float,
                        task: Optional[TenantTask] = None
                        ) -> List[Tuple[Selection, int]]:
        """Run a tenant block through the TenantTask state machine:
        select -> (timeout-downgrade)* -> grant -> end, charging traffic
        through the NEC ledger.  Returns, per layer, the final Selection
        and the pages held at execution."""
        task = task or t.task
        if task.done:
            task.reset_for_next_inference()
        sched: List[Tuple[Selection, int]] = []
        while not task.done:
            sel = task.begin_layer(now)
            granted = self.cache.alloc(task.id, task.pages_to_request())
            attempts = 0
            while granted is None and attempts < len(task.mct().lwms) + 2:
                # a failed grant downgrades immediately
                sel = task.on_timeout(now)
                granted = self.cache.alloc(task.id, task.pages_to_request())
                attempts += 1
            if granted is None:
                # starved: stream the layer through the minimum-footprint
                # LWM with whatever is already held
                smallest = min(task.mct().lwms, key=lambda m: m.p_need)
                sel = Selection(smallest, 0, now)
                task.selection = sel
                granted = []
            task.start_execution(now, granted)
            sched.append((task.selection, task.held_pages))
            t.choices.append(f"{sel.candidate.kind}:{task.held_pages}p")
            task.end_layer(now)
        return sched

    def _lower_plan(self, t: Tenant, sched: List[Tuple[Selection, int]],
                    seq_block: Optional[int] = None) -> KernelPlan:
        """Lower the block's granted selections into the KernelPlan the
        decode step (or prefill chunk) executes, at the lowering width
        (:func:`_lower_width`)."""
        cfg = t.cfg
        lbm = [(s, p) for s, p in sched if s.candidate.kind == "LBM"]
        sel, pages = lbm[0] if lbm else sched[0]
        down_pages = None if lbm else (sched[-1][1] if len(sched) > 1
                                       else None)
        return lower_selection(
            sel, pages, seq_block=seq_block or max(self.batch, LANE),
            d_model=cfg.d_model, d_ff=_lower_width(cfg),
            dtype_bytes=_elem_bytes(cfg), head_dim=cfg.hd,
            ssm_chunk=cfg.ssm_chunk, down_pages=down_pages,
            kv_dtype=t.kv_dtype)

    def _schedule_epoch(self, t: Tenant, now: float,
                        k: int) -> Optional[KernelPlan]:
        """CaMDN selection + NEC charging for one tenant's epoch: the
        grant covers the whole K-step window, charged once with
        repeat=K.  Returns the plan the epoch executes (None for SSM
        decode, see :meth:`_dec_plan`)."""
        t.task.charge_repeat = k
        try:
            sched = self._schedule_block(t, now)
        finally:
            t.task.charge_repeat = 1
        plan = self._lower_plan(t, sched)
        t.plans.append(plan)
        return self._dec_plan(t, plan)

    def _dec_plan(self, t: Tenant, plan: KernelPlan) -> Optional[KernelPlan]:
        """The plan bound to the decode step: None for an SSM tenant,
        whose O(1) recurrent step has no FFN, and for an MoE tenant, whose
        one token runs the gathered-expert path (``moe._decode_moe``): a
        plan has no tiling freedom at one row.  The grant still governs
        the NEC charging and the recorded plan trace (and an SSM
        tenant's prefill)."""
        if t.cfg.family == "ssm" or t.cfg.is_moe:
            return None
        return plan

    def _chunk_align(self, cfg: ArchConfig) -> int:
        """Interior prefill-chunk boundaries stay on the LANE grid, and
        for SSM archs also on SSD chunk boundaries: lcm(LANE, ssm_chunk),
        the segmentation chunked == one-shot needs."""
        if cfg.family == "ssm" and cfg.ssm_chunk > 0:
            return LANE * cfg.ssm_chunk // math.gcd(LANE, cfg.ssm_chunk)
        return LANE

    def _plan_prefill_chunk(self, t: Tenant, now: float) -> Tuple:
        """Schedule one cache-aware prefill chunk: renegotiate the grant
        through the prefill-block MCT, lower it into a KernelPlan and
        that into the chunk length the grant admits."""
        sched = self._schedule_block(t, now, task=t.ptask)
        plan = self._lower_plan(t, sched, seq_block=self.prefill_block)
        t.plans.append(plan)
        chunk = lower_prefill_chunk(
            plan, d_model=t.cfg.d_model,
            d_ff=_ffn_width(t.cfg),
            dtype_bytes=_elem_bytes(t.cfg),
            align=self._chunk_align(t.cfg), max_tokens=self.prefill_block,
            remaining=t.prompt_len - t.pf_pos)
        t.chunks.append(chunk)
        return ("prefill", t, plan, chunk)

    def _finish_prefill(self, t: Tenant) -> None:
        """The final chunk's greedy token (already in the tenant's token
        buffer and log) flips the tenant to decode.  On the card a CUDA
        event marks the token for the TTFT stamp, which the caller takes
        after the epoch's decode work is queued; a quantized tenant's
        per-row scale maxima are taken on the device and copied to pinned
        host memory ahead of the event."""
        t.fed = True
        t.tokens_served += self.batch
        t.index = t.prompt_len
        t.ptask.depart()
        rows = self._scale_rows(t)
        if t.token.is_cuda:
            if rows is not None:
                t.scale_rows = torch.empty(rows.shape, dtype=rows.dtype,
                                           pin_memory=True)
                t.scale_rows.copy_(rows, non_blocking=True)
            t.first_token_event = torch.cuda.Event()
            t.first_token_event.record()
        else:
            t.scale_rows = rows

    def _stamp_ttft(self, t: Tenant) -> None:
        """The serving loop's one wait on the device: until the first
        token exists.  Then the page scales are recorded."""
        if t.first_token_event is not None:
            t.first_token_event.synchronize()
        t.ttft = time.time() - t.admitted_wall
        self._record_page_scales(t)

    def _scale_rows(self, t: Tenant) -> Optional[torch.Tensor]:
        """[pf_pos] fp32: each live prompt row's largest dequant scale
        over every layer's K and V, batch rows and KV heads; None for a
        native cache."""
        if t.kv_dtype == "native" or t.caches is None or t.pf_pos <= 0:
            return None
        leaves = torch.stack([c[name][:, :t.pf_pos] for c in t.caches
                              for name in ("k_scale", "v_scale")])
        return leaves.amax(dim=(0, 1, 3, 4))

    def _record_page_scales(self, t: Tenant) -> None:
        """Per-page dequant scales for a quantized tenant, recorded at the
        TTFT stamp (src/repro/launch/serve.py::_record_page_scales).  The
        modeled page table has no row map, so the live prefix rows fold
        onto the tenant's reserved pages by an even split; each page
        stores the max per-row scale it covers."""
        if t.scale_rows is None:
            return
        rows = t.scale_rows.numpy()
        t.scale_rows = None
        pages = sorted(self.cache.pages_of(t.tid + "#kv"))
        live, n = len(rows), len(pages)
        for j, p in enumerate(pages):
            lo = j * live // n
            hi = max(lo + 1, (j + 1) * live // n)
            self.cache.set_page_scale(p, float(rows[lo:hi].max()))

    def _prefill_whole(self, t: Tenant, now: float) -> None:
        """Sequential-admission baseline (and the serial loop's prompt
        path): the whole prompt prefills as one call, scheduled through
        the whole-prompt MCT, and decode waits behind it."""
        sched = self._schedule_block(t, now, task=t.ptask)
        plan = self._lower_plan(t, sched, seq_block=t.prompt_len)
        t.plans.append(plan)
        t.chunks.append(t.prompt_len)
        self._prefill_fn(t, t.prompt_len, self._kv_len(t.prompt_len))()
        t.pf_computed += t.prompt_len
        t.pf_pos = t.prompt_len
        self._finish_prefill(t)
        self._stamp_ttft(t)

    def _sequential_prefills_due(self, now: float) -> None:
        for t in self.tenants:
            if not t.departed and t.prefilling:
                self._prefill_whole(t, now)

    def _remaining(self, t: Tenant, steps: int) -> int:
        if t.budget_left is not None:
            return max(0, t.budget_left)
        return max(0, steps - t.run_steps)

    def _decodable(self, t: Tenant, steps: int) -> bool:
        """Active, past prefill, with budget/steps left — shared by
        admission gating, epoch planning and the serial loop."""
        return (not t.departed and t.fed
                and self._remaining(t, steps) > 0)

    def _epoch_k(self, t: Tenant, steps: int) -> int:
        """Decode window of the tenant's next epoch; an epoch never
        straddles a KV-window boundary, so all its steps share one
        kv_len."""
        k = min(self.epoch_len, self._remaining(t, steps),
                LANE - (t.index % LANE))
        assert t.index + k <= self.max_len, \
            f"{t.tid}: decode past max_len {self.max_len}"
        return k

    # --------------------------------------- batched Algorithm 1 --------
    def _plan_decode_run(self, run: List[Tenant], now: float, steps: int,
                         dec_plans: Dict[str, Tuple]) -> bool:
        """Batched Algorithm 1 over a contiguous run of decode tenants:
        simulate every tenant's grant sequence (one ``select_batch``
        pass per layer depth), price every layer in one vectorized NEC
        pass, then commit tenant-major in the per-tenant oracle's exact
        order — Selections and Traffic counters equal
        ``_schedule_epoch`` per tenant.  Any precondition miss returns
        False with nothing mutated; the caller falls back to the
        oracle."""
        if not isinstance(self.policy, CamdnPolicy):
            return False
        alloc = self.alloc
        if not alloc.quiescent():
            return False
        tasks: List[TenantTask] = []
        for t in run:
            task = t.task
            if task.held_pages != 0 or alloc.has_enabled_lbm(task.id):
                return False
            if not (task.done or task.layer_idx == 0):
                return False
            tasks.append(task)
        F = self.cache.free_pages
        n_layers = [task.model.num_layers for task in tasks]
        # --- pure simulation: all selections, layer by layer ----------
        sels: List[List[Selection]] = [[] for _ in run]
        flags = [False] * len(run)   # simulated per-tenant LBM flag
        held = [0] * len(run)        # pages held at each select point
        for l in range(max(n_layers)):
            idxs = [i for i in range(len(run)) if l < n_layers[i]]
            mcts = [tasks[i].model.mapping.mcts[l] for i in idxs]
            for i, mct in zip(idxs, mcts):
                if flags[i] and mct.lbm is None:
                    return False
            blocks = [tasks[i].model.mapping.block_of(l) for i in idxs]
            batch_sels = alloc.select_batch(
                [tasks[i].id for i in idxs], mcts, now,
                [tasks[i].model.layer_t_est[l] for i in idxs],
                [tasks[i].model.block_t_est[b]
                 for i, b in zip(idxs, blocks)],
                [tasks[i].model.mapping.is_head_of_block(l) for i in idxs],
                lbm_enabled=[flags[i] for i in idxs])
            for i, blk, sel in zip(idxs, blocks, batch_sels):
                if max(held[i], sel.p_cur) > F:
                    # the oracle would enter its timeout-downgrade loop
                    return False
                sels[i].append(sel)
                if sel.candidate.kind == "LBM" and l < blk[1] - 1:
                    flags[i], held[i] = True, max(held[i], sel.p_cur)
                else:
                    flags[i], held[i] = False, 0
        ks = [self._epoch_k(t, steps) for t in run]
        # --- one vectorized pricing pass over every (tenant, layer) ---
        items = [(tasks[i], sels[i][l].candidate, l)
                 for i in range(len(run)) for l in range(n_layers[i])]
        priced = price_layer_batch(items, self.policy._price_cache)
        # --- tenant-major commit: the oracle's exact order ------------
        self._batched_runs += 1
        pos = 0
        for i, t in enumerate(run):
            task = tasks[i]
            if task.done:
                task.reset_for_next_inference()
            task.charge_repeat = ks[i]
            sched: List[Tuple[Selection, int]] = []
            try:
                for l in range(n_layers[i]):
                    sel = sels[i][l]
                    task.selection = sel
                    granted = self.cache.alloc(
                        task.id, max(0, sel.p_cur - task.held_pages))
                    assert granted is not None, \
                        f"{task.id}: batched grant infeasible at layer {l}"
                    task.adopt_grant(sel, granted)
                    cand = sel.candidate
                    # CamdnPolicy.on_grant's LBM side effect
                    if (cand.kind == "LBM"
                            and not alloc.has_enabled_lbm(task.id)):
                        alloc.set_lbm(task.id, True)
                        task.lbm_block = task.model.mapping.block_of(l)
                    task.charge(priced[pos + l][1])
                    sched.append((task.selection, task.held_pages))
                    t.choices.append(f"{cand.kind}:{task.held_pages}p")
                    task.end_layer(now)
            finally:
                task.charge_repeat = 1
            pos += n_layers[i]
            plan = self._lower_plan(t, sched)
            t.plans.append(plan)
            dec_plans[t.tid] = (self._dec_plan(t, plan), ks[i])
        return True

    def _plan_epoch(self, now: float, steps: int) -> List[Tuple]:
        """Timed wrapper around the epoch planner (host scheduling wall,
        admission apart)."""
        t0 = time.perf_counter()
        a0 = self._admit_wall
        try:
            return self._plan_epoch_inner(now, steps)
        finally:
            adm = self._admit_wall - a0
            self._sched_walls.append(time.perf_counter() - t0 - adm)
            self._admit_walls.append(adm)

    def _plan_epoch_inner(self, now: float, steps: int) -> List[Tuple]:
        """Host-side scheduling for one epoch: admit due arrivals, retire
        exhausted tenants, then select + charge every active tenant's
        work — a prefill chunk for tenants still consuming their prompt,
        a K-step decode window for the rest (worst QoS slack first).
        Decode tenants whose (arch, plan, index, k) coincide form one
        "bucket" item.  Contiguous runs of decode tenants go through the
        batched Algorithm 1 when its preconditions hold, else through
        the per-tenant oracle."""
        while True:
            self._admit_due(steps)
            self._process_departures()
            if not self.pipeline or self.admission == "sequential":
                self._sequential_prefills_due(now)
            active = [t for t in self.tenants if not t.departed]
            order = active
            if self.qos_targets:
                order = sorted(active, key=lambda t: self._slack(t, now))
            pf_items: Dict[str, Tuple] = {}
            dec_plans: Dict[str, Tuple[Optional[KernelPlan], int]] = {}
            i = 0
            while i < len(order):
                t = order[i]
                if t.prefilling:
                    pf_items[t.tid] = self._plan_prefill_chunk(t, now)
                    i += 1
                    continue
                if not self._decodable(t, steps):
                    i += 1
                    continue
                # maximal contiguous run of decode tenants
                j = i
                run: List[Tenant] = []
                while (j < len(order) and not order[j].prefilling
                       and self._decodable(order[j], steps)):
                    run.append(order[j])
                    j += 1
                if not (self.batch_sched
                        and self._plan_decode_run(run, now, steps,
                                                  dec_plans)):
                    self._oracle_runs += 1
                    for g in run:
                        k = self._epoch_k(g, steps)
                        dec_plans[g.tid] = (self._schedule_epoch(g, now, k),
                                            k)
                i = j
            work: List[Tuple] = []
            seen = set()
            for t in self.tenants:
                if t.tid in seen or t.departed:
                    continue
                if t.tid in pf_items:
                    work.append(pf_items[t.tid])
                    seen.add(t.tid)
                    continue
                if t.tid not in dec_plans:
                    continue
                plan, k = dec_plans[t.tid]
                group = self._groups[t.cfg.name]
                bucketable = (
                    len(group) >= 2
                    and all(g.tid in dec_plans for g in group)
                    and all(dec_plans[g.tid] == (plan, k) for g in group)
                    and len({g.index for g in group}) == 1
                    and len({g.kv_dtype for g in group}) == 1)
                if bucketable:
                    work.append(("bucket", group, plan, k))
                    seen.update(g.tid for g in group)
                else:
                    work.append(("single", t, plan, k))
                    seen.add(t.tid)
            self._clock += self.epoch_len
            if work:
                return work
            # idle gap: fast-forward to the next queued arrival
            wake = [it[2] for it in self._queue]
            if not wake:
                return work
            self._clock = max(self._clock, min(wake))

    # ------------------------------------------------------- execution --
    def _advance(self, t: Tenant, k: int) -> None:
        t.index += k
        t.tokens_served += self.batch * k
        t.epochs_served += 1
        t.run_steps += k
        if t.state == STATE_ADMITTED:
            t.state = STATE_RUNNING
        if t.budget_left is not None:
            t.budget_left -= k

    def _kv_len(self, upto: int) -> int:
        """Attention-read bound for decode indices < ``upto``: the live
        prefix rounded up to the 128-token window step, clamped to the
        cache — shared by the serial and pipelined loops, so
        corresponding steps see identical attention shapes."""
        return min(self.max_len, -(-max(1, upto) // LANE) * LANE)

    def _feed(self, t: Tenant, toks: torch.Tensor, advance: int) -> None:
        """Device side of a dispatch: ``toks`` [B, n], the tokens decoded
        at the last n of the ``advance`` positions from the tenant's
        device position on, go to the log at those positions; the last
        becomes the feedback token, and the position moves on.  Runs
        inside a captured graph as well as eagerly."""
        n = toks.shape[1]
        pos = t.index_dev + (advance - n) + torch.arange(n,
                                                         device=toks.device)
        t.log.index_copy_(1, pos, toks)
        t.token.copy_(toks[:, -1:])
        t.index_dev += advance

    def _prefill_body(self, t: Tenant, chunk: int, kv: int) -> None:
        """One prompt chunk at the tenant's device position: its tokens
        are gathered from the prompt there, run through the prefill core,
        and the chunk's greedy token is fed."""
        pos = t.index_dev + torch.arange(chunk, device=t.index_dev.device)
        tok, _ = self._prefill_cores[t.cfg.name](
            t.params, t.caches, t.prompt_dev.index_select(1, pos),
            t.index_dev, kv_len=kv)
        self._feed(t, tok, chunk)

    def _prefill_fn(self, t: Tenant, chunk: int, kv: int) -> _CompiledEntry:
        """The program of one (tenant, chunk length, kv window) prompt
        chunk, from the prefill LRU (built and, on the card, captured on
        a miss).  The reference keeps one jit per arch, whose own cache
        keys (chunk, kv); a graph also binds the tenant."""
        key = (t.tid, chunk, kv)
        entry = self._prefill_jits.get(key)
        if entry is None:
            entry = self._compile(
                lambda: self._prefill_body(t, chunk, kv),
                ("prefill", t.cfg.name, t.kv_dtype, chunk, kv), [t], chunk)
            self._prefill_jits[key] = entry
        return entry

    def _dispatch_prefill(self, item: Tuple) -> Optional[Tenant]:
        """Queue one prefill chunk on the device (one replay).  Returns
        the tenant when this was its prompt's final chunk."""
        _, t, _, chunk = item
        self._prefill_fn(t, chunk, self._kv_len(t.pf_pos + chunk))()
        t.pf_pos += chunk
        t.pf_computed += chunk
        if not t.prefilling:
            self._finish_prefill(t)
            return t
        return None

    # --------------------------------------------------- decode programs --
    def _item_kv(self, item: Tuple) -> int:
        t0 = item[1][0] if item[0] == "bucket" else item[1]
        return self._kv_len(t0.index + item[3])

    def _fused_key(self, item: Tuple) -> Tuple:
        """The program key of one decode item: the reference's per-item
        (kind, arch, plan, k, kv) plus the ids of the tenants it decodes,
        whose buffers the graph binds."""
        kind, who, plan, k = item
        group = who if kind == "bucket" else [who]
        return (kind, group[0].cfg.name, plan, k, self._item_kv(item),
                tuple(g.tid for g in group))

    def _batched_params(self, group: List[Tenant]) -> List[Any]:
        """The bucket's params, one entry per tenant: not stacked (a
        stacked copy of full-width tenants would not fit on the card)."""
        return [g.params for g in group]

    def _decode_fn(self, key: Tuple) -> Callable[[], None]:
        """The device work of one decode item, from its key alone (so
        ``warm_aot`` can build programs for predicted keys): one tenant's
        epoch, or a bucket's through the batched epoch, each tenant's
        tokens fed to its own buffers."""
        kind, name, plan, k, kv, tids = key
        live = {t.tid: t for t in self.tenants if not t.departed}
        group = [live[tid] for tid in tids]
        if kind == "bucket":
            core = self._batched_cores.setdefault(
                name, M.make_decode_epoch_batched(group[0].cfg))
            params = self._batched_params(group)

            def run() -> None:
                toks, _ = core(params, [g.caches for g in group],
                               torch.stack([g.token for g in group]),
                               torch.stack([g.index_dev for g in group]),
                               plan=plan, k=k, kv_len=kv)
                for g, tk in zip(group, toks):
                    self._feed(g, tk, k)
            return run
        t = group[0]
        core = self._epoch_cores[name]

        def run() -> None:
            toks, _ = core(t.params, t.caches, t.token, t.index_dev,
                           plan=plan, k=k, kv_len=kv)
            self._feed(t, toks, k)
        return run

    def _build_entry(self, key: Tuple) -> _CompiledEntry:
        live = {t.tid: t for t in self.tenants if not t.departed}
        group = [live[tid] for tid in key[5]]
        sig = key[:5] + (len(group), group[0].kv_dtype)
        return self._compile(self._decode_fn(key), sig, group, key[3])

    def _fused_epoch_fn(self, item: Tuple) -> _CompiledEntry:
        """The program of one decode item (single tenant or bucket), from
        the decode LRU: in steady state the grants repeat and every item
        is a hit.  The reference fuses all of an epoch's decode items into
        one program; here each item is its own graph (see the module
        docstring)."""
        key = self._fused_key(item)
        entry = self._fused_jits.get(key)
        if entry is None:
            entry = self._build_entry(key)
            self._fused_jits[key] = entry
        return entry

    def compile_misses(self) -> int:
        """Decode plus prefill program builds so far (each a capture on
        the card)."""
        return self._fused_jits.misses + self._prefill_jits.misses

    # ----------------------------------------------------------- capture --
    def _device_pos(self, t: Tenant) -> int:
        """The tenant's device position, as the host knows it."""
        return t.index if t.fed else t.pf_pos

    def _warm_up(self, fn: Callable[[], None], tenants: List[Tenant],
                 advance: int) -> None:
        """Run ``fn`` once eagerly on the tenants' own buffers, on the
        current (capture) stream, and put back what it changed that is
        read before it is written: the feedback tokens, the positions and
        an SSM tenant's recurrent state.  The KV rows and log entries it
        writes lie in [position, position + advance), which the replay
        writes again before anything reads them.  Its launches are not
        counted."""
        for t in tenants:
            if self._device_pos(t) + advance > self.max_len:
                raise ValueError(f"{t.tid}: warm-up at position "
                                 f"{self._device_pos(t)} + {advance} past "
                                 f"max_len {self.max_len}")
        bufs = [b for t in tenants for b in
                [t.token, t.index_dev] + ([leaf for c in t.caches
                                           for leaf in c.values()]
                                          if t.cfg.family == "ssm" else [])]
        saved = [b.clone() for b in bufs]
        before = kcount.snapshot()
        fn()
        kcount.add(kcount.delta(before), -1)
        for b, v in zip(bufs, saved):
            b.copy_(v)

    def _compile(self, fn: Callable[[], None], sig: Tuple,
                 tenants: List[Tenant], advance: int) -> _CompiledEntry:
        """One program: the eager closure where the server captures
        nothing, else ``fn`` captured into a CUDA graph on the server's
        capture stream and memory pool, after a warm-up where ``sig`` has
        none yet.  The launches the capture counted are taken back and
        kept for the replays.  A failure raises."""
        if not self._capture_graphs:
            return _CompiledEntry(fn)
        t0 = time.perf_counter()
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
        stream = self._capture_stream
        main = torch.cuda.current_stream(self.device)
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            if sig not in self._warm_sigs:
                w0 = time.perf_counter()
                self._warm_up(fn, tenants, advance)
                self._warm_sigs.add(sig)
                self._warmups += 1
                self._warmup_s += time.perf_counter() - w0
            graph = torch.cuda.CUDAGraph()
            before = kcount.snapshot()
            graph.capture_begin(pool=self._graph_pool)
            try:
                fn()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass   # the capture is invalid already; report fn's error
                raise
            graph.capture_end()
            launches = kcount.delta(before)
            kcount.add(launches, -1)
        main.wait_stream(stream)
        if self._graph_pool is None:
            self._graph_pool = graph.pool()
        self._captures += 1
        self._capture_s += time.perf_counter() - t0
        return _CompiledEntry(fn, graph, launches)

    # ------------------------------------------ AOT program precompile --
    def _simulate_block_sels(self, task: TenantTask, now: float,
                             budget: int) -> Optional[List[Selection]]:
        """Pure what-if Algorithm 1 walk of one task's whole graph under a
        FIXED page budget (copied from the reference): the grant sequence
        the task would receive with ``budget`` pages available
        throughout.  None when some layer cannot fit even its smallest
        candidate."""
        sels: List[Selection] = []
        flag, held = False, 0
        mapping = task.model.mapping
        for l in range(task.model.num_layers):
            mct = mapping.mcts[l]
            blk = mapping.block_of(l)
            if flag and mct.lbm is None:
                return None   # same bail as the batched planner
            if flag:
                sel = Selection(mct.lbm, mct.lbm.p_need, INF)
            elif (mapping.is_head_of_block(l) and mct.lbm is not None
                    and mct.lbm.p_need < budget):
                sel = Selection(
                    mct.lbm, mct.lbm.p_need,
                    now + task.model.block_t_est[blk] * AHEAD_FRACTION)
            else:
                m = mct.best_fit(budget)
                sel = Selection(
                    m, m.p_need,
                    now + task.model.layer_t_est[l] * AHEAD_FRACTION)
            if max(held, sel.p_cur) > budget:
                return None
            sels.append(sel)
            if sel.candidate.kind == "LBM" and l < blk[1] - 1:
                flag, held = True, max(held, sel.p_cur)
            else:
                flag, held = False, 0
        return sels

    def _enumerate_epoch_keys(self, steps: int) -> List[Tuple]:
        """Predicted epoch keys for this run (the reference's walk): each
        tenant's (k, kv) decode trajectory from its current position
        (prefill epochs delay the start), its grant plan under the
        current free pool, composed per epoch in tenant order with the
        planner's bucketing predicate.  Each item is a program key of
        :meth:`_fused_key`: the reference's item plus its tenant ids."""
        preds: Dict[str, Tuple] = {}
        for t in self.tenants:
            if t.departed:
                continue
            sims = self._simulate_block_sels(t.task, 0.0,
                                             self.cache.free_pages)
            if sims is None:
                continue
            plan = self._dec_plan(
                t, self._lower_plan(t, [(s, s.p_cur) for s in sims]))
            start, idx = 0, t.index
            if t.prompt is not None and not t.fed:
                start = -(-(t.prompt_len - t.pf_pos) // self.prefill_block)
                idx = t.prompt_len
            rem = t.budget_left if t.budget_left is not None else steps
            traj: List[Tuple[int, int]] = []
            while rem > 0 and idx < self.max_len and len(traj) < 64:
                k = min(self.epoch_len, rem, LANE - (idx % LANE))
                if idx + k > self.max_len:
                    break
                traj.append((k, self._kv_len(idx + k)))
                idx += k
                rem -= k
            preds[t.tid] = (plan, start, traj)
        horizon = max((start + len(traj)
                       for _, start, traj in preds.values()), default=0)
        keys: List[Tuple] = []
        seen = set()
        for e in range(min(horizon, 128)):
            per_tenant: Dict[str, Tuple] = {}
            for tid, (plan, start, traj) in preds.items():
                if start <= e < start + len(traj):
                    per_tenant[tid] = (plan,) + traj[e - start]
            if not per_tenant:
                continue
            key_items: List[Tuple] = []
            done = set()
            for t in self.tenants:
                if t.tid in done or t.tid not in per_tenant:
                    continue
                plan, k, kv = per_tenant[t.tid]
                group = self._groups[t.cfg.name]
                bucketable = (
                    len(group) >= 2
                    and all(g.tid in per_tenant for g in group)
                    and all(per_tenant[g.tid] == (plan, k, kv)
                            for g in group)
                    and len({g.kv_dtype for g in group}) == 1)
                if bucketable:
                    key_items.append(("bucket", t.cfg.name, plan, k, kv,
                                      tuple(g.tid for g in group)))
                    done.update(g.tid for g in group)
                else:
                    key_items.append(("single", t.cfg.name, plan, k, kv,
                                      (t.tid,)))
                    done.add(t.tid)
            key = tuple(key_items)
            if key and key not in seen:
                seen.add(key)
                keys.append(key)
        return keys

    def warm_aot(self, steps: int) -> None:
        """Build (on the card: capture) the program of every decode item
        of the predicted epochs before they exist, on the run's own
        thread (the reference compiles on a daemon thread; a capture
        beside live launches on the same card is not taken here).  A
        prediction miss costs one unused capture; a hit means the epoch
        finds its graph ready.  A failure raises."""
        if not (self.pipeline and self.aot_warmup):
            return
        for epoch_key in self._enumerate_epoch_keys(steps):
            for key in epoch_key:
                if self._fused_jits.peek(key) is None:
                    entry = self._build_entry(key)
                    entry.aot = True
                    self._fused_jits[key] = entry
                    self._aot_compiled += 1

    def _dispatch_epoch(self, work: List[Tuple]) -> None:
        """Timed wrapper around the epoch dispatcher (the dispatch wall:
        host time to queue the epoch's device work), with the epoch's
        program builds (LRU misses)."""
        t0 = time.perf_counter()
        m0 = self.compile_misses()
        try:
            self._dispatch_epoch_inner(work)
        finally:
            self._device_walls.append(time.perf_counter() - t0)
            self._epoch_compiles.append(self.compile_misses() - m0)

    def _dispatch_epoch_inner(self, work: List[Tuple]) -> None:
        """Queue one epoch's work: the prefill chunks first, then every
        decode item, one program each (a bucket's tenants in one).
        Nothing here waits for the device except the TTFT stamps, taken
        last."""
        finished = []
        for item in work:
            if item[0] == "prefill":
                done = self._dispatch_prefill(item)
                if done is not None:
                    finished.append(done)
        for item in work:
            if item[0] == "prefill":
                continue
            self._fused_epoch_fn(item)()
            kind, who, _, k = item
            for t in (who if kind == "bucket" else [who]):
                self._advance(t, k)
        for t in finished:
            self._stamp_ttft(t)

    def _serve_one_step(self, t: Tenant, now: float) -> None:
        """Serial reference: schedule, charge, lower and run ONE decode
        step, eagerly, on the tenant's buffers."""
        assert t.index < self.max_len, \
            f"{t.tid}: decode past max_len {self.max_len}"
        sched = self._schedule_block(t, now)
        plan = self._lower_plan(t, sched)
        t.plans.append(plan)
        kv = self._kv_len(t.index + 1)
        nxt, _ = t.decode(t.params, t.caches, t.token, t.index_dev,
                          plan=self._dec_plan(t, plan), kv_len=kv)
        self._feed(t, nxt[:, None], 1)
        self._advance(t, 1)

    def _resolve_qos(self, tid: str) -> Optional[float]:
        """Most-specific QoS match: the longest pattern key contained in
        the tenant id wins."""
        target, best_len = None, -1
        for k, v in self.qos_targets.items():
            if k in tid and len(k) > best_len:
                target, best_len = v, len(k)
        return target

    def _slack(self, t: Tenant, now: float) -> float:
        """QoS slack as a fraction of the target rate (negative = late),
        seeded at the target (0.0) until the tenant has served."""
        target = t.qos_target
        if target is None:
            return float("inf")
        if t.tokens_served == 0 or now <= 0.0:
            return 0.0
        rate = t.tokens_served / now
        want = self.batch / target
        return (rate - want) / want

    # ------------------------------------------------------------ run --
    def _begin_run(self, steps: int) -> None:
        self._run_t0 = time.time()
        self._sched_walls = []
        self._device_walls = []
        self._admit_walls = []
        self._admit_wall = 0.0
        self._epoch_compiles = []
        self._batched_runs = 0
        self._oracle_runs = 0
        self._run_steps = steps
        for t in self.tenants:
            t.run_steps = 0
            if t.admitted_wall is None or t.tokens_served == 0:
                t.admitted_wall = self._run_t0
        self._run_tokens_before = sum(t.tokens_served for t in self.tenants)

    def run(self, steps: int = 16) -> Dict[str, Any]:
        self._begin_run(steps)
        t0 = self._run_t0
        if self.pipeline:
            self.warm_aot(steps)   # no-op unless aot_warmup
            pending = self._plan_epoch(0.0, steps)
            while pending:
                self._dispatch_epoch(pending)
                # the epoch is still running on the device (replays and
                # launches are asynchronous): plan the next one now
                pending = self._plan_epoch(time.time() - t0, steps)
        else:
            while True:
                now = time.time() - t0
                self._admit_due(steps)
                self._process_departures()
                self._sequential_prefills_due(now)
                runnable = [t for t in self.tenants
                            if self._decodable(t, steps)]
                if not runnable:
                    wake = [it[2] for it in self._queue]
                    if wake:
                        self._clock = max(self._clock + 1, min(wake))
                        continue
                    break
                order = runnable
                if self.qos_targets:
                    order = sorted(runnable,
                                   key=lambda t: self._slack(t, now))
                for t in order:
                    self._serve_one_step(t, now)
                self._clock += 1
        return self._finish_run()

    def _finish_run(self) -> Dict[str, Any]:
        """Wait for the device once, then read every output back."""
        t0 = self._run_t0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.time() - t0
        served = (sum(t.tokens_served for t in self.tenants)
                  - self._run_tokens_before)
        ttfts = [t.ttft for t in self.tenants
                 if t.ttft is not None and t.admitted_wall is not None
                 and t.admitted_wall >= t0]
        sched = float(sum(self._sched_walls))
        device = float(sum(self._device_walls))
        return {
            "tenants": {
                t.tid: {"tokens": t.tokens_served,
                        "choices": t.choices[-4:],
                        "plans": [p.describe() for p in t.plans[-4:]],
                        "lbm_frac": (sum(c.startswith("LBM")
                                         for c in t.choices)
                                     / max(1, len(t.choices))),
                        "prompt_len": t.prompt_len,
                        "prefill_chunks": list(t.chunks),
                        "ttft_s": t.ttft,
                        "departed": t.departed,
                        "kv_wanted": t.kv_wanted,
                        "kv_reserved": t.kv_reserved,
                        "kv_dtype": t.kv_dtype,
                        "prefill_computed": t.pf_computed,
                        "state": t.state,
                        "output": (self._served(t) if t.log is not None
                                   else t.outputs).cpu().numpy().astype(
                                       np.int32)}
                for t in self.tenants
            },
            "mode": "pipelined" if self.pipeline else "serial",
            "admission": self.admission if self.pipeline else "sequential",
            "epoch_len": self.epoch_len if self.pipeline else 1,
            "wall_s": wall,
            "dram_bytes": self.nec.traffic.dram_total,
            "tokens_served": served,
            "page_util": self.page_utilization(),
            "tokens_per_s": served / wall if wall > 0 else 0.0,
            "prefill_tokens": sum(t.pf_pos for t in self.tenants),
            "prefill_computed": sum(t.pf_computed for t in self.tenants),
            "p95_ttft_s": (float(np.percentile(ttfts, 95)) if ttfts
                           else None),
            "host": {
                "epochs": len(self._device_walls),
                "sched_wall_s": sched,
                "device_wall_s": device,
                "admit_wall_s": float(sum(self._admit_walls)),
                "sched_frac": sched / device if device > 0 else 0.0,
                "epoch_sched_walls": [round(x, 6) for x in self._sched_walls],
                "epoch_device_walls": [round(x, 6)
                                       for x in self._device_walls],
                "epoch_compiles": list(self._epoch_compiles),
                "batched_runs": self._batched_runs,
                "oracle_runs": self._oracle_runs,
                "aot_compiled": self._aot_compiled,
                # the reference counts the warm-up failures its daemon
                # thread swallows; here a failure raises
                "aot_failed": 0,
                "aot_hits": sum(self._fused_jits.peek(k).aot_hits
                                for k in self._fused_jits.keys()),
                # since construction: captures (graphs built) and their
                # host seconds (warm-ups included; the warm-ups apart), and
                # the entries a departure evicted
                "captures": self._captures,
                "capture_s": self._capture_s,
                "warmups": self._warmups,
                "warmup_s": self._warmup_s,
                "departure_evictions": self._depart_evictions,
                "jit_cache": {
                    "fused": {"hits": self._fused_jits.hits,
                              "misses": self._fused_jits.misses,
                              "evictions": self._fused_jits.evictions},
                    "prefill": {"hits": self._prefill_jits.hits,
                                "misses": self._prefill_jits.misses,
                                "evictions": self._prefill_jits.evictions},
                },
            },
        }


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """The reference's serving CLI (src/repro/launch/serve.py::main): the
    same flags, defaults and printed ``[serve]`` lines, on the port's
    server.  Added: ``--device`` (default ``cuda``) and ``--full-width``
    (serve the full-width configs; the reference serves the reduced
    ones).  ``--devices`` (fleet mode) and ``--lookahead`` raise
    ``NotImplementedError``.  Returns the run's result.

        python -m repro_torch.launch.serve --full-width
    """
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", nargs="+",
                    default=["yi-9b", "olmoe-1b-7b", "mamba2-370m"])
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--pages", type=int, default=128)
    ap.add_argument("--epoch-len", type=int, default=8,
                    help="decode steps per scheduling epoch (grant hold)")
    ap.add_argument("--serial", action="store_true",
                    help="serial reference loop (schedule+dispatch per step)")
    ap.add_argument("--arrivals", type=int, default=0,
                    help="Poisson arrivals joining mid-run with prompts")
    ap.add_argument("--arrival-rate", type=float, default=0.5,
                    help="arrivals per logical second (steps_per_s=1)")
    ap.add_argument("--prompt-len", type=int, default=256,
                    help="prompt tokens per arriving tenant")
    ap.add_argument("--decode-budget", type=int, default=16,
                    help="decode steps an arrival serves before departing")
    ap.add_argument("--admission", choices=["interleaved", "sequential"],
                    default="interleaved")
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--kv-dtype", default="native",
                    choices=list(KV_PRECISION_LADDER) + ["auto"],
                    help="KV cache storage precision (auto: downgrade "
                         "per admission when the pool is tight)")
    ap.add_argument("--devices", type=int, default=0,
                    help="fleet mode (not yet ported: raises)")
    ap.add_argument("--oracle-sched", action="store_true",
                    help="force the per-tenant Algorithm 1 oracle "
                         "(disable the batched epoch planner)")
    ap.add_argument("--lookahead", action="store_true",
                    help="predictive grant lookahead (not yet ported: "
                         "raises)")
    ap.add_argument("--aot", action="store_true",
                    help="capture the predicted decode programs before "
                         "the first epoch")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on")
    ap.add_argument("--full-width", action="store_true",
                    help="serve the full-width configs (default: reduced)")
    args = ap.parse_args(argv)
    if args.devices > 0:
        raise NotImplementedError("fleet mode (--devices) not yet ported")
    arrivals = None
    if args.arrivals > 0:
        arrivals = PoissonArrivals(
            rate_per_s=args.arrival_rate, models=args.archs,
            n_arrivals=args.arrivals, n_inferences=args.decode_budget,
            prompt_len=args.prompt_len)
    srv = MultiTenantServer(args.archs, total_pages=args.pages,
                            epoch_len=args.epoch_len,
                            pipeline=not args.serial,
                            max_len=args.max_len,
                            arrivals=arrivals,
                            admission=args.admission,
                            kv_dtype=args.kv_dtype,
                            batch_sched=not args.oracle_sched,
                            lookahead=args.lookahead,
                            aot_warmup=args.aot,
                            device=args.device,
                            reduced=not args.full_width)
    out = srv.run(args.steps)
    for tid, info in out["tenants"].items():
        ttft = (f", TTFT {info['ttft_s'] * 1e3:.0f}ms "
                f"(chunks {info['prefill_chunks']})"
                if info["ttft_s"] is not None else "")
        kv = ""
        if info["kv_wanted"]:
            kv = f", kv {info['kv_reserved']}/{info['kv_wanted']}p"
            if info["kv_dtype"] != "native":
                kv += f" @{info['kv_dtype']}"
            if info["kv_reserved"] < info["kv_wanted"]:
                kv += " (degraded)"
        print(f"[serve] {tid}: {info['tokens']} tokens, "
              f"LBM {info['lbm_frac'] * 100:.0f}%, recent {info['choices']}, "
              f"plans {info['plans']}{ttft}{kv}")
    p95 = (f", p95 TTFT {out['p95_ttft_s'] * 1e3:.0f}ms"
           if out["p95_ttft_s"] is not None else "")
    print(f"[serve] {out['mode']}/{out['admission']} "
          f"(K={out['epoch_len']}): {out['tokens_per_s']:.1f} tok/s total, "
          f"{out['prefill_tokens']} prompt tokens{p95}, "
          f"{out['dram_bytes'] / 2**20:.1f} MB modeled DRAM")
    host = out.get("host") or {}
    if host.get("epochs"):
        print(f"[serve] host: sched {host['sched_wall_s'] * 1e3:.1f}ms vs "
              f"device {host['device_wall_s'] * 1e3:.1f}ms "
              f"({host['sched_frac'] * 100:.1f}%), "
              f"{host['batched_runs']} batched / {host['oracle_runs']} "
              f"oracle runs, compiles/epoch {host['epoch_compiles']}, "
              f"aot {host['aot_compiled']} compiled "
              f"({host['aot_hits']} hits)")
    return out


if __name__ == "__main__":
    main()
