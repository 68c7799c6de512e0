"""Multi-tenant serving driver, dense subset (port of
src/repro/launch/serve.py::MultiTenantServer).

Several dense-LM tenants share one device.  Each tenant's FFN block is a
small :class:`~repro_torch.core.types.ModelGraph` mapped by the CaMDN
core (LWM tile candidates per usage limit plus the fused-block LBM
candidate), and every epoch the same :class:`TenantTask` /
:class:`CamdnPolicy` state machine as the reference grants pages from
the modeled page pool.  The grant lowers to a KernelPlan, and the plan
decides which Hopper kernel each decode step's FFNs run:

  pages granted -> candidate (LBM block_fused_ffn vs LWM cache_matmul
  tiles) -> decode.

The scheduling side is the reference's, line for line, on the copied
core: the grant, plan and NEC traces of a scenario equal the
reference's.  The one difference, the LBM time cap, binds only at full
width (``_LBM_CONFIG``).  What this port keeps: the serial
(``pipeline=False``) and epoch-pipelined loops, interleaved and sequential admission,
grant-sized prefill chunks, the ``kv_len`` attention windows, KV page
reservations and departures, QoS ordering, and the batched Algorithm 1
planner (``batch_sched``).

Execution is eager PyTorch.  Tokens and caches stay on the device
through the loop, and nothing is read back to the host except at the
TTFT stamp of a tenant's first token (and once after the run).  The
epoch's work list keeps the reference's "bucket" items; this slice runs
a bucket's tenants one after another, each through its own epoch.
Not ported here (raising ``NotImplementedError``): device meshes,
prefix dedup, quantized KV, fault injection and preemption, overload
admission, AOT warmup and grant lookahead.

Entry points run on ``device="cuda"`` unless the caller asks for the
CPU.  Without injected params / prompts the server draws params from a
seeded ``torch.Generator`` and prompts from ``np.random.default_rng``
(the reference's threefry draws cannot be reproduced); parity tests
inject the reference's through ``params_fn`` / ``prompt_fn``.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.allocator import Selection
from repro_torch.core.cache import CacheConfig
from repro_torch.core.lbm import LbmConfig, build_model_mapping
from repro_torch.core.mapping import MapperConfig
from repro_torch.core.mct import MCT, ModelMapping
from repro_torch.core.plan import KernelPlan, lower_prefill_chunk
from repro_torch.core.policy import (CamdnPolicy, ReplicaControl,
                                     price_layer_batch)
from repro_torch.core.runtime import (STATE_ADMITTED, STATE_RUNNING,
                                      TenantModel, TenantTask)
from repro_torch.core.types import (GemmDims, LayerKind, LayerSpec, ModelGraph,
                                    ceil_div, elem_bytes)
from repro_torch.core.vmem import (LANE, PAGE_BYTES, VMEM_PAGES,
                                   fused_ffn_pages, kv_row_bytes,
                                   lower_selection)
from repro_torch.models import model as M
from repro_torch.models.base import ArchConfig, get_arch
from repro_torch.models.transformer import init_caches, num_groups
from repro_torch.sim.driver import PoissonArrivals, TenantSpec

ParamsFn = Callable[[ArchConfig, int], Any]
PromptFn = Callable[[TenantSpec, int, ArchConfig, int], np.ndarray]


def _elem_bytes(cfg: ArchConfig) -> int:
    return elem_bytes(cfg.dtype)


def _ffn_graph(name: str, cfg: ArchConfig, seq_block: int) -> ModelGraph:
    """One transformer layer's FFN as a schedulable layer graph (gate/up
    -> down), padded to the 128-lane tile the plans are sized on."""
    eb = _elem_bytes(cfg)
    seq_block = max(seq_block, LANE)
    d, f = cfg.d_model, max(cfg.d_ff, cfg.d_model)
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


# The one scheduling difference from the reference.  LBM segmentation caps
# a block's modeled time at 2 ms of the paper's NPU (25.6 GB/s per
# stream).  At full width every FFN block models far above it (yi-9b:
# 17 ms), so the cap would leave no LBM candidate, and no fused kernel,
# on the full-width serving path.  The port keeps the page cap and lifts
# the time cap.  At the reduced widths a block models at microseconds,
# the cap never binds, and the trace equals the reference's
# (tests/test_torch_serve.py).
_LBM_CONFIG = LbmConfig(time_cap_s=math.inf)


def _tenant_model(graph: ModelGraph, mapper: MapperConfig) -> TenantModel:
    return TenantModel(graph, mapper,
                       mapping=build_model_mapping(graph, mapper, _LBM_CONFIG))


def _kv_reserve_pages(cfg: ArchConfig, batch: int, tokens: int) -> int:
    """Pages an admitted prompt tenant reserves for its KV working set
    (held until departure).  Dense archs, native KV only: every layer
    caches K and V rows at the compute dtype."""
    row = kv_row_bytes(cfg.num_kv_heads, cfg.hd, _elem_bytes(cfg))
    kv = num_groups(cfg) * batch * tokens * row
    return ceil_div(kv, PAGE_BYTES) if tokens > 0 else 0


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


@dataclasses.dataclass
class Tenant:
    tid: str
    cfg: ArchConfig
    params: Any
    caches: Any
    decode: Any        # one-step closure (serial reference path)
    task: TenantTask
    token: Any         # [B, 1] device tensor: next input (feedback);
    #                    None until a prompt tenant finishes prefill
    index: int = 0
    tokens_served: int = 0
    epochs_served: int = 0
    choices: List[str] = dataclasses.field(default_factory=list)
    plans: List[KernelPlan] = dataclasses.field(default_factory=list)
    # decoded tokens, one [B, k] device tensor per epoch — read back to
    # the host once, after the serving loop finishes
    outputs: List[Any] = dataclasses.field(default_factory=list)
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
    pf_computed: int = 0                  # prompt tokens prefilled
    state: str = STATE_ADMITTED

    @property
    def prefilling(self) -> bool:
        return self.prompt is not None and self.pf_pos < self.prompt_len


class MultiTenantServer:
    """Decode across dense tenants with CaMDN page arbitration.

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
                ("aot_warmup", aot_warmup, False),
                ("faults", faults, None),
                ("queue_limit", queue_limit, None),
                ("queue_deadline_s", queue_deadline_s, None)):
            if value != off:
                raise NotImplementedError(f"{name} not yet ported")
        if kv_dtype != "native":
            raise NotImplementedError(f"kv_dtype {kv_dtype!r} not yet ported")
        self.device = torch.device(device)
        self.reduced = bool(reduced)
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
        self._prefill_cores: Dict[str, Any] = {}
        self._groups: Dict[str, List[Tenant]] = {}
        # host-path instrumentation: per-epoch scheduling wall and
        # dispatch wall, and admission (param / cache materialization)
        self._sched_walls: List[float] = []
        self._device_walls: List[float] = []
        self._admit_walls: List[float] = []
        self._admit_wall = 0.0
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
        if arch.family != "dense":
            raise NotImplementedError(f"{aid}: family {arch.family!r} not "
                                      "yet ported (dense only)")
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
            want = _kv_reserve_pages(cfg, self.batch, spec.prompt_len)
            t.kv_wanted = want
            # best-effort reservation: degrade to what the pool can spare
            # now; kv_reserved < kv_wanted records the degradation
            got = self.cache.alloc(tid + "#kv", want)
            if got is None:
                got = self.cache.alloc(tid + "#kv",
                                       min(want, self.cache.free_pages))
            t.kv_reserved = len(got or [])
        else:
            # seed-token flow: no prompt, decode from token i
            t.token = torch.full((self.batch, 1), i % cfg.vocab_size,
                                 dtype=torch.long, device=self.device)
        t.caches = init_caches(params, cfg, self.batch, self.max_len,
                               device=self.device)
        t.admitted_wall = due_wall if due_wall is not None else time.time()
        self.tenants.append(t)
        self._groups.setdefault(cfg.name, []).append(t)
        self._epoch_cores.setdefault(cfg.name, M.make_decode_epoch(cfg))
        self._prefill_cores.setdefault(cfg.name, M.make_prefill_chunk(cfg))
        return t

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
        allocator profiles return to the pool, and its device buffers
        are released (outputs and traces stay for the result)."""
        if t.departed:
            return
        t.departed = True
        t.task.depart()
        if t.ptask is not None:
            t.ptask.depart()
        self.cache.free(t.tid + "#kv", None)
        self._groups[t.cfg.name].remove(t)
        t.params = None
        t.caches = None
        t.prompt = None
        t.prompt_dev = None

    def _process_departures(self) -> None:
        for t in self.tenants:
            if (not t.departed and t.budget_left is not None
                    and t.budget_left <= 0 and not t.prefilling):
                self._depart(t)

    def _align_lbm_to_vmem(self, tm: TenantModel, cfg: ArchConfig,
                           seq_block: int) -> None:
        """Make the LBM candidates quote the fused kernel's working set
        for the real cfg.d_ff, so that an admitted LBM grant always
        lowers fused.  Copy-on-write: the mapping may be the process-wide
        memoized instance."""
        eb = _elem_bytes(cfg)
        need = fused_ffn_pages(seq_block, cfg.d_model, cfg.d_ff, eb)
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
        decode step (or prefill chunk) executes, with the real d_ff."""
        cfg = t.cfg
        lbm = [(s, p) for s, p in sched if s.candidate.kind == "LBM"]
        sel, pages = lbm[0] if lbm else sched[0]
        down_pages = None if lbm else (sched[-1][1] if len(sched) > 1
                                       else None)
        return lower_selection(
            sel, pages, seq_block=seq_block or max(self.batch, LANE),
            d_model=cfg.d_model, d_ff=cfg.d_ff,
            dtype_bytes=_elem_bytes(cfg), head_dim=cfg.hd,
            ssm_chunk=cfg.ssm_chunk, down_pages=down_pages,
            kv_dtype=self.kv_dtype)

    def _schedule_epoch(self, t: Tenant, now: float, k: int) -> KernelPlan:
        """CaMDN selection + NEC charging for one tenant's epoch: the
        grant covers the whole K-step window, charged once with
        repeat=K."""
        t.task.charge_repeat = k
        try:
            sched = self._schedule_block(t, now)
        finally:
            t.task.charge_repeat = 1
        plan = self._lower_plan(t, sched)
        t.plans.append(plan)
        return plan

    def _plan_prefill_chunk(self, t: Tenant, now: float) -> Tuple:
        """Schedule one cache-aware prefill chunk: renegotiate the grant
        through the prefill-block MCT, lower it into a KernelPlan and
        that into the chunk length the grant admits."""
        sched = self._schedule_block(t, now, task=t.ptask)
        plan = self._lower_plan(t, sched, seq_block=self.prefill_block)
        t.plans.append(plan)
        chunk = lower_prefill_chunk(
            plan, d_model=t.cfg.d_model,
            d_ff=max(t.cfg.d_ff, t.cfg.d_model),
            dtype_bytes=_elem_bytes(t.cfg),
            align=LANE, max_tokens=self.prefill_block,
            remaining=t.prompt_len - t.pf_pos)
        t.chunks.append(chunk)
        return ("prefill", t, plan, chunk)

    def _finish_prefill(self, t: Tenant, token: torch.Tensor) -> None:
        """The final chunk's greedy token flips the tenant to decode.
        On the card a CUDA event marks the token for the TTFT stamp,
        which the caller takes after the epoch's decode work is queued."""
        t.token = token
        t.outputs.append(token)
        t.tokens_served += self.batch
        t.index = t.prompt_len
        t.ptask.depart()
        if token.is_cuda:
            t.first_token_event = torch.cuda.Event()
            t.first_token_event.record()

    def _stamp_ttft(self, t: Tenant) -> None:
        """The serving loop's one wait on the device: until the first
        token exists."""
        if t.first_token_event is not None:
            t.first_token_event.synchronize()
        t.ttft = time.time() - t.admitted_wall

    def _prefill_whole(self, t: Tenant, now: float) -> None:
        """Sequential-admission baseline (and the serial loop's prompt
        path): the whole prompt prefills as one call, scheduled through
        the whole-prompt MCT, and decode waits behind it."""
        sched = self._schedule_block(t, now, task=t.ptask)
        plan = self._lower_plan(t, sched, seq_block=t.prompt_len)
        t.plans.append(plan)
        t.chunks.append(t.prompt_len)
        kv = self._kv_len(t.prompt_len)
        tok, t.caches = self._prefill_cores[t.cfg.name](
            t.params, t.caches, t.prompt_dev, 0, kv_len=kv)
        t.pf_computed += t.prompt_len
        t.pf_pos = t.prompt_len
        self._finish_prefill(t, tok)
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
        return (not t.departed and t.token is not None
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
            dec_plans[t.tid] = (plan, ks[i])
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
                    and len({g.index for g in group}) == 1)
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

    def _dispatch_prefill(self, item: Tuple) -> Optional[Tenant]:
        """Queue one prefill chunk on the device.  Returns the tenant
        when this was its prompt's final chunk."""
        _, t, _, chunk = item
        kv = self._kv_len(t.pf_pos + chunk)
        tok, t.caches = self._prefill_cores[t.cfg.name](
            t.params, t.caches, t.prompt_dev[:, t.pf_pos:t.pf_pos + chunk],
            t.pf_pos, kv_len=kv)
        t.pf_pos += chunk
        t.pf_computed += chunk
        if not t.prefilling:
            self._finish_prefill(t, tok)
            return t
        return None

    def _dispatch_epoch(self, work: List[Tuple]) -> None:
        """Timed wrapper around the epoch dispatcher (the dispatch wall:
        host time to queue the epoch's device work)."""
        t0 = time.perf_counter()
        try:
            self._dispatch_epoch_inner(work)
        finally:
            self._device_walls.append(time.perf_counter() - t0)

    def _dispatch_epoch_inner(self, work: List[Tuple]) -> None:
        """Queue one epoch's work: the prefill chunks first, then every
        decode item (a bucket's tenants one after another).  Nothing here
        waits for the device except the TTFT stamps, taken last."""
        finished = []
        for item in work:
            if item[0] == "prefill":
                done = self._dispatch_prefill(item)
                if done is not None:
                    finished.append(done)
        for item in work:
            if item[0] == "prefill":
                continue
            kind, who, plan, k = item
            for t in (who if kind == "bucket" else [who]):
                kv = self._kv_len(t.index + k)
                toks, t.caches = self._epoch_cores[t.cfg.name](
                    t.params, t.caches, t.token, t.index, plan=plan, k=k,
                    kv_len=kv)
                t.token = toks[:, -1:]
                t.outputs.append(toks)
                self._advance(t, k)
        for t in finished:
            self._stamp_ttft(t)

    def _serve_one_step(self, t: Tenant, now: float) -> None:
        """Serial reference: schedule, charge, lower and run ONE decode
        step."""
        assert t.index < self.max_len, \
            f"{t.tid}: decode past max_len {self.max_len}"
        sched = self._schedule_block(t, now)
        plan = self._lower_plan(t, sched)
        t.plans.append(plan)
        kv = self._kv_len(t.index + 1)
        nxt, t.caches = t.decode(t.params, t.caches, t.token, t.index,
                                 plan=plan, kv_len=kv)
        t.token = nxt[:, None]
        t.outputs.append(nxt[:, None])
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
        self._batched_runs = 0
        self._oracle_runs = 0
        for t in self.tenants:
            t.run_steps = 0
            if t.admitted_wall is None or not t.outputs:
                t.admitted_wall = self._run_t0
        self._run_tokens_before = sum(t.tokens_served for t in self.tenants)

    def run(self, steps: int = 16) -> Dict[str, Any]:
        self._begin_run(steps)
        t0 = self._run_t0
        if self.pipeline:
            pending = self._plan_epoch(0.0, steps)
            while pending:
                self._dispatch_epoch(pending)
                # the epoch is still running on the device (eager
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
                        "kv_dtype": self.kv_dtype,
                        "prefill_computed": t.pf_computed,
                        "state": t.state,
                        "output": (torch.cat([o.cpu() for o in t.outputs],
                                             dim=-1).numpy().astype(np.int32)
                                   if t.outputs else
                                   np.zeros((self.batch, 0), np.int32))}
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
                "batched_runs": self._batched_runs,
                "oracle_runs": self._oracle_runs,
            },
        }
