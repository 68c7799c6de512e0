"""Multi-tenant server, every model family, and the serving fleet (port
of src/repro/launch/serve.py::MultiTenantServer, ``FleetServer`` and
their ``main`` CLI).

Several LM tenants (dense decoders, MoE decoders, Mamba2 stacks,
Zamba2-style hybrids, Whisper-style encoder-decoders and LLaVA-style
VLMs, mixed in one pool or not) share one device.  Each
tenant's FFN block is a small
:class:`~repro_torch.core.types.ModelGraph` mapped by the CaMDN
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
(``_lower_width``).  A hybrid tenant holds both kinds of cache (per
group, its Mamba2 states and the K/V of the shared attention block,
see :mod:`repro_torch.models.transformer`): its decode binds the plan,
as a dense tenant's does, so the shared block's FFN runs the planned
kernels; its prompt chunks align to the SSD chunk and scan through
ssd_chunk; its reservation prices both; and, its state being
cumulative, its prefix entry is registered at full length only.  Every
loop over a tenant's caches decides per leaf, by the leaf's name
(K/V leaves, ``is_kv_leaf``, have a time axis, the recurrent ``conv`` /
``ssm`` do not), never by family.  An encoder-decoder tenant holds a fixed encoder
output ``enc`` [batch, enc_len, d_model], zeros in the compute dtype
(the reference's frontend is a stub), allocated once at admission on
the server's device and freed at departure; its decode items and prompt
chunks pass it to every cross-attention, and its graphs bind it like
the tenant's other buffers (a bucket passes its tenants' own ``enc``
buffers, unstacked).  Its KV stays native and it never takes part in
prefix dedup, as in the reference.  A VLM tenant serves its prompt
tokens through the dense decoder, as the reference's (the patch prefix
is a ``make_prefill`` input, not a serving one).

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
share one memory pool, which an anchor graph the server keeps holds
alive when every program in it is evicted.  A departure evicts every
entry that names the tenant before its buffers are freed; these
evictions are counted apart from the LRU's.

Capture on the card.  The first capture of a warm-up key
(``_warmup_key``: a program key without its kv window and tenant ids,
so a decode item's kind, arch, plan, k, bucket size and KV dtype, a
prompt chunk's arch, KV dtype and length) follows one eager run of the
same function on the capture stream, which loads the kernels' libraries,
sets their attributes and warms cuBLAS on that stream.  It runs on the
tenants' own buffers with their feedback tokens, positions and SSM
states copied aside and put back; the KV rows and log entries it writes
lie at or past the position, where the replay writes them again before
anything reads them.  A later kv window of the same key runs the same
operations over a longer K/V read and is recorded without a warm-up:
the recording submits nothing, so it runs while the device still drains
the epochs queued before it, where a warm-up's eager launches would
wait behind them.  Neither the warm-up's launches nor the capture's are
counted: each replay adds the launch counts its capture recorded
(``kernels/counters.py``).  A capture or replay that fails raises; on
the card nothing falls back to eager dispatch.  Nothing reads the
device back to the host except the TTFT stamp of a tenant's first
token, and the log once after the run.

Counters and spans.  ``counters()`` snapshots the server's counters,
always kept and each since construction: captures and the host seconds
of their warm-ups, recordings and first replays, epochs and the host
seconds of their planning and dispatch, and admission's; ``run()``'s
``host`` reports each run's share of the epoch ones.  ``tracer``
(:mod:`repro_torch.launch.spans`), off until ``tracer.start()``, keeps
spans of admission (``serve.admit``), each prompt chunk
(``serve.prefill_chunk``) and each program's call (``serve.replay``),
each with the ids of the tenants it serves, and for every capture a
crossing record: a device mark as the capture begins and one before its
program's first replay, with the capture's warm-up, recording and
first-replay spans (``serve.capture.*``) between them.

Serve features (the reference's, decision for decision): prefix-hash
KV dedup (``prefix_dedup``: session prompts register their caches in
the pool's ``PrefixIndex`` and later arrivals attach), predictive grant
lookahead (``lookahead``), the overload ladder (``queue_limit``,
``queue_deadline_s``, ``backoff``: shed, defer, admit), preemption with
KV checkpoints (``preempt_tenant``, ``preemption_policy``,
``ckpt_dir``) and deterministic fault injection (``faults``,
``straggler_policy``).  Where they meet the card, this port deviates:

* Seeding in place.  A prefix hit copies the entry's rows into the
  tenant's own (fresh) buffers and sets its device position to the hit
  length before any of its programs is captured; an SSM hit copies the
  state into the state buffers.  A full hit writes the stored first
  token into the feedback buffer and the log, as if prefill had run.
* Snapshots.  A producer's snapshot is a device clone, queued after its
  final prompt chunk and before its next epoch, cut to the prompt's
  rows (the seeder reads only those); the index's entry holds its last
  reference, so an eviction frees it.
* Preemption evicts every program that names the tenant (counted apart
  from departures' evictions, ``host["preempt_evictions"]``) before its
  caches are dropped, and clears ``fed`` (which stands where the
  reference tests ``token is not None``), so the tenant leaves the plan
  and any bucket.  Its small static buffers (feedback token, position,
  log) are kept.  A snapshot checkpoint copies the caches to the host,
  which waits for the work in flight (as the reference's ``device_get``
  does); this happens only at a preemption.  Resume allocates fresh
  caches, restores into them, and the tenant's programs are captured
  again at its next dispatch: ``recovery_s`` is stamped after that
  dispatch, so on the card it includes the recapture.
* Pricing width.  The overload ladder and the lookahead price an
  arrival's KV reservation at the server's width (``reduced``), where
  the reference always prices ``get_arch(aid).reduced()``: identical at
  ``reduced=True``, and at full width the ladder reasons about the pages
  the server will really reserve.

The fleet (:class:`FleetServer`, the CLI's ``--devices``) is the
reference's: one pipelined server per replica of a
:class:`~repro_torch.launch.mesh.ServingMesh`, each with its own control
stack, behind least-loaded and prefix-affine routing with replica-kill
failover.  Where it meets the card, this port deviates:

* Placement.  A replica is a ``torch.device``, and replicas may share
  one: the CLI places replica r on card ``r % torch.cuda.device_count()``
  (every replica on the CPU under ``--device cpu``), where the reference
  splits the host into N XLA devices.  On one card the replicas' epochs
  run one after another on the card, each replica with its own graphs.
* The routing probe's width.  The prefix-affinity probe draws the
  prompt at the replicas' width through their ``prompt_fn`` (the
  reference draws at the reduced width: the same at ``reduced=True``).

* Tensor-parallel groups (``tp > 1``).  The reference places a
  group's params and caches by ``param_shardings`` / ``cache_shardings``
  and lets XLA partition its epochs.  Here a tenant's params are split by
  ``distributed/sharding.py::param_specs`` into pieces on the group's
  devices (``distributed/tensor_parallel.py``), and the models compute
  shard by shard and sum the row-split partial products in shard order;
  the plan kernels run at the shards' shapes.  Where the split falls on
  head boundaries, each shard's attention runs on its device over its
  own KV heads' cache (the reference's ``cache_specs`` shard head_dim);
  the unsplit work (norms, the router, the Mamba2 conv and scan) and its
  caches stay on the group's first device.  The group's devices may repeat (every piece on one card); a group of
  distinct cards dispatches eagerly, without graphs.  Grants, plans and
  chunk traces do not depend on ``tp``.

Entry points run on ``device="cuda"`` unless the caller asks for the
CPU.  Without injected params / prompts the server draws params from a
seeded ``torch.Generator`` and prompts from ``np.random.default_rng``
(the reference's threefry draws cannot be reproduced): a session prompt
(``prompt_seed`` set) slices its system prefix from the stream of
``104729 + prefix_seed`` and its suffix from that of ``7919 +
prompt_seed``, each drawn at the fixed width ``_PROMPT_CAP``, so a
longer prompt with the same seeds extends a shorter one and sessions on
one system prompt share its tokens, as the reference's do.  Parity
tests inject the reference's params and prompts through ``params_fn`` /
``prompt_fn``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import os
import shutil
import tempfile
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core.allocator import AHEAD_FRACTION, INF, Selection
from repro_torch.core.cache import CacheConfig
from repro_torch.core.mapping import MapperConfig
from repro_torch.core.mct import MCT, ModelMapping
from repro_torch.core.plan import KernelPlan, lower_prefill_chunk
from repro_torch.core.policy import (KV_PRECISION_LADDER, CamdnPolicy,
                                     QosPreemptionPolicy, ReplicaAllocators,
                                     ReplicaControl, choose_kv_dtype,
                                     price_layer_batch, project_epoch_dram)
from repro_torch.core.runtime import (STATE_ADMITTED, STATE_PREEMPTED,
                                      STATE_RESUMED, STATE_RUNNING,
                                      STATE_SHED, TenantModel, TenantTask)
from repro_torch.core.types import (GemmDims, LayerKind, LayerSpec, ModelGraph,
                                    ceil_div, elem_bytes)
from repro_torch.core.vmem import (LANE, PAGE_BYTES, VMEM_PAGES,
                                   fused_ffn_pages, kv_row_bytes,
                                   lower_selection)
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.fault_tolerance import StragglerPolicy
from repro_torch.kernels import counters as kcount
from repro_torch.launch import spans
from repro_torch.launch.mesh import (ServingMesh, make_serving_mesh,
                                     replica_submeshes)
from repro_torch.models import model as M
from repro_torch.models.base import ArchConfig, get_arch
from repro_torch.models.ssm import CONV_K
from repro_torch.models.transformer import (init_caches, is_kv_leaf,
                                            num_groups, seed_caches_in_place)
from repro_torch.sim.driver import (BackoffPolicy, FleetScenario,
                                    PoissonArrivals, TenantSpec)
from repro_torch.sim.faults import FaultEvent, FaultLog, FaultPlan

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
    the prompt.  A hybrid stack carries both: one K/V per group and the
    state of each of its ``attn_every - 1`` Mamba2 layers."""
    eb = _elem_bytes(cfg)
    quantized = kv_dtype != "native"
    kv_eb = elem_bytes(kv_dtype) if quantized else eb
    G = num_groups(cfg)
    kv_groups = G if cfg.family != "ssm" else 0
    ssm_groups = {"ssm": G, "hybrid": G * (cfg.attn_every - 1)}.get(
        cfg.family, 0)
    row = kv_row_bytes(cfg.num_kv_heads, cfg.hd, kv_eb, scaled=quantized)
    kv = kv_groups * batch * tokens * row
    state = ssm_groups * batch * (
        (CONV_K - 1) * (cfg.d_inner + 2 * cfg.ssm_state) * eb
        + cfg.ssm_heads * cfg.ssm_state * cfg.ssm_head_dim * 4)
    return ceil_div(kv + state, PAGE_BYTES) if tokens > 0 else 0


# Session prompts slice fixed-width streams, so a longer prompt with the
# same seeds extends a shorter one (the reference's cap)
_PROMPT_CAP = 4096


def _prompt_tokens(spec: TenantSpec, i: int, cfg: ArchConfig,
                   batch: int) -> np.ndarray:
    """Deterministic prompt tokens for admission ``i`` (seeded numpy
    streams keyed as the reference's threefry streams are, not their
    values).  A legacy spec draws one admission-indexed stream shaped by
    the prompt; a session spec (``prompt_seed`` set) joins the shared
    system prefix of ``104729 + prefix_seed`` and the suffix of ``7919 +
    prompt_seed``, each sliced from a ``_PROMPT_CAP``-wide draw."""
    P = spec.prompt_len
    if spec.prompt_seed is None:
        rng = np.random.default_rng(7919 + i)
        return rng.integers(0, cfg.vocab_size, (batch, P), dtype=np.int32)
    pre_len = min(spec.prefix_len, P)
    assert P <= _PROMPT_CAP, f"prompt_len {P} > cap {_PROMPT_CAP}"

    def stream(seed):
        return np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (batch, _PROMPT_CAP), dtype=np.int32)
    pre = stream(104729 + spec.prefix_seed)[:, :pre_len]
    suf = stream(7919 + spec.prompt_seed)[:, :P - pre_len]
    return np.ascontiguousarray(np.concatenate([pre, suf], axis=1))


def _prefix_candidates(prompt: np.ndarray, prompt_len: int,
                       align: int) -> List[Tuple[int, bytes]]:
    """(kv_len, token_bytes) probe list for the PrefixIndex, longest
    first: the full prompt, then every chunk-grid multiple below it."""
    lens = [prompt_len]
    lens += list(range((prompt_len - 1) // align * align, 0, -align))
    return [(l, prompt[:, :l].tobytes()) for l in lens]


def _params_key(spec: TenantSpec, kv_dtype: str) -> str:
    """Prefix-index params identity: the param seed, suffixed with the
    KV storage precision when quantized (a quantized snapshot is only
    valid for a tenant decoding at the same precision)."""
    key = f"ps{spec.param_seed}"
    if kv_dtype != "native":
        key += f"+kv:{kv_dtype}"
    return key


def _warmup_key(key: Tuple, group: List[Tenant]) -> Tuple:
    """The key a program's eager warm-up is kept under (``_compile``): its
    program key without the kv window and the tenant ids.  A decode
    item's (kind, arch, plan, k, kv window, tids) gives (kind, arch,
    plan, k, bucket size, KV dtype); a prompt chunk's (tid, chunk, kv
    window) gives ("prefill", arch, KV dtype, chunk).  What is kept
    chooses the kernels and their tiles; a later kv window runs the same
    operations over a longer K/V read."""
    t = group[0]
    if len(key) == 3:
        return ("prefill", t.cfg.name, t.kv_dtype, key[1])
    kind, arch, plan, k = key[:4]
    return (kind, arch, plan, k, len(group), t.kv_dtype)


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
    ahead of its first use; ``aot_hits`` counts its dispatches.
    ``first`` launches a graph's first replay (the server times it), then
    is dropped."""

    __slots__ = ("fn", "graph", "launches", "aot", "aot_hits", "first")

    def __init__(self, fn: Callable[[], None], graph: Any = None,
                 launches: Optional[Dict[str, int]] = None,
                 first: Optional[Callable[[Any], None]] = None):
        self.fn = fn
        self.graph = graph
        self.launches = launches or {}
        self.aot = False
        self.aot_hits = 0
        self.first = first

    def __call__(self) -> None:
        if self.aot:
            self.aot_hits += 1
        if self.graph is None:
            self.fn()
        else:
            if self.first is not None:
                first, self.first = self.first, None
                first(self.graph)
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
    enc: Any = None    # encdec: [B, enc_len, d] fixed encoder output,
    #                    built once at admission, freed at departure
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
    # ---- prefix-hash KV dedup ---------------------------------------
    pf_computed: int = 0                  # prompt tokens prefilled
    prefix_hit: int = 0                   # prompt tokens attached from index
    prefix_key: Optional[str] = None      # attached entry (detach on depart)
    dedup: Optional[Tuple[str, str]] = None   # (arch, params_key) when
    #                                           eligible to register/attach
    # ---- fault tolerance (preempt / resume) -------------------------
    state: str = STATE_ADMITTED
    preemptions: int = 0
    preempted_wall: Optional[float] = None   # until the first dispatch
    #                                          after resume
    resume_step: Optional[int] = None     # logical step to retry resume at
    recovery_s: List[float] = dataclasses.field(default_factory=list)
    ckpt_ref: Optional[Dict[str, Any]] = None   # snapshot handle while
    #                                             PREEMPTED (mode + locator)

    @property
    def prefilling(self) -> bool:
        return self.prompt is not None and self.pf_pos < self.prompt_len


class MultiTenantServer:
    """Decode across tenants of every family with CaMDN page
    arbitration.

    The reference's constructor arguments keep their meaning.  Added:
    ``device`` (default ``"cuda"``), ``reduced`` (the reference always
    serves ``get_arch(aid).reduced()``; False serves the full-width
    config), and the injection hooks ``params_fn(cfg, param_seed)`` and
    ``prompt_fn(spec, admission_index, cfg, batch)``.  ``device`` may be
    a fleet replica's ``(1, tp)`` :class:`~repro_torch.launch.mesh
    .ServingMesh`: at tp = 1 its device; above, a tensor-parallel group
    whose tenants' params are split over its devices (see the module
    docstring), the first holding the buffers.
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
                 device: Any = "cuda", replica: str = "",
                 control: Optional[ReplicaControl] = None,
                 prefix_dedup: bool = False,
                 kv_dtype: str = "native",
                 batch_sched: bool = True,
                 lookahead: bool = False,
                 aot_warmup: bool = False,
                 faults: Optional[FaultPlan] = None,
                 preemption_policy: Any = None,
                 straggler_policy: Optional[StragglerPolicy] = None,
                 ckpt_dir: Optional[str] = None,
                 queue_limit: Optional[int] = None,
                 queue_deadline_s: Optional[float] = None,
                 backoff: Optional[BackoffPolicy] = None,
                 reduced: bool = True,
                 params_fn: Optional[ParamsFn] = None,
                 prompt_fn: Optional[PromptFn] = None):
        if admission not in ("interleaved", "sequential"):
            raise ValueError(f"admission {admission!r}")
        # a fleet replica's (1, tp) submesh: its first device at tp = 1;
        # a tensor-parallel group above (params split over its devices)
        self.mesh: Optional[ServingMesh] = None
        if isinstance(device, ServingMesh):
            self.group = tp.group_devices(device)
            if len(self.group) > 1:
                self.mesh = device
            device = self.group[0]
        else:
            self.group = [torch.device(device)]
        if kv_dtype not in KV_PRECISION_LADDER + ("auto",):
            raise ValueError(f"kv_dtype {kv_dtype!r}: want one of "
                             f"{KV_PRECISION_LADDER + ('auto',)}")
        self.device = torch.device(device)
        self.replica = replica
        self.reduced = bool(reduced)
        self.aot_warmup = bool(aot_warmup)
        self._params_fn = params_fn
        self._prompt_fn = prompt_fn or _prompt_tokens
        self.qos_targets = qos_targets or {}
        self.prefix_dedup = bool(prefix_dedup)
        self.kv_dtype = kv_dtype
        self.batch_sched = bool(batch_sched)
        self.lookahead = bool(lookahead)
        self.epoch_len = max(1, int(epoch_len))
        self.pipeline = bool(pipeline)
        self.admission = admission
        self.prefill_block = max(LANE, int(prefill_chunk))
        self.steps_per_s = steps_per_s
        # the page pool, NEC ledger, allocator and prefix index: a fleet
        # replica's from the fleet's registry, else a private stack
        self.control = control or ReplicaControl.build(
            replica or "solo", CacheConfig(
                total_bytes=total_pages * PAGE_BYTES,
                num_slices=1, num_ways=1, npu_ways=1,
                page_bytes=PAGE_BYTES))
        self.cache = self.control.cache
        self.nec = self.control.nec
        self.alloc = self.control.alloc
        self.policy = self.control.policy
        self.prefix = self.control.prefix
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
        # a group of distinct cards dispatches eagerly (a graph captures
        # one device's stream)
        self._capture_graphs = (self.device.type == "cuda" and self.pipeline
                                and tp.one_device(self.group))
        self._capture_stream = None
        # the graphs' shared memory pool, held alive by an anchor graph
        # the server keeps (see _anchor_graph)
        self._anchor = None
        self._graph_pool = None
        self._warm_sigs: set = set()      # warm-up keys run so far
        # counters since construction (``counters()``): captures and the
        # host seconds inside them, of their warm-ups and recordings, and
        # of their programs' first replays
        self._captures = 0
        self._capture_s = 0.0
        self._warmups = 0
        self._warmup_s = 0.0
        self._record_s = 0.0
        self._first_replay_s = 0.0
        self._depart_evictions = 0
        self._preempt_evictions = 0
        self._snapshot_bytes = 0      # prefix snapshots cloned on the device
        self._ckpt_bytes = 0          # preemption checkpoints written
        self._aot_compiled = 0
        self._run_steps = 0
        self._lookahead_adjusted = 0
        # host-path counters since construction: epochs, their scheduling
        # and dispatch walls, and admission (param / cache
        # materialization); run() reports each run's share
        self._epochs = 0
        self._sched_wall = 0.0
        self._dispatch_wall = 0.0
        self._admit_wall = 0.0
        self._run_base = self.counters()
        self._epoch_compiles: List[int] = []
        # spans and device marks, off until tracer.start()
        self.tracer = spans.Tracer(self.device)
        self._batched_runs = 0
        self._oracle_runs = 0
        # fault tolerance: a logical-clock fault schedule consumed at
        # epoch boundaries; the straggler detector arms only under one,
        # fed a logical per-epoch duration (deterministic on any host)
        self.faults = faults
        self.fault_log = FaultLog()
        self.preemption_policy = preemption_policy or QosPreemptionPolicy()
        self.straggler = straggler_policy or StragglerPolicy()
        self._straggler_left = 0
        self._straggler_factor = 1.0
        self._ckpt_dir = ckpt_dir
        self._ckpt_tmp = False      # _ckpt_dir is a temporary of ours
        self._pressure_holds: List[List] = []   # [release_step, holder]
        self._pressure_n = 0
        # overload admission control: a bounded arrival queue and the
        # deadline-aware defer / degrade / shed ladder (both off by
        # default: admission is then immediate and best-effort)
        self.queue_limit = queue_limit
        self.queue_deadline_s = queue_deadline_s
        self.backoff = backoff or (BackoffPolicy()
                                   if queue_deadline_s is not None else None)
        self.shed: List[Dict[str, Any]] = []
        self.deferrals = 0
        self._defer_attempts: Dict[int, Tuple[int, int]] = {}
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
        """Queue arrivals relative to the current logical clock.  With a
        bounded queue (``queue_limit``), arrivals past capacity are shed
        on the spot."""
        for spec in sorted(specs, key=lambda s: s.arrive_at):
            if (self.queue_limit is not None
                    and len(self._queue) >= self.queue_limit):
                self._shed(spec, None, reason="queue_full")
                continue
            step = self._clock + int(math.ceil(spec.arrive_at
                                               * self.steps_per_s))
            self._queue.append([spec, None, step])
        self._queue.sort(key=lambda it: it[2])

    # -------------------------------------------------- fleet feedback --
    def load(self) -> int:
        """Router load metric: pages granted out of this replica's pool
        (decode / prefill grants plus the long-lived KV reservations)
        plus the prefill chunks still queued, read by the fleet's
        least-loaded admission layer every routing round."""
        used = self.cache.config.num_pages - self.cache.free_pages
        chunks = sum(ceil_div(t.prompt_len - t.pf_pos, self.prefill_block)
                     for t in self.tenants
                     if not t.departed and t.prefilling)
        return used + chunks

    def active_count(self) -> int:
        return sum(1 for t in self.tenants if not t.departed)

    def page_utilization(self) -> float:
        return self.control.utilization

    def admit_routed(self, spec: TenantSpec,
                     due_wall: Optional[float] = None) -> Tenant:
        """Fleet admission: the router hands a due spec straight to this
        replica, bypassing the local arrival queue (the fleet's clock
        owns arrival timing)."""
        with self._on_device():
            return self._admit_spec(spec, due_wall)

    def _on_device(self):
        """This server's card as the current device (nothing on the CPU):
        the kernels launch, the graphs capture and replay and the CUDA
        events record on the current device's stream, so a fleet whose
        replicas sit on other cards switches to each in turn."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        return torch.cuda.device(self.device)

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
        tid = f"t{i}:{aid}"
        tr = self.tracer
        with tr.span("serve.admit", (tid,)) if tr.on else spans.OFF:
            return self._materialise(spec, due_wall, aid, i, tid)

    def _materialise(self, spec: TenantSpec, due_wall: Optional[float],
                     aid: str, i: int, tid: str) -> Tenant:
        """The body of :meth:`_admit_spec`: the tenant's params, tasks,
        reservation, buffers and caches."""
        cfg = self._cfg(aid)
        pkey = spec.param_seed if spec.param_seed is not None else i
        params = (self._params_fn(cfg, pkey) if self._params_fn is not None
                  else M.init_params(cfg, pkey, self.device))
        if self.mesh is not None:
            params = tp.shard_params(params, self.mesh)
        if cfg.name not in self._step_fns:
            self._step_fns[cfg.name] = M.make_decode_step(cfg)
        tm = _tenant_model(_ffn_graph(aid, cfg, seq_block=self.batch),
                           self.mapper)
        self._align_lbm_to_vmem(tm, cfg, max(self.batch, LANE))
        task = TenantTask(tid, tm, self.cache, self.nec, self.policy,
                          replica=self.replica)
        enc = (torch.zeros((self.batch, cfg.enc_len, cfg.d_model),
                           dtype=cfg.torch_dtype, device=self.device)
               if cfg.family == "encdec" else None)
        t = Tenant(tid, cfg, params, None, self._step_fns[cfg.name], task,
                   token=None, enc=enc)
        t.budget_left = spec.n_inferences
        if spec.qos_ms is not None:
            self.qos_targets[tid] = spec.qos_ms * 1e-3
        t.qos_target = self._resolve_qos(tid)
        hit = None
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
                                 self.policy, replica=self.replica)
            want = _kv_reserve_pages(cfg, self.batch, spec.prompt_len,
                                     t.kv_dtype)
            t.kv_wanted = want
            shared: List[int] = []
            if self._dedup_eligible(spec, cfg):
                t.dedup = (cfg.name, _params_key(spec, t.kv_dtype))
                hit = self._prefix_lookup(t)
            if hit is not None:
                # attach BEFORE allocating the private remainder: the
                # refcount protects the matched chain from the pool
                # pressure that allocation can trigger
                t.prefix_key = hit.key
                t.prefix_hit = hit.kv_len
                self.prefix.attach(hit.key, tid)
                shared = self.cache.share(self.prefix.chain_pages(hit),
                                          tid + "#kv")
            # best-effort reservation of the un-shared remainder: the
            # pool's pressure hook may reclaim cold prefixes to meet it,
            # else degrade to what the pool can spare now;
            # kv_reserved < kv_wanted records the degradation
            priv = max(0, want - len(shared))
            got = self.cache.alloc(tid + "#kv", priv)
            if got is None:
                got = self.cache.alloc(tid + "#kv",
                                       min(priv, self.cache.free_pages))
            t.kv_reserved = len(shared) + len(got or [])
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
        if hit is not None:
            # the shared rows into the tenant's own buffers, and its
            # position to the hit, before any of its programs exists
            seed_caches_in_place(cfg, t.caches, hit.payload["snap"],
                                 hit.kv_len)
            t.pf_pos = hit.kv_len
            t.index_dev.fill_(hit.kv_len)
        t.admitted_wall = due_wall if due_wall is not None else time.time()
        self.tenants.append(t)
        self._groups.setdefault(cfg.name, []).append(t)
        self._epoch_cores.setdefault(cfg.name, M.make_decode_epoch(cfg))
        self._prefill_cores.setdefault(cfg.name, M.make_prefill_chunk(cfg))
        if hit is not None and t.pf_pos >= t.prompt_len:
            # full hit: the entry stored the producer's first token, so
            # prefill is skipped; the buffers take the state a final
            # chunk leaves (token fed back and logged at prompt_len - 1)
            tok = hit.payload["token"]
            t.token.copy_(tok)
            t.log[:, t.prompt_len - 1:t.prompt_len].copy_(tok)
            self._finish_prefill(t)
            self._stamp_ttft(t)
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
        does).  Resident (no-prompt) tenants stay native, and so do an
        SSM tenant (its decode carries recurrent fp state, not
        row-addressed KV) and an encoder-decoder one, as in the
        reference."""
        if cfg.family in ("ssm", "encdec"):
            return "native"
        if self.kv_dtype != "auto":
            return self.kv_dtype
        want = {kv: _kv_reserve_pages(cfg, self.batch, spec.prompt_len, kv)
                for kv in KV_PRECISION_LADDER}
        return choose_kv_dtype(want, self.cache.free_pages)

    def _cfg(self, aid: str) -> ArchConfig:
        """The config the server serves ``aid`` at (its width): reduced,
        as the reference's always is, or full width."""
        arch = get_arch(aid)
        return arch.reduced() if self.reduced else arch

    def _dedup_eligible(self, spec: TenantSpec, cfg: ArchConfig) -> bool:
        """Cross-tenant KV dedup preconditions (the reference's): the
        server opted in, a session spec with decoupled param / prompt
        identities, a prompt, and the interleaved pipelined path
        (chunked prefill is what resumes mid-prompt)."""
        return (self.prefix_dedup and self.pipeline
                and self.admission == "interleaved"
                and spec.param_seed is not None
                and spec.prompt_seed is not None
                and spec.prompt_len > 0 and cfg.family != "encdec")

    def _prefix_lookup(self, t: Tenant):
        """Longest usable resident prefix for an arriving prompt: a
        partial hit on the tenant's chunk-alignment grid, or a full hit
        that carries the stored first token; anything else walks up the
        parent chain."""
        arch, params_key = t.dedup
        align = self._chunk_align(t.cfg)
        cands = _prefix_candidates(t.prompt, t.prompt_len, align)
        ent = self.prefix.lookup(arch, params_key, cands)
        while ent is not None:
            if ent.kv_len == t.prompt_len:
                if ent.payload.get("token") is not None:
                    return ent
            elif ent.kv_len % align == 0:
                return ent
            ent = (self.prefix.entries.get(ent.parent)
                   if ent.parent is not None else None)
        return None

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
            spec, due_wall, arrive_step = self._queue[0]
            # malformed / oversized prompts are shed at the door
            bad = self._malformed(spec)
            if bad is not None:
                self._queue.pop(0)
                self._shed(spec, due_wall, reason=bad)
                continue
            if self.queue_deadline_s is not None:
                # the deadline runs from the ORIGINAL arrival step
                orig = self._defer_attempts.get(id(spec),
                                                (0, arrive_step))[1]
                decision = self._overload_decision(spec, orig)
                if decision == "defer":
                    self._defer_head()
                    continue
                if decision == "shed":
                    self._queue.pop(0)
                    self._shed(spec, due_wall, reason="deadline")
                    continue
            spec, due_wall, _ = self._queue.pop(0)
            self._defer_attempts.pop(id(spec), None)
            a0 = time.perf_counter()
            self._admit_spec(spec, due_wall)
            self._admit_wall += time.perf_counter() - a0

    def _malformed(self, spec: TenantSpec) -> Optional[str]:
        """Reject-reason for a spec the server cannot serve (shed at
        admission instead of raising mid-admission)."""
        if spec.prompt_len < 0:
            return "negative_prompt"
        if spec.prompt_len > _PROMPT_CAP and spec.prompt_seed is not None:
            return "prompt_over_cap"
        if spec.prompt_len > 0:
            need = spec.prompt_len + (spec.n_inferences or 0)
            if need > self.max_len:
                return "oversized_prompt"
        return None

    def _overload_decision(self, spec: TenantSpec,
                           arrive_step: int) -> str:
        """Deadline-aware backpressure ladder for one due arrival (the
        reference's): ``admit`` when the pool can back the KV reservation
        at the cheapest precision rung; else ``defer`` while the queue
        deadline has slack; past it, ``shed`` if this is (one of) the
        loosest-QoS arrivals waiting, else admit degraded.  The
        reservation is priced at the server's width (the reference
        prices the reduced config; the same at ``reduced=True``)."""
        aid = (spec.model if isinstance(spec.model, str)
               else spec.model.name)
        cfg = self._cfg(aid)
        if spec.prompt_len <= 0:
            return "admit"
        floor_kv = ("native" if cfg.family in ("ssm", "encdec")
                    or self.kv_dtype == "native"
                    else (self.kv_dtype if self.kv_dtype != "auto"
                          else KV_PRECISION_LADDER[-1]))
        want = _kv_reserve_pages(cfg, self.batch, spec.prompt_len, floor_kv)
        if want <= self.cache.free_pages:
            return "admit"
        deadline = max(1, int(math.ceil(self.queue_deadline_s
                                        * self.steps_per_s)))
        if self._clock - arrive_step < deadline:
            return "defer"
        loose = (lambda s: math.inf if s.qos_ms is None else s.qos_ms)
        if loose(spec) >= max(loose(it[0]) for it in self._queue):
            return "shed"
        return "admit"

    def _defer_head(self) -> None:
        """Push the head arrival back by a jittered backoff delay (its
        due_wall stamp survives: the deferral counts against TTFT)."""
        item = self._queue.pop(0)
        spec = item[0]
        att, orig = self._defer_attempts.get(id(spec), (0, item[2]))
        self._defer_attempts[id(spec)] = (att + 1, orig)
        delay = self.backoff.delay_s(att, key=orig)
        item[2] = max(self._clock + 1,
                      self._clock + int(math.ceil(delay * self.steps_per_s)))
        self._queue.append(item)
        self._queue.sort(key=lambda it: it[2])
        self.deferrals += 1
        self.fault_log.record(self._clock, "defer",
                              model=str(getattr(spec.model, "name",
                                                spec.model)),
                              attempt=att + 1, retry_step=item[2])

    def _shed(self, spec: TenantSpec, due_wall: Optional[float],
              reason: str) -> None:
        """Reject one arrival (overload or malformed): recorded, never
        admitted."""
        self._defer_attempts.pop(id(spec), None)
        aid = (spec.model if isinstance(spec.model, str)
               else getattr(spec.model, "name", str(spec.model)))
        self.shed.append({
            "model": aid, "state": STATE_SHED, "reason": reason,
            "step": self._clock, "qos_ms": spec.qos_ms,
            "prompt_len": spec.prompt_len,
            "waited_s": (time.time() - due_wall
                         if due_wall is not None else None)})
        self.fault_log.record(self._clock, "shed", model=aid, reason=reason)

    def _depart(self, t: Tenant) -> None:
        """The tenant leaves: its page grants, KV reservation and
        allocator profiles return to the pool, its prefix attachment and
        any parked checkpoint are dropped, every program naming it is
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
        if t.prefix_key is not None:
            # refcount-- down the attached chain; the entries stay
            # resident for the next warm arrival until pressure evicts
            self.prefix.detach(t.prefix_key, t.tid)
        if t.ckpt_ref is not None:
            # departing while preempted: drop the parked checkpoint
            if t.ckpt_ref.get("mode") == "snapshot":
                shutil.rmtree(t.ckpt_ref["dir"], ignore_errors=True)
            elif t.ckpt_ref.get("mode") == "prefix":
                self.prefix.detach(t.ckpt_ref["key"], t.tid + "/preempt")
            t.ckpt_ref = None
            self._drop_ckpt_root()
        self.cache.free(t.tid + "#kv", None)
        self._groups[t.cfg.name].remove(t)
        self._evict_programs(t.tid)
        t.outputs = self._served(t).clone()
        t.params = None
        t.caches = None
        t.prompt = None
        t.prompt_dev = None
        t.token = t.index_dev = t.log = t.enc = None

    def _evict_programs(self, tid: str, preempt: bool = False) -> None:
        """Drop every decode and prefill entry whose key names ``tid``,
        counted as a departure's evictions or, with ``preempt``, a
        preemption's."""
        for cache, tids in ((self._fused_jits, lambda key: key[5]),
                            (self._prefill_jits, lambda key: key[:1])):
            for key in cache.keys():
                if tid in tids(key):
                    cache.pop(key)
                    if preempt:
                        self._preempt_evictions += 1
                    else:
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

    # --------------------------------------------- preempt / resume -----
    def _ckpt_root(self) -> str:
        if self._ckpt_dir is None:
            self._ckpt_dir = tempfile.mkdtemp(prefix="repro_torch-preempt-")
            self._ckpt_tmp = True
        return self._ckpt_dir

    def _drop_ckpt_root(self) -> None:
        """Remove the temporary checkpoint root this server made (no
        ``ckpt_dir`` given) once no parked snapshot lives in it."""
        if self._ckpt_tmp and not any(
                t.ckpt_ref is not None and t.ckpt_ref["mode"] == "snapshot"
                for t in self.tenants):
            shutil.rmtree(self._ckpt_dir, ignore_errors=True)
            self._ckpt_dir, self._ckpt_tmp = None, False

    def _select_victim(self) -> Optional[Tenant]:
        """Policy-pluggable QoS-aware victim selection over the tenants
        that can be preempted: decoding (``fed``, not mid-prefill), not
        already preempted, not departed."""
        cands = [(t.tid, t.qos_target,
                  t.kv_reserved + t.task.held_pages, t.tokens_served)
                 for t in self.tenants
                 if not t.departed and t.state != STATE_PREEMPTED
                 and t.fed and not t.prefilling]
        tid = self.preemption_policy.select(cands)
        if tid is None:
            return None
        return next(t for t in self.tenants if t.tid == tid)

    def preempt_tenant(self, t: Tenant, resume_after_epochs: int = 1,
                       reason: str = "fault") -> bool:
        """Pause one decode tenant bit-preservingly: checkpoint its caches
        and feedback token, free every page it holds, and schedule a
        resume.  A tenant sitting exactly at the end of a registered
        full-prompt entry checkpoints by a refcount hold on that entry
        (``prefix`` mode, nothing copied); any other writes a checkpoint
        (``snapshot`` mode, :func:`repro_torch.checkpoint.checkpoint.save`,
        which waits for the device).  Then every program naming the
        tenant is evicted before its caches are dropped, and ``fed`` is
        cleared; the feedback token, position and log buffers stay."""
        if (t.departed or t.state == STATE_PREEMPTED or t.prefilling
                or not t.fed):
            return False
        ent = None
        if t.dedup is not None and t.prompt is not None:
            full_key = self.prefix.prefix_key(
                t.dedup[0], t.dedup[1], t.prompt.tobytes())
            ent = self.prefix.entries.get(full_key)
        if (ent is not None and t.index == t.prompt_len
                and ent.payload.get("token") is not None):
            self.prefix.attach(ent.key, t.tid + "/preempt")
            t.ckpt_ref = {"mode": "prefix", "key": ent.key}
        else:
            root = os.path.join(
                self._ckpt_root(),
                t.tid.replace("/", "_").replace(":", "_"))
            step_dir = ckpt.save(root, t.index,
                                 {"caches": t.caches, "token": t.token},
                                 extra={"index": t.index, "pf_pos": t.pf_pos})
            self._ckpt_bytes += ckpt.checkpoint_bytes(step_dir)
            t.ckpt_ref = {"mode": "snapshot", "dir": root, "step": t.index}
        self._evict_programs(t.tid, preempt=True)
        # surrender the caches and every modeled page: decode grants, the
        # KV reservation and the attached prefix chain's refcounts
        t.task.preempt()
        if t.prefix_key is not None:
            self.prefix.detach(t.prefix_key, t.tid)
            t.prefix_key = None
        self.cache.free(t.tid + "#kv", None)
        t.caches = None
        t.fed = False
        t.state = STATE_PREEMPTED
        t.preemptions += 1
        t.preempted_wall = time.time()
        t.resume_step = (self._clock
                         + max(1, resume_after_epochs) * self.epoch_len)
        self.fault_log.record(self._clock, "preempt", tid=t.tid,
                              mode=t.ckpt_ref["mode"], reason=reason,
                              resume_step=t.resume_step)
        return True

    def _try_resume(self) -> None:
        """Resume every preempted tenant whose resume step has passed
        (at epoch boundaries, before planning)."""
        for t in self.tenants:
            if (not t.departed and t.state == STATE_PREEMPTED
                    and t.resume_step is not None
                    and self._clock >= t.resume_step):
                self._resume_tenant(t)

    def _resume_tenant(self, t: Tenant) -> bool:
        """Rebuild a preempted tenant's device state bit-identically and
        re-admit it to scheduling: fresh caches, restored from the
        checkpoint or re-seeded from the prefix entry, the feedback token
        put back, KV pages re-reserved (best-effort, as at admission).
        Its programs are captured again at its next dispatch."""
        ref = t.ckpt_ref
        assert t.state == STATE_PREEMPTED and ref is not None, t.tid
        want = t.kv_wanted
        shared: List[int] = []
        t.caches = init_caches(t.params, t.cfg, self.batch, self.max_len,
                               kv_dtype=t.kv_dtype, device=self.device)
        if ref["mode"] == "prefix":
            ent = self.prefix.entries[ref["key"]]
            self.prefix.attach(ref["key"], t.tid)
            t.prefix_key = ref["key"]
            shared = self.cache.share(self.prefix.chain_pages(ent),
                                      t.tid + "#kv")
            seed_caches_in_place(t.cfg, t.caches, ent.payload["snap"],
                                 ent.kv_len)
            t.token.copy_(ent.payload["token"])
            self.prefix.detach(ref["key"], t.tid + "/preempt")
        else:
            tree, _ = ckpt.restore(ref["dir"], step=ref["step"],
                                   device=self.device)
            for dst, src in zip(t.caches, tree["caches"], strict=True):
                for name, leaf in dst.items():
                    leaf.copy_(src[name])
            t.token.copy_(tree["token"])
            shutil.rmtree(ref["dir"], ignore_errors=True)
        priv = max(0, want - len(shared))
        got = self.cache.alloc(t.tid + "#kv", priv)
        if got is None:
            got = self.cache.alloc(t.tid + "#kv",
                                   min(priv, self.cache.free_pages))
        t.kv_reserved = len(shared) + len(got or [])
        t.ckpt_ref = None
        self._drop_ckpt_root()
        t.resume_step = None
        t.task.resume()
        t.fed = True
        t.state = STATE_RESUMED
        self.fault_log.record(self._clock, "resume", tid=t.tid,
                              kv_reserved=t.kv_reserved)
        return True

    # --------------------------------------------- fault injection ------
    def _apply_due_faults(self, steps: int) -> None:
        """Epoch-boundary fault hook: release expired pressure holds,
        then fire every due event of the installed plan."""
        for h in list(self._pressure_holds):
            if h[0] <= self._clock:
                self.cache.free(h[1], None)
                self._pressure_holds.remove(h)
                self.fault_log.record(self._clock, "pressure_release",
                                      holder=h[1])
        if self.faults is None:
            return
        for e in self.faults.due(self._clock):
            self.inject(e, steps)

    def inject(self, e: FaultEvent, steps: int = 0) -> None:
        """Apply one fault event now.  ``replica_kill`` is a fleet fault:
        a single server ignores it."""
        if e.kind == "pool_pressure":
            holder = f"fault#p{self._pressure_n}"
            self._pressure_n += 1
            # allocate through the pool, so the pressure hook reclaims
            # cold prefixes as a real grant burst would
            got = self.cache.alloc(holder, e.pages)
            if got is None:
                got = self.cache.alloc(
                    holder, min(e.pages, self.cache.free_pages))
            self._pressure_holds.append(
                [self._clock + max(1, e.hold_epochs) * self.epoch_len,
                 holder])
            self.fault_log.record(self._clock, "pool_pressure",
                                  seized=len(got or []),
                                  free_after=self.cache.free_pages)
            if self.cache.free_pages == 0:
                # the spike emptied the pool: preempt one victim so the
                # co-tenants keep decoding
                v = self._select_victim()
                if v is not None:
                    self.preempt_tenant(v, e.hold_epochs,
                                        reason="pool_pressure")
        elif e.kind == "straggler":
            self._straggler_left = max(self._straggler_left,
                                       max(1, e.hold_epochs))
            self._straggler_factor = e.factor
            self.fault_log.record(self._clock, "straggler",
                                  epochs=e.hold_epochs, factor=e.factor)
        elif e.kind == "bad_prompt":
            spec = e.spec
            if spec is None:
                aid = e.target if isinstance(e.target, str) else "yi-9b"
                spec = TenantSpec(aid, prompt_len=4 * self.max_len,
                                  n_inferences=2)
            self.fault_log.record(self._clock, "bad_prompt",
                                  prompt_len=spec.prompt_len)
            self._queue.append([spec, None, self._clock])
            self._queue.sort(key=lambda it: it[2])
        elif e.kind == "preempt":
            t = None
            if e.target is not None:
                t = next((x for x in self.tenants if x.tid == e.target),
                         None)
            if t is None:
                t = self._select_victim()
            if t is not None:
                self.preempt_tenant(t, e.hold_epochs, reason="injected")

    def _observe_epoch(self) -> None:
        """Feed the straggler detector one epoch: armed only under a
        fault plan, fed a logical duration (1.0 per clean epoch, the
        injected factor while a straggler is active).  A trip preempts
        the policy's victim and resets the strike counter."""
        if self.faults is None:
            return
        dt = 1.0
        if self._straggler_left > 0:
            self._straggler_left -= 1
            dt = self._straggler_factor
        if self.straggler.observe(self._epochs - self._run_base["epochs"],
                                  dt):
            self.straggler.strikes = 0
            v = self._select_victim()
            self.fault_log.record(self._clock, "straggler_trip",
                                  victim=v.tid if v else None)
            if v is not None:
                self.preempt_tenant(v, reason="straggler")

    def _wake_steps(self) -> List[int]:
        """Every future logical step that can create work while the
        current epoch is idle: queued arrivals, scheduled resumes,
        pressure-hold releases, unfired fault events."""
        wake = [it[2] for it in self._queue]
        wake += [t.resume_step for t in self.tenants
                 if not t.departed and t.state == STATE_PREEMPTED
                 and t.resume_step is not None]
        wake += [h[0] for h in self._pressure_holds]
        if self.faults is not None:
            nxt = self.faults.peek_step()
            if nxt is not None:
                wake.append(nxt)
        return wake

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
        for SSM and hybrid archs also on SSD chunk boundaries: lcm(LANE,
        ssm_chunk), the segmentation chunked == one-shot needs."""
        if cfg.family in ("ssm", "hybrid") and cfg.ssm_chunk > 0:
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
        host memory ahead of the event.  A dedup-eligible tenant
        registers its prompt's caches in the prefix index."""
        t.fed = True
        t.tokens_served += self.batch
        t.index = t.prompt_len
        t.ptask.depart()
        if t.dedup is not None:
            self._register_prefix(t)
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

    def _register_prefix(self, t: Tenant) -> None:
        """Producer side of the dedup (the reference's): publish the
        finished prompt's caches as a chain of PrefixIndex entries at
        chunk-grid granularity (SSM: the full-length entry only, its
        state is cumulative), each holding the slice of the tenant's KV
        reservation its length accounts for; the full-length entry also
        stores the first token.  The payload is a device clone of the
        caches, queued after the final chunk and before the next epoch
        writes another row, its K/V leaves cut to the prompt's rows (the
        seeder reads no more; recurrent leaves have no time axis and are
        cloned whole); the entries hold its last reference."""
        arch, params_key = t.dedup
        full_key = self.prefix.prefix_key(arch, params_key,
                                          t.prompt.tobytes())
        if full_key in self.prefix.entries:
            # identical prompt already published (this tenant may be a
            # full hit itself): refresh its LRU stamp, no new copy
            self.prefix.touch(full_key)
            return
        snap = [{name: (leaf[:, :t.prompt_len] if is_kv_leaf(name)
                        else leaf).clone()
                 for name, leaf in layer.items()}
                for layer in t.caches]
        token = t.token.clone()
        self._snapshot_bytes += sum(leaf.nbytes for layer in snap
                                    for leaf in layer.values())
        align = self._chunk_align(t.cfg)
        if t.cfg.family in ("dense", "moe"):
            bounds = list(range(align, t.prompt_len, align))
            bounds.append(t.prompt_len)
        else:
            bounds = [t.prompt_len]
        resv = sorted(self.cache.pages_of(t.tid + "#kv"))
        parent, prev_pages = None, 0
        for p in bounds:
            budget = min(_kv_reserve_pages(t.cfg, self.batch, p,
                                           t.kv_dtype),
                         len(resv))
            payload = {"snap": snap,
                       "token": token if p == t.prompt_len else None}
            parent = self.prefix.register(
                arch, params_key, t.prompt[:, :p].tobytes(), p,
                resv[prev_pages:budget], payload, parent=parent)
            prev_pages = max(prev_pages, budget)

    def _stamp_ttft(self, t: Tenant) -> None:
        """The serving loop's one wait on the device: until the first
        token exists.  Then the page scales are recorded."""
        if t.first_token_event is not None:
            t.first_token_event.synchronize()
        t.ttft = time.time() - t.admitted_wall
        self._record_page_scales(t)

    def _scale_rows(self, t: Tenant) -> Optional[torch.Tensor]:
        """[pf_pos] fp32: each live prompt row's largest dequant scale
        over every attention layer's K and V, batch rows and KV heads;
        None for a native cache."""
        if t.kv_dtype == "native" or t.caches is None or t.pf_pos <= 0:
            return None
        # each scale leaf (a head-split cache's too: one a shard) reduced
        # over its batch rows and heads, then the max over leaves
        rows = [leaf[:, :t.pf_pos].amax(dim=(0, 2, 3)).to(self.device)
                for c in t.caches for name, leaf in c.items()
                if name.partition("@")[0] in ("k_scale", "v_scale")]
        return torch.stack(rows).amax(dim=0)

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
        if self.lookahead:
            self._lookahead_adjust(run, ks, sels, F)
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

    # ------------------------------------ predictive grant lookahead ----
    def _upcoming_free_delta(self) -> int:
        """Projected page-pool delta over the next epoch from events known
        one epoch early on the logical clock (the reference's): queued
        arrivals falling due claim their KV reservation (priced at the
        server's width, where the reference prices the reduced config),
        tenants whose budget expires free their reservation and grant
        pages, prompts completing prefill start claiming grant pages."""
        delta = 0
        horizon = self._clock + self.epoch_len
        for spec, _, step in self._queue:
            if step > horizon:
                break
            if spec.prompt_len > 0:
                aid = (spec.model if isinstance(spec.model, str)
                       else spec.model.name)
                kv = self.kv_dtype if self.kv_dtype != "auto" else "native"
                delta -= _kv_reserve_pages(self._cfg(aid), self.batch,
                                           spec.prompt_len, kv)
        for t in self.tenants:
            if t.departed:
                continue
            if (t.budget_left is not None
                    and 0 < t.budget_left <= self.epoch_len):
                delta += self.cache.allocated_pages(t.tid + "#kv")
                delta += t.task.held_pages
            if t.prefilling and t.prompt_len - t.pf_pos <= self.prefill_block:
                delta -= min(m.p_need
                             for m in t.task.model.mapping.mcts[0].lwms)
        return delta

    def _lookahead_adjust(self, run: List[Tenant], ks: List[int],
                          sels: List[List[Selection]], F: int) -> None:
        """Predictive grant lookahead (the reference's): for the tenants
        whose grants would not survive the projected next-epoch pool,
        compare the NEC-priced DRAM of staying on the aggressive grant
        now and being forced down next epoch (plus the thrashed pages)
        against taking the stable grant for both epochs, and keep the
        cheaper.  Mutates only the not-yet-committed selections."""
        delta = self._upcoming_free_delta()
        if delta >= 0:
            return
        F_next = max(0, F + delta)
        contested = []
        for i in range(len(run)):
            need = max((s.p_cur for s in sels[i]), default=0)
            if need > F_next:
                contested.append((need - F_next, i))
        contested.sort(reverse=True)
        for shortfall, i in contested[:4]:
            task = run[i].task
            stable = self._simulate_block_sels(task, 0.0, F_next)
            if stable is None:
                continue
            cur_cands = [s.candidate for s in sels[i]]
            stable_cands = [s.candidate for s in stable]
            k = ks[i]
            stay = (project_epoch_dram(task, cur_cands, k)
                    + project_epoch_dram(task, stable_cands, k)
                    + shortfall * PAGE_BYTES * 2)
            switch = 2 * project_epoch_dram(task, stable_cands, k)
            if switch < stay:
                sels[i] = stable
                self._lookahead_adjusted += 1

    def _plan_epoch(self, now: float, steps: int) -> List[Tuple]:
        """Timed wrapper around the epoch planner (host scheduling wall,
        admission apart)."""
        t0 = time.perf_counter()
        a0 = self._admit_wall
        try:
            with self._on_device():
                return self._plan_epoch_inner(now, steps)
        finally:
            self._sched_wall += time.perf_counter() - t0 - (self._admit_wall
                                                             - a0)

    @property
    def _sched_walls(self) -> Tuple[float]:
        """The scheduling wall since construction as a one-element tuple
        (``perfbench/harness.py`` sums it)."""
        return (self._sched_wall,)

    def counters(self) -> Dict[str, float]:
        """A snapshot of the server's counters, each since construction:
        programs captured (``captures``) and the host seconds inside the
        captures (``capture_s``), of their eager warm-ups (``warmups``,
        ``warmup_s``: one per warm-up key, ``_warmup_key``, so
        ``captures - warmups`` counts the captures that reused an earlier
        warm-up), of their graph recordings (``record_s``) and of
        their programs' first replays (``first_replay_s``); epochs
        dispatched (``epochs``), their host planning (``sched_wall_s``,
        admission apart) and dispatch (``dispatch_wall_s``) seconds, and
        admission's (``admit_wall_s``)."""
        return {"captures": self._captures, "capture_s": self._capture_s,
                "warmups": self._warmups, "warmup_s": self._warmup_s,
                "record_s": self._record_s,
                "first_replay_s": self._first_replay_s,
                "epochs": self._epochs, "sched_wall_s": self._sched_wall,
                "dispatch_wall_s": self._dispatch_wall,
                "admit_wall_s": self._admit_wall}

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
            self._apply_due_faults(steps)
            self._try_resume()
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
            # idle gap: fast-forward to the next wake-up source (queued
            # arrival, scheduled resume, pressure release, fault event)
            wake = self._wake_steps()
            if not wake:
                return work
            self._clock = max(self._clock, min(wake))

    # ------------------------------------------------------- execution --
    def _advance(self, t: Tenant, k: int) -> None:
        if t.preempted_wall is not None:
            # the first dispatch after a resume (its programs captured
            # again) ends the tenant's recovery
            t.recovery_s.append(time.time() - t.preempted_wall)
            t.preempted_wall = None
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
            t.index_dev, t.enc, kv_len=kv)
        self._feed(t, tok, chunk)

    def _prefill_fn(self, t: Tenant, chunk: int, kv: int) -> _CompiledEntry:
        """The program of one (tenant, chunk length, kv window) prompt
        chunk, from the prefill LRU (built and, on the card, captured on
        a miss).  The reference keeps one jit per arch, whose own cache
        keys (chunk, kv); a graph also binds the tenant."""
        key = (t.tid, chunk, kv)
        entry = self._prefill_jits.get(key)
        if entry is None:
            entry = self._compile(lambda: self._prefill_body(t, chunk, kv),
                                  _warmup_key(key, [t]), [t], chunk)
            self._prefill_jits[key] = entry
        return entry

    def _dispatch_prefill(self, item: Tuple) -> Optional[Tenant]:
        """Queue one prefill chunk on the device (one replay).  Returns
        the tenant when this was its prompt's final chunk."""
        _, t, _, chunk = item
        tr = self.tracer
        with (tr.span("serve.prefill_chunk", (t.tid,), "prefill") if tr.on
              else spans.OFF):
            entry = self._prefill_fn(t, chunk, self._kv_len(t.pf_pos + chunk))
            with (tr.span("serve.replay", (t.tid,), "prefill") if tr.on
                  else spans.OFF):
                entry()
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
            enc = ([g.enc for g in group] if group[0].enc is not None
                   else None)

            def run() -> None:
                toks, _ = core(params, [g.caches for g in group],
                               torch.stack([g.token for g in group]),
                               torch.stack([g.index_dev for g in group]),
                               enc, plan=plan, k=k, kv_len=kv)
                for g, tk in zip(group, toks):
                    self._feed(g, tk, k)
            return run
        t = group[0]
        core = self._epoch_cores[name]

        def run() -> None:
            toks, _ = core(t.params, t.caches, t.token, t.index_dev, t.enc,
                           plan=plan, k=k, kv_len=kv)
            self._feed(t, toks, k)
        return run

    def _build_entry(self, key: Tuple) -> _CompiledEntry:
        live = {t.tid: t for t in self.tenants if not t.departed}
        group = [live[tid] for tid in key[5]]
        return self._compile(self._decode_fn(key), _warmup_key(key, group),
                             group, key[3])

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
        every recurrent leaf (``conv``, ``ssm``) of an SSM or hybrid
        tenant's caches.  The KV rows and log entries it
        writes lie in [position, position + advance), which the replay
        writes again before anything reads them.  Its launches are not
        counted."""
        for t in tenants:
            if self._device_pos(t) + advance > self.max_len:
                raise ValueError(f"{t.tid}: warm-up at position "
                                 f"{self._device_pos(t)} + {advance} past "
                                 f"max_len {self.max_len}")
        bufs = [b for t in tenants for b in
                [t.token, t.index_dev] + [leaf for c in t.caches
                                          for name, leaf in c.items()
                                          if not is_kv_leaf(name)]]
        saved = [b.clone() for b in bufs]
        before = kcount.snapshot()
        fn()
        kcount.add(kcount.delta(before), -1)
        for b, v in zip(bufs, saved):
            b.copy_(v)

    def _compile(self, fn: Callable[[], None], warm: Tuple,
                 tenants: List[Tenant], advance: int) -> _CompiledEntry:
        """One program: the eager closure where the server captures
        nothing, else ``fn`` captured into a CUDA graph on the server's
        capture stream and memory pool, after an eager warm-up where the
        warm-up key ``warm`` (``_warmup_key``: the program key without its
        kv window and tenant ids) has had none yet.  A later kv window of
        the same key is recorded at once, while the device still runs the
        epochs queued before it.  The launches the capture counted are
        taken back and kept for the replays.  A failure raises."""
        if not self._capture_graphs:
            return _CompiledEntry(fn)
        t0 = time.perf_counter()
        tr = self.tracer
        # traced: the crossing's first device mark, on the serving stream
        # before the capture stream joins it
        rec = (tr.crossing(warm[0], tuple(t.tid for t in tenants)) if tr.on
               else None)
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
        stream = self._capture_stream
        main = torch.cuda.current_stream(self.device)
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            if self._anchor is None:
                self._anchor = self._anchor_graph()
            if warm not in self._warm_sigs:
                w0 = time.perf_counter()
                with (tr.span(spans.WARMUP, crossing=rec) if rec is not None
                      else spans.OFF):
                    self._warm_up(fn, tenants, advance)
                self._warm_sigs.add(warm)
                self._warmups += 1
                self._warmup_s += time.perf_counter() - w0
            graph = torch.cuda.CUDAGraph()
            before = kcount.snapshot()
            r0 = time.perf_counter()
            with (tr.span(spans.RECORD, crossing=rec) if rec is not None
                  else spans.OFF):
                graph.capture_begin(pool=self._graph_pool)
                try:
                    fn()
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        # the capture is invalid already; report fn's error
                        pass
                    raise
                graph.capture_end()
            self._record_s += time.perf_counter() - r0
            launches = kcount.delta(before)
            kcount.add(launches, -1)
        main.wait_stream(stream)
        self._captures += 1
        self._capture_s += time.perf_counter() - t0
        return _CompiledEntry(fn, graph, launches,
                              first=lambda g: self._first_replay(g, rec))

    def _first_replay(self, graph: Any, rec: Optional[spans.Crossing]) -> None:
        """A program's first replay (its graph's upload), timed; traced,
        after the crossing's second device mark, on the serving stream."""
        t0 = time.perf_counter()
        if rec is None:
            graph.replay()
        else:
            rec.d1 = self.tracer.event()
            with self.tracer.span(spans.FIRST_REPLAY, crossing=rec):
                graph.replay()
        self._first_replay_s += time.perf_counter() - t0

    def _anchor_graph(self) -> Tuple[Any, torch.Tensor]:
        """A one-kernel graph the server keeps for its lifetime, captured
        first into a new pool that every program then shares.  A pool
        lives while some graph uses it, on the device and on the pinned
        host side alike, and a capture into a pool whose last graph is
        gone fails: the anchor keeps it alive when every program in it
        has been evicted (a preemption, the last departure)."""
        buf = torch.zeros(1, device=self.device)
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        buf.add_(1)
        graph.capture_end()
        self._graph_pool = graph.pool()
        return graph, buf

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
        # a preempted tenant has no caches to bind: its programs are
        # captured again at its first dispatch after the resume
        parked = {t.tid for t in self.tenants if t.state == STATE_PREEMPTED}
        for epoch_key in self._enumerate_epoch_keys(steps):
            for key in epoch_key:
                if parked.intersection(key[5]):
                    continue
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
            with self._on_device():
                self._dispatch_epoch_inner(work)
        finally:
            self._dispatch_wall += time.perf_counter() - t0
            self._epochs += 1
            self._epoch_compiles.append(self.compile_misses() - m0)
            self._observe_epoch()

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
        tr = self.tracer
        for item in work:
            if item[0] == "prefill":
                continue
            entry = self._fused_epoch_fn(item)
            kind, who, _, k = item
            group = who if kind == "bucket" else [who]
            with (tr.span("serve.replay", tuple(t.tid for t in group), kind)
                  if tr.on else spans.OFF):
                entry()
            for t in group:
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
        nxt, _ = t.decode(t.params, t.caches, t.token, t.index_dev, t.enc,
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
        self._run_base = self.counters()
        self._epoch_compiles = []
        self._lookahead_adjusted = 0
        self._batched_runs = 0
        self._oracle_runs = 0
        self._run_steps = steps
        for t in self.tenants:
            t.run_steps = 0
            if t.admitted_wall is None or t.tokens_served == 0:
                t.admitted_wall = self._run_t0
        self._run_tokens_before = sum(t.tokens_served for t in self.tenants)

    def run(self, steps: int = 16) -> Dict[str, Any]:
        with self._on_device():
            return self._run(steps)

    def _run(self, steps: int) -> Dict[str, Any]:
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
                self._apply_due_faults(steps)
                self._try_resume()
                self._admit_due(steps)
                self._process_departures()
                self._sequential_prefills_due(now)
                runnable = [t for t in self.tenants
                            if self._decodable(t, steps)]
                if not runnable:
                    wake = self._wake_steps()
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
        now, base = self.counters(), self._run_base
        sched = now["sched_wall_s"] - base["sched_wall_s"]
        dispatch = now["dispatch_wall_s"] - base["dispatch_wall_s"]
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
                        "prefix_hit": t.prefix_hit,
                        "prefill_computed": t.pf_computed,
                        "state": t.state,
                        "preemptions": t.preemptions,
                        "recovery_s": list(t.recovery_s),
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
            # tokens prefilled on the device: the gap to prefill_tokens
            # is what prefix dedup saved
            "prefill_computed": sum(t.pf_computed for t in self.tenants),
            "prefix": self.prefix.stats(),
            "p95_ttft_s": (float(np.percentile(ttfts, 95)) if ttfts
                           else None),
            "host": {
                # the replica group's size, and whether its programs are
                # captured as CUDA graphs (False on the CPU, in the
                # serial loop and over distinct cards)
                "tp": len(self.group),
                "captured": self._capture_graphs,
                # this run's epochs, and the host seconds of their
                # planning, dispatch (queueing their device work) and
                # admissions
                "epochs": now["epochs"] - base["epochs"],
                "sched_wall_s": sched,
                "dispatch_wall_s": dispatch,
                "admit_wall_s": now["admit_wall_s"] - base["admit_wall_s"],
                "sched_frac": sched / dispatch if dispatch > 0 else 0.0,
                "epoch_compiles": list(self._epoch_compiles),
                "batched_runs": self._batched_runs,
                "oracle_runs": self._oracle_runs,
                "lookahead_adjusted": self._lookahead_adjusted,
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
                # entries a preemption evicted (its tenant's caches go),
                # and the bytes of the prefix snapshots cloned
                "preempt_evictions": self._preempt_evictions,
                "snapshot_bytes": self._snapshot_bytes,
                "jit_cache": {
                    "fused": {"hits": self._fused_jits.hits,
                              "misses": self._fused_jits.misses,
                              "evictions": self._fused_jits.evictions},
                    "prefill": {"hits": self._prefill_jits.hits,
                                "misses": self._prefill_jits.misses,
                                "evictions": self._prefill_jits.evictions},
                },
            },
            "overload": {
                "deferrals": self.deferrals,
                "shed": list(self.shed),
                "shed_count": len(self.shed),
                "queued": len(self._queue),
            },
            "faults": {
                "counts": self.fault_log.counts(),
                "log": list(self.fault_log.records),
                "preemptions": sum(t.preemptions for t in self.tenants),
                "recovery_s": [r for t in self.tenants
                               for r in t.recovery_s],
                # bytes on disk of the snapshot checkpoints written
                "checkpoint_bytes": self._ckpt_bytes,
            },
        }


class FleetServer:
    """Multi-tenant serving over a :class:`ServingMesh` (port of
    src/repro/launch/serve.py::FleetServer, decision for decision): one
    epoch-pipelined :class:`MultiTenantServer` per replica, each with its
    own CaMDN control stack (:class:`ReplicaAllocators`: no page pool,
    NEC ledger, allocator profile or prefix index is shared between
    replicas), behind a global admission layer.

    * Topology: an ``(n_replicas, tp)`` mesh from
      :func:`~repro_torch.launch.mesh.make_serving_mesh` over
      ``devices`` (default: every visible CUDA device).  Replica ``r``
      serves on ``replica_devices(mesh)[r]``: every tenant's params,
      caches and buffers are allocated there, so its programs run there.
      Replicas may share a device (``devices=["cuda:0", "cuda:0"]``).
      At ``tp > 1`` a replica is a tensor-parallel group of ``tp``
      devices (which may repeat), its tenants' params split over them.
    * Routing: prefix match first (longest resident prompt prefix in a
      replica's index), then load (pages granted out of the replica's
      pool plus its queued prefill chunks), then active tenants, then
      replica index.  The routed spec's ``seed`` is pinned to the global
      admission index, so params, prompt and tid do not depend on the
      route.
    * Lockstep epochs: every live replica plans one epoch per fleet
      round, then all are dispatched back to back; nothing in the round
      waits for the device beyond the replicas' own TTFT stamps, so on
      one card replica ``r + 1``'s host scheduling overlaps replica
      ``r``'s replays.  Idle gaps fast-forward every clock together.
    * Failover: ``replica_kill`` (a fault event, or :meth:`kill_replica`)
      re-routes a dead replica's live tenants onto the survivors with
      their remaining budgets.
    * Contract: replaying ``replica_scenarios()[r]`` on a fresh
      single-device server reproduces replica ``r``'s decode streams
      bit for bit.

    Added to the reference's arguments, and passed to every replica:
    ``devices``, ``reduced``, ``params_fn`` and ``prompt_fn`` (see
    :class:`MultiTenantServer`).
    """

    def __init__(self, n_replicas: Optional[int] = None, tp: int = 1,
                 mesh: Optional[ServingMesh] = None,
                 arch_ids: Optional[List[str]] = None,
                 batch: int = 2, max_len: int = 128,
                 pages_per_replica: int = VMEM_PAGES, epoch_len: int = 8,
                 tenants: Optional[List[TenantSpec]] = None,
                 arrivals: Optional[PoissonArrivals] = None,
                 prefill_chunk: int = 2 * LANE, steps_per_s: float = 1.0,
                 qos_targets: Optional[Dict[str, float]] = None,
                 prefix_dedup: bool = False, kv_dtype: str = "native",
                 faults: Optional[FaultPlan] = None,
                 devices: Optional[List[Any]] = None,
                 reduced: bool = True,
                 params_fn: Optional[ParamsFn] = None,
                 prompt_fn: Optional[PromptFn] = None):
        if mesh is None:
            mesh = make_serving_mesh(n_replicas, tp=tp, devices=devices)
        self.mesh = mesh
        self.n_replicas = int(mesh.devices.shape[0])
        self.tp = int(mesh.devices.shape[1])
        self.epoch_len = max(1, int(epoch_len))
        self.steps_per_s = steps_per_s
        self.prefix_dedup = bool(prefix_dedup)
        self.registry = ReplicaAllocators(CacheConfig(
            total_bytes=pages_per_replica * PAGE_BYTES,
            num_slices=1, num_ways=1, npu_ways=1, page_bytes=PAGE_BYTES))
        subs = replica_submeshes(mesh)
        self.replicas = [
            MultiTenantServer([], batch=batch, max_len=max_len,
                              epoch_len=self.epoch_len, pipeline=True,
                              admission="interleaved",
                              prefill_chunk=prefill_chunk,
                              steps_per_s=steps_per_s,
                              qos_targets=dict(qos_targets or {}),
                              device=subs[r], replica=f"r{r}",
                              control=self.registry.get(f"r{r}"),
                              prefix_dedup=prefix_dedup,
                              kv_dtype=kv_dtype, reduced=reduced,
                              params_fn=params_fn, prompt_fn=prompt_fn)
            for r in range(self.n_replicas)]
        self._clock = 0               # lockstep with every replica clock
        self._n_admitted = 0          # global admission index -> seeds
        # fleet-level fault injection: replica_kill is handled here
        # (failover re-routing); every other kind is forwarded to the
        # target replica's own inject()
        self.faults = faults
        self.fault_log = FaultLog()
        self._dead: set = set()       # replica indices that have failed
        self._moved: List[Dict[str, Any]] = []   # failover re-routes
        self.scenario = FleetScenario(
            self.n_replicas, [[] for _ in range(self.n_replicas)])
        self._util_samples: List[List[float]] = [
            [] for _ in range(self.n_replicas)]
        self._queue: List[List] = []
        specs: List[TenantSpec] = [TenantSpec(a) for a in (arch_ids or [])]
        specs += list(tenants or [])
        if arrivals is not None:
            specs += arrivals.specs()
        specs.sort(key=lambda s: s.arrive_at)
        now = time.time()
        for spec in specs:
            if spec.arrive_at <= 0.0:
                self._route(spec, now)
            else:
                step = int(math.ceil(spec.arrive_at * steps_per_s))
                self._queue.append([spec, None, step])
        self._queue.sort(key=lambda it: it[2])

    def enqueue(self, specs: List[TenantSpec]) -> None:
        """Queue arrivals relative to the current fleet clock."""
        for spec in sorted(specs, key=lambda s: s.arrive_at):
            step = self._clock + int(math.ceil(spec.arrive_at
                                               * self.steps_per_s))
            self._queue.append([spec, None, step])
        self._queue.sort(key=lambda it: it[2])

    # ---------------------------------------------------------- routing --
    def _match_lens(self, spec: TenantSpec) -> List[int]:
        """Prefix-affinity probe: the longest resident prefix each
        replica's index holds for this spec's prompt (0 everywhere when
        the spec is not dedup-eligible); probes touch no counter and no
        LRU stamp.  The probe prompt is drawn at the replicas' width
        through their ``prompt_fn``, so it is the prompt the replica
        would admit (the reference draws at the reduced width: the same
        at ``reduced=True``)."""
        none = [0] * self.n_replicas
        srv0 = self.replicas[0]
        if not (self.prefix_dedup and spec.param_seed is not None
                and spec.prompt_seed is not None and spec.prompt_len > 0):
            return none
        aid = spec.model if isinstance(spec.model, str) else spec.model.name
        cfg = srv0._cfg(aid)
        if cfg.family == "encdec":
            return none
        # session prompts do not depend on the admission index
        prompt = np.asarray(srv0._prompt_fn(spec, 0, cfg, srv0.batch),
                            np.int32)
        cands = _prefix_candidates(prompt, spec.prompt_len,
                                   srv0._chunk_align(cfg))
        # probe under the key a fixed-precision replica registers with;
        # "auto" probes the native rung
        return [srv.control.prefix.match_len(
                    cfg.name,
                    _params_key(spec, srv.kv_dtype
                                if srv.kv_dtype != "auto" else "native"),
                    cands)
                for srv in self.replicas]

    def _route(self, spec: TenantSpec, due_wall: Optional[float]) -> int:
        """Admit one due spec: the replica holding the longest matching
        prompt prefix, then the least loaded, then the fewest active
        tenants, then the lowest index."""
        match = self._match_lens(spec)
        loads = [(-match[r], srv.load(), srv.active_count(), r)
                 for r, srv in enumerate(self.replicas)
                 if r not in self._dead]
        assert loads, "no live replica to route to"
        _, _, _, r = min(loads)
        routed = dataclasses.replace(
            spec,
            seed=self._n_admitted if spec.seed is None else spec.seed,
            arrive_at=self._clock / self.steps_per_s)
        self._n_admitted += 1
        t = self.replicas[r].admit_routed(routed, due_wall)
        self.scenario.per_replica[r].append(routed)
        self.scenario.routes.append((t.tid, r))
        return r

    def _route_due(self) -> None:
        now = time.time()
        for item in self._queue:
            if item[1] is None and item[2] <= self._clock:
                item[1] = now   # TTFT clock: the request exists from here
        while self._queue and self._queue[0][2] <= self._clock:
            spec, due_wall, _ = self._queue.pop(0)
            self._route(spec, due_wall)

    # ----------------------------------------------------- fault paths --
    def kill_replica(self, r: int) -> List[str]:
        """Fail replica ``r`` at an epoch boundary: the router stops
        offering it, and its live tenants' specs (tid-pinned by their
        seeds) re-route onto the survivors with their remaining decode
        budgets, re-prefilling there (warm where a survivor's index holds
        the prompt prefix).  A moved tenant's recovery is its TTFT on
        the survivor, clocked from the kill.  Each dead tenant departs
        through ``_depart``, which evicts its programs before its device
        buffers go back to the allocator (the survivors' too, when the
        replicas share a device).  Returns the moved tids; killing the
        last live replica is refused (logged, not raised)."""
        if r in self._dead:
            return []
        if len(self._dead) + 1 >= self.n_replicas:
            self.fault_log.record(self._clock, "replica_kill",
                                  target=f"r{r}", skipped="last live replica")
            return []
        self._dead.add(r)
        kill_wall = time.time()
        srv = self.replicas[r]
        by_tid: Dict[str, TenantSpec] = {}
        for spec in self.scenario.per_replica[r]:
            aid = (spec.model if isinstance(spec.model, str)
                   else spec.model.name)
            by_tid[f"t{spec.seed}:{aid}"] = spec
        moved: List[str] = []
        for t in list(srv.tenants):
            if t.departed:
                continue
            left = t.budget_left       # None = unbounded resident tenant
            spec = by_tid.get(t.tid)
            srv._depart(t)
            if spec is None or (left is not None and left <= 0):
                continue
            respec = spec if left is None else dataclasses.replace(
                spec, n_inferences=left)
            r_new = self._route(respec, kill_wall)
            moved.append(t.tid)
            self._moved.append({"tid": t.tid, "from": f"r{r}",
                                "to": f"r{r_new}", "step": self._clock})
        self.fault_log.record(self._clock, "replica_kill",
                              target=f"r{r}", moved=moved)
        return moved

    def _apply_fleet_faults(self, steps: int) -> None:
        """Consume due fault events on the fleet clock: ``replica_kill``
        here, every other kind forwarded to its target replica (by "rN"
        target, by the replica owning a tenant-id target, else the
        lowest-index live replica)."""
        if self.faults is None:
            return
        live = lambda: sorted(set(range(self.n_replicas)) - self._dead)
        for e in self.faults.due(self._clock):
            if e.kind == "replica_kill":
                tgt = e.target
                rid = (int(tgt[1:]) if tgt and tgt.startswith("r")
                       and tgt[1:].isdigit() else (live() or [None])[0])
                if rid is not None:
                    self.kill_replica(rid)
                continue
            rid = None
            if e.target and e.target.startswith("r") \
                    and e.target[1:].isdigit():
                rid = int(e.target[1:])
            elif e.target:   # tenant id: find the replica that owns it
                for i in live():
                    if any(t.tid == e.target and not t.departed
                           for t in self.replicas[i].tenants):
                        rid = i
                        break
            if rid is None:
                rid = (live() or [None])[0]
            if rid is not None and rid not in self._dead:
                self.replicas[rid].inject(e, steps)

    def replica_scenarios(self) -> List[List[TenantSpec]]:
        """The routed specs per replica (seeds pinned to the global
        admission index, ``arrive_at`` rebased to the admitting clock)."""
        return [list(s) for s in self.scenario.per_replica]

    # -------------------------------------------------------------- run --
    def run(self, steps: int = 16) -> Dict[str, Any]:
        t0 = time.time()
        for srv in self.replicas:
            srv._begin_run(steps)
        self._apply_fleet_faults(steps)
        self._route_due()
        pendings = [None if r in self._dead else srv._plan_epoch(0.0, steps)
                    for r, srv in enumerate(self.replicas)]
        self._clock += self.epoch_len
        while any(pendings) or self._queue:
            # every replica's epoch back to back, all asynchronous
            for srv, p in zip(self.replicas, pendings):
                if p:
                    srv._dispatch_epoch(p)
            for r, srv in enumerate(self.replicas):
                self._util_samples[r].append(
                    0.0 if r in self._dead else srv.page_utilization())
            if not any(pendings) and self._queue:
                nxt = self._queue[0][2]
                if self.faults is not None:
                    f = self.faults.peek_step()
                    if f is not None and self._clock < f < nxt:
                        nxt = f   # a fault lands in the idle gap first
                if nxt > self._clock:   # fleet-wide idle gap: fast-forward
                    self._clock = nxt
                    for srv in self.replicas:
                        srv._clock = max(srv._clock, nxt)
            # kills land here, after the dispatched epoch and before the
            # next is planned: every tenant is at an epoch boundary
            self._apply_fleet_faults(steps)
            self._route_due()
            now = time.time() - t0
            pendings = [None if r in self._dead
                        else srv._plan_epoch(now, steps)
                        for r, srv in enumerate(self.replicas)]
            self._clock += self.epoch_len
        results = [srv._finish_run() for srv in self.replicas]
        return self._merge(results, time.time() - t0)

    def _merge(self, results: List[Dict[str, Any]],
               wall: float) -> Dict[str, Any]:
        tenants: Dict[str, Any] = {}
        replicas: List[Dict[str, Any]] = []
        ttfts: List[float] = []
        total = 0
        # dead replicas merge first, so a failed-over tenant's tid lands
        # on its survivor's entry
        order = sorted(range(self.n_replicas),
                       key=lambda r: (0 if r in self._dead else 1, r))
        for r in order:
            for tid, info in results[r]["tenants"].items():
                info = dict(info)
                info["replica"] = f"r{r}"
                tenants[tid] = info
        for r, (srv, res) in enumerate(zip(self.replicas, results)):
            total += res["tokens_served"]
            util = self._util_samples[r]
            replicas.append({
                "replica": f"r{r}",
                "dead": r in self._dead,
                "tokens_served": res["tokens_served"],
                "dram_bytes": res["dram_bytes"],
                "page_util_mean": float(np.mean(util)) if util else 0.0,
                "tenants": sorted(res["tenants"]),
            })
            ttfts += [t.ttft for t in srv.tenants
                      if t.ttft is not None and t.admitted_wall is not None
                      and t.admitted_wall >= srv._run_t0]
        # balance over survivors: a dead replica's idle pool is a fault
        # outcome, not a routing imbalance
        utils = [rep["page_util_mean"] for rep in replicas
                 if not rep["dead"]]
        balance = min(utils) / max(utils) if utils and max(utils) > 0 else 1.0
        # recovery: the survivor's TTFT, clocked from the kill
        recov: Dict[str, float] = {}
        for m in self._moved:
            info = tenants.get(m["tid"])
            if info is not None and info.get("ttft_s") is not None \
                    and info["replica"] == m["to"]:
                recov[m["tid"]] = float(info["ttft_s"])
        return {
            "tenants": tenants,
            "mode": "fleet",
            "n_replicas": self.n_replicas,
            "tp": self.tp,
            "epoch_len": self.epoch_len,
            "wall_s": wall,
            "tokens_served": total,
            "tokens_per_s": total / wall if wall > 0 else 0.0,
            "dram_bytes": sum(rep["dram_bytes"] for rep in replicas),
            "p95_ttft_s": (float(np.percentile(ttfts, 95)) if ttfts
                           else None),
            "replicas": replicas,
            "routes": list(self.scenario.routes),
            "page_util_balance": balance,
            "failover": {
                "killed": sorted(f"r{r}" for r in self._dead),
                "moved": list(self._moved),
                "recovery_s": recov,
                "recovery_p95_s": (float(np.percentile(
                    list(recov.values()), 95)) if recov else None),
            },
            "faults": {
                "counts": self.fault_log.counts(),
                "log": list(self.fault_log.records),
                "replica_counts": [res["faults"]["counts"]
                                   for res in results],
            },
        }


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """The reference's serving CLI (src/repro/launch/serve.py::main): the
    same flags, defaults and printed ``[serve]`` / ``[fleet]`` lines, on
    the port's servers.  Added: ``--device`` (default ``cuda``) and
    ``--full-width`` (serve the full-width configs; the reference serves
    the reduced ones; every family: ``--archs whisper-tiny`` or
    ``llava-next-mistral-7b`` too).  ``--devices N`` serves a fleet of N
    replicas: replica r on card ``r % torch.cuda.device_count()`` of
    ``--device``'s type (or on the CPU under ``--device cpu``), each
    placement printed as ``[fleet] rN on cuda:K``; the reference splits
    the host into N XLA devices instead.  Returns the run's result (the
    fleet's merged result with ``--devices``).

        python -m repro_torch.launch.serve --full-width
        python -m repro_torch.launch.serve --full-width \
            --archs whisper-tiny llava-next-mistral-7b
        python -m repro_torch.launch.serve --full-width --devices 2
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
                    help="fleet mode: N replicas, replica r on card "
                         "r %% device_count (every replica on the CPU "
                         "under --device cpu)")
    ap.add_argument("--oracle-sched", action="store_true",
                    help="force the per-tenant Algorithm 1 oracle "
                         "(disable the batched epoch planner)")
    ap.add_argument("--lookahead", action="store_true",
                    help="predictive grant lookahead against next-epoch "
                         "pool pressure (changes grants)")
    ap.add_argument("--aot", action="store_true",
                    help="capture the predicted decode programs before "
                         "the first epoch")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on")
    ap.add_argument("--full-width", action="store_true",
                    help="serve the full-width configs (default: reduced)")
    args = ap.parse_args(argv)
    arrivals = None
    if args.arrivals > 0:
        arrivals = PoissonArrivals(
            rate_per_s=args.arrival_rate, models=args.archs,
            n_arrivals=args.arrivals, n_inferences=args.decode_budget,
            prompt_len=args.prompt_len)
    if args.devices > 0:
        kind = torch.device(args.device).type
        cards = max(1, torch.cuda.device_count())
        devices = [torch.device(kind, r % cards) if kind == "cuda"
                   else torch.device(kind) for r in range(args.devices)]
        fleet = FleetServer(n_replicas=args.devices, devices=devices,
                            arch_ids=args.archs,
                            pages_per_replica=args.pages,
                            epoch_len=args.epoch_len, max_len=args.max_len,
                            arrivals=arrivals, kv_dtype=args.kv_dtype,
                            reduced=not args.full_width)
        for r, srv in enumerate(fleet.replicas):
            print(f"[fleet] r{r} on {srv.device}")
        out = fleet.run(args.steps)
        for rep in out["replicas"]:
            print(f"[fleet] {rep['replica']}: {rep['tokens_served']} tokens, "
                  f"page util {rep['page_util_mean'] * 100:.0f}%, "
                  f"tenants {rep['tenants']}")
        p95 = (f", p95 TTFT {out['p95_ttft_s'] * 1e3:.0f}ms"
               if out["p95_ttft_s"] is not None else "")
        print(f"[fleet] {out['n_replicas']} replicas (tp={out['tp']}): "
              f"{out['tokens_per_s']:.1f} tok/s observed, util balance "
              f"{out['page_util_balance']:.2f}{p95}")
        return out
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
              f"dispatch {host['dispatch_wall_s'] * 1e3:.1f}ms "
              f"({host['sched_frac'] * 100:.1f}%), "
              f"{host['batched_runs']} batched / {host['oracle_runs']} "
              f"oracle runs, compiles/epoch {host['epoch_compiles']}, "
              f"aot {host['aot_compiled']} compiled "
              f"({host['aot_hits']} hits)")
    return out


if __name__ == "__main__":
    main()
