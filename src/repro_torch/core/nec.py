# Verbatim copy of src/repro/core/nec.py (the JAX package's framework-free
# scheduling code); only the package name in imports differs.
"""NEC: the NPU-exclusive controller access semantics (paper III-B(2)).

The NEC replaces hardware-managed replacement inside the NPU subspace
with explicit, line-granular semantics issued by NPU programs:

  basic     fill        (memory  -> cache line)
            writeback   (cache   -> memory line)
            read        (cache   -> NPU)
            write       (NPU     -> cache)
  advanced  bypass_read          (memory -> NPU, no cache residency)
            bypass_write         (NPU -> memory, no cache residency)
            multicast_read       (cache -> group of NPUs, one cache access)
            multicast_bypass_read(memory -> group of NPUs, one DRAM access)

This module is the single point of *traffic accounting* for the whole
repo: the simulator charges DRAM / NoC / cache-port bytes exclusively
through a :class:`Nec` instance, so the CaMDN vs baseline comparisons in
benchmarks/ all flow through the same bookkeeping.

Residency is a per-tenant numpy *line bitmap* over the tenant's virtual
cache space, so every semantic is O(#windows) slice/popcount arithmetic
instead of one Python iteration per 64-byte line; ``repeat`` counts are
folded in arithmetically.  Counters are bit-identical to the per-line
reference implementation retained in ``tests/reference_nec.py``
(differential-tested in ``tests/test_nec_diff.py``), with one deliberate
semantic tightening: a CPT fault now raises *before* any counter or
residency mutation (atomic), where the per-line loop charged lines
preceding the faulting one.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.core.cache import SharedCache
from repro_torch.core.cpt import CachePageTable, CptFault


@dataclasses.dataclass(slots=True)
class Traffic:
    """Byte counters; all monotonically increasing."""
    dram_read: int = 0
    dram_write: int = 0
    cache_read: int = 0     # cache data-array read bytes
    cache_write: int = 0
    noc: int = 0            # cache/memory <-> NPU interconnect bytes
    hits: int = 0           # line-granular NPU requests served from cache
    accesses: int = 0       # line-granular NPU data requests

    @property
    def dram_total(self) -> int:
        return self.dram_read + self.dram_write

    @property
    def hit_rate(self) -> float:
        return self.hits / self.accesses if self.accesses else 0.0

    def merged(self, other: "Traffic") -> "Traffic":
        return Traffic(*[a + b for a, b in
                         zip(dataclasses.astuple(self), dataclasses.astuple(other))])


class NecError(Exception):
    pass


def layer_charge(read_bytes: int, write_bytes: int, access_bytes: int,
                 group_size: int, line_bytes: int) -> Tuple[int, int, int, int, int]:
    """Bulk layer-execution pricing shared by every policy — the single
    definition of how a layer's DRAM/NoC/hit counters derive from its
    byte volumes, so CaMDN variants and the transparent-LLC baseline
    stay apples-to-apples.  Returns the positional argument tuple for
    :meth:`TrafficLedger.charge_bulk`: (dram_read, dram_write, noc,
    hits, accesses)."""
    return (read_bytes, write_bytes,
            access_bytes * max(1, group_size),
            max(0, access_bytes - read_bytes - write_bytes) // line_bytes,
            max(1, access_bytes // line_bytes))


def project_traffic(charges: Iterable[Tuple[int, int, int, int, int]]
                    ) -> Traffic:
    """What-if accumulation of :func:`layer_charge` tuples into a fresh
    :class:`Traffic` snapshot WITHOUT touching any ledger — the NEC's
    pricing math used as an online simulator.  The predictive grant
    lookahead prices alternative one-epoch-ahead assignments through this
    and compares ``dram_total`` before committing real grants."""
    out = Traffic()
    for dram_read, dram_write, noc, hits, accesses in charges:
        out.dram_read += dram_read
        out.dram_write += dram_write
        out.noc += noc
        out.hits += hits
        out.accesses += accesses
    return out


class TrafficLedger:
    """Single point of traffic accounting: a per-tenant breakdown,
    mutated only through :meth:`charge` / :meth:`charge_bulk`, plus a
    global :attr:`total` view.  Counters are monotone by construction —
    negative deltas raise — so every consumer (NEC semantics, the
    unified runtime, the transparent-LLC pricing path) shares one set of
    invariants and the CaMDN/baseline comparisons stay apples-to-apples.

    ``total`` is materialized on read (live tenants merged over the
    retired-tenant accumulator): charging — the per-layer hot path —
    touches exactly one Traffic record.
    """

    def __init__(self):
        self.per_tenant: Dict[str, Traffic] = {}
        self._retired = Traffic()   # history of dropped tenants

    @property
    def total(self) -> Traffic:
        # always a fresh snapshot — never alias the internal accumulator
        out = Traffic(*dataclasses.astuple(self._retired))
        for t in self.per_tenant.values():
            out = out.merged(t)
        return out

    def tenant(self, tenant: str) -> Traffic:
        t = self.per_tenant.get(tenant)
        if t is None:
            t = self.per_tenant[tenant] = Traffic()
        return t

    def charge(self, tenant: str, *, dram_read: int = 0, dram_write: int = 0,
               cache_read: int = 0, cache_write: int = 0, noc: int = 0,
               hits: int = 0, accesses: int = 0) -> None:
        if (dram_read < 0 or dram_write < 0 or cache_read < 0
                or cache_write < 0 or noc < 0 or hits < 0 or accesses < 0):
            raise NecError(
                f"negative traffic delta for {tenant}: "
                f"{(dram_read, dram_write, cache_read, cache_write, noc, hits, accesses)}")
        t = self.tenant(tenant)
        t.dram_read += dram_read
        t.dram_write += dram_write
        t.cache_read += cache_read
        t.cache_write += cache_write
        t.noc += noc
        t.hits += hits
        t.accesses += accesses

    def charge_bulk(self, tenant: str, dram_read: int, dram_write: int,
                    noc: int, hits: int, accesses: int) -> None:
        """Positional fast path for the layer-pricing hot loop (no cache
        data-array bytes; same monotonicity invariant as :meth:`charge`)."""
        if dram_read < 0 or dram_write < 0 or noc < 0 or hits < 0 or accesses < 0:
            raise NecError(
                f"negative traffic delta for {tenant}: "
                f"{(dram_read, dram_write, noc, hits, accesses)}")
        t = self.per_tenant.get(tenant)
        if t is None:
            t = self.per_tenant[tenant] = Traffic()
        t.dram_read += dram_read
        t.dram_write += dram_write
        t.noc += noc
        t.hits += hits
        t.accesses += accesses

    def drop_tenant(self, tenant: str) -> Traffic:
        """Retire a tenant's breakdown entry (:attr:`total` keeps its
        history); returns the retired counters so a departing tenant's
        stats can be folded into its final result."""
        t = self.per_tenant.pop(tenant, None)
        if t is None:
            return Traffic()
        self._retired = self._retired.merged(t)
        return t


class Nec:
    """Line-granular NPU-controlled access over a tenant's CPT window.

    Residency is tracked per tenant as a boolean line bitmap over the
    virtual cache space: under NPU-controlled semantics a line holds
    valid data iff the program filled or wrote it, and the CPT mapping
    pins it — there is no transparent eviction, so *within the NPU
    subspace tenants can never evict each other* (the property the
    paper's architecture buys).

    Bitmaps are drawn from a small arena (free list) so back-to-back
    candidate executions — e.g. :func:`repro.core.codegen.run_candidate`
    sweeping every GEMM of a layer — reuse one allocation instead of
    churning a fresh ~200K-entry array per tenant lifetime.
    """

    def __init__(self, cache: SharedCache, ledger: Optional[TrafficLedger] = None):
        self.cache = cache
        self.config = cache.config
        self.ledger = ledger if ledger is not None else TrafficLedger()
        # virtual cache space covers every CPT entry: num_pages pages
        self._nlines = self.config.num_pages * self.config.lines_per_page
        self._resident: Dict[str, np.ndarray] = {}   # tenant -> line bitmap
        self._arena: List[np.ndarray] = []           # recycled bitmaps
        # way-partition check constants (pcaddr bit layout, Fig. 5b):
        # the way index is the top field, so one shift per *page* suffices
        # (pages never straddle ways: way_bytes is a page multiple)
        c = self.config
        self._way_shift = ((c.line_bytes.bit_length() - 1)
                           + (c.num_slices - 1).bit_length()
                           + (c.num_sets - 1).bit_length())
        self._cpu_ways = c.num_ways - c.npu_ways

    # -- ledger views ---------------------------------------------------
    @property
    def traffic(self) -> Traffic:
        return self.ledger.total

    @property
    def per_tenant(self) -> Dict[str, Traffic]:
        return self.ledger.per_tenant

    def _line(self, vcaddr: int) -> int:
        return vcaddr & ~(self.config.line_bytes - 1)

    # -- residency bitmap management ------------------------------------
    def _res(self, tenant: str) -> np.ndarray:
        bm = self._resident.get(tenant)
        if bm is None:
            if self._arena:
                bm = self._arena.pop()
                bm[:] = False
            else:
                bm = np.zeros(self._nlines, dtype=bool)
            self._resident[tenant] = bm
        return bm

    def resident_lines(self, tenant: str) -> int:
        bm = self._resident.get(tenant)
        return int(np.count_nonzero(bm)) if bm is not None else 0

    def invalidate_tenant(self, tenant: str) -> None:
        """Drop all residency for a tenant (pages reclaimed); the bitmap
        returns to the arena for the next tenant lifetime."""
        bm = self._resident.pop(tenant, None)
        if bm is not None and len(self._arena) < 8:
            self._arena.append(bm)

    def invalidate_range(self, tenant: str, vcaddr: int, nbytes: int) -> None:
        bm = self._resident.get(tenant)
        if bm is None:
            return
        l0, l1 = self._window(vcaddr, nbytes)
        if l0 < 0:
            l0 = 0   # no residency below address 0 (negative slice
        if l1 < 0:  # indices would wrap to the bitmap's tail)
            l1 = 0
        bm[l0:l1] = False

    # -- window validation ----------------------------------------------
    def _window(self, vcaddr: int, nbytes: int):
        """(first_line_idx, one_past_last_line_idx) covering the byte
        window — the same line set ``range(line(vcaddr), vcaddr+nbytes,
        line_bytes)`` iterates.  NOTE: matching that range, a zero-byte
        window at an unaligned vcaddr still covers the line containing
        vcaddr (l1 > l0); a negative nbytes yields l1 <= l0 (empty)."""
        lb = self.config.line_bytes
        return self._line(vcaddr) // lb, (vcaddr + nbytes + lb - 1) // lb

    def _checked_window(self, cpt: CachePageTable, vcaddr: int, nbytes: int):
        """The op's line window, validated: CPT mappings and the way
        partition are checked for every covered line in one vectorized
        pass (raising CptFault / NecError before any state mutation);
        an empty window skips validation, exactly like the per-line
        loop it replaces."""
        l0, l1 = self._window(vcaddr, nbytes)
        if l1 <= l0:
            return l0, l0
        lb = self.config.line_bytes
        pcpns = cpt.translate_range(l0 * lb, (l1 - l0) * lb)
        pb = self.config.page_bytes
        base = pcpns * pb
        ways = (base >> self._way_shift) + self._cpu_ways
        last = ((base + pb - lb) >> self._way_shift) + self._cpu_ways
        if int(max(ways.max(), last.max())) >= self.config.num_ways:
            bad = int(base[int(np.argmax(np.maximum(ways, last)))])
            raise NecError(f"pcaddr {bad:#x} escapes the NPU way partition")
        return l0, l1

    # -- basic semantics -------------------------------------------------
    def fill(self, tenant: str, cpt: CachePageTable, vcaddr: int, nbytes: int,
             repeat: int = 1) -> None:
        """memory -> cache (explicit prefetch/placement).  Fill is
        idempotent on resident lines, so ``repeat`` > 1 charges exactly
        what ``repeat`` sequential fills would: the first pass moves the
        missing lines, the rest are no-ops."""
        if repeat < 1:
            raise NecError(f"repeat must be >= 1, got {repeat}")
        l0, l1 = self._checked_window(cpt, vcaddr, nbytes)
        if l1 == l0:
            return
        lb = self.config.line_bytes
        bm = self._res(tenant)
        n_new = (l1 - l0) - int(np.count_nonzero(bm[l0:l1]))
        if n_new:
            bm[l0:l1] = True
            self.ledger.charge(tenant, dram_read=lb * n_new,
                               cache_write=lb * n_new)

    def writeback(self, tenant: str, cpt: CachePageTable, vcaddr: int,
                  nbytes: int, repeat: int = 1) -> None:
        """cache -> memory.  Residency is unchanged, so ``repeat``
        multiplies the charge (each pass writes the resident lines)."""
        if repeat < 1:
            raise NecError(f"repeat must be >= 1, got {repeat}")
        l0, l1 = self._checked_window(cpt, vcaddr, nbytes)
        if l1 == l0:
            return
        lb = self.config.line_bytes
        bm = self._res(tenant)
        n_res = int(np.count_nonzero(bm[l0:l1]))
        if n_res:
            self.ledger.charge(tenant, cache_read=lb * n_res * repeat,
                               dram_write=lb * n_res * repeat)

    def read(self, tenant: str, cpt: CachePageTable, vcaddr: int, nbytes: int,
             fill_on_miss: bool = True, repeat: int = 1) -> int:
        """cache -> NPU.  Returns bytes that missed (and were filled).

        ``repeat`` charges the read as if issued ``repeat`` times
        back-to-back in ONE pass over the bitmap (the codegen
        aggregation path): a resident line hits every time; a missing
        line misses once, is filled, then hits ``repeat - 1`` times.
        Counters are exactly those of ``repeat`` sequential calls."""
        if repeat < 1:
            raise NecError(f"repeat must be >= 1, got {repeat}")
        l0, l1 = self._checked_window(cpt, vcaddr, nbytes)
        if l1 == l0:
            return 0
        lb = self.config.line_bytes
        bm = self._res(tenant)
        n = l1 - l0
        n_hit = int(np.count_nonzero(bm[l0:l1]))
        n_miss = n - n_hit
        if fill_on_miss:
            if n_miss:
                bm[l0:l1] = True
            self.ledger.charge(
                tenant,
                accesses=n * repeat,
                hits=n_hit * repeat + n_miss * (repeat - 1),
                cache_read=lb * n * repeat,
                noc=lb * n * repeat,
                dram_read=lb * n_miss,
                cache_write=lb * n_miss)
            return n_miss * lb
        self.ledger.charge(
            tenant,
            accesses=n * repeat,
            hits=n_hit * repeat,
            cache_read=lb * n_hit * repeat,
            noc=lb * n * repeat,
            dram_read=lb * n_miss * repeat)
        return n_miss * lb * repeat

    def write(self, tenant: str, cpt: CachePageTable, vcaddr: int, nbytes: int,
              repeat: int = 1) -> None:
        """NPU -> cache (no DRAM traffic until writeback).  NPU-
        controlled writes never miss; ``repeat`` multiplies the charge."""
        if repeat < 1:
            raise NecError(f"repeat must be >= 1, got {repeat}")
        l0, l1 = self._checked_window(cpt, vcaddr, nbytes)
        if l1 == l0:
            return
        lb = self.config.line_bytes
        bm = self._res(tenant)
        n = l1 - l0
        bm[l0:l1] = True
        self.ledger.charge(tenant, accesses=n * repeat, hits=n * repeat,
                           noc=lb * n * repeat, cache_write=lb * n * repeat)

    # -- advanced semantics ------------------------------------------------
    def bypass_read(self, tenant: str, nbytes: int, repeat: int = 1) -> None:
        """memory -> NPU directly; zero cache footprint (non-reusable
        data).  ``repeat`` aggregates that many identical transfers into
        one accounting call (exactly ``repeat`` sequential bypasses)."""
        if repeat < 1:
            raise NecError(f"repeat must be >= 1, got {repeat}")
        lines = (nbytes + self.config.line_bytes - 1) // self.config.line_bytes
        self.ledger.charge(tenant, accesses=lines * repeat,
                           dram_read=nbytes * repeat, noc=nbytes * repeat)

    def bypass_write(self, tenant: str, nbytes: int, repeat: int = 1) -> None:
        """NPU -> memory directly."""
        if repeat < 1:
            raise NecError(f"repeat must be >= 1, got {repeat}")
        self.ledger.charge(tenant, dram_write=nbytes * repeat,
                           noc=nbytes * repeat)

    def multicast_read(self, tenant: str, cpt: CachePageTable, vcaddr: int,
                       nbytes: int, group_size: int) -> int:
        """cache -> a group of NPUs running the same model: ONE cache
        data-array access, ``group_size`` NoC deliveries."""
        if group_size < 1:
            raise NecError("multicast group must be >= 1")
        l0, l1 = self._checked_window(cpt, vcaddr, nbytes)
        if l1 == l0:
            return 0
        lb = self.config.line_bytes
        bm = self._res(tenant)
        n = l1 - l0
        n_hit = int(np.count_nonzero(bm[l0:l1]))
        n_miss = n - n_hit
        if n_miss:
            bm[l0:l1] = True
        self.ledger.charge(tenant, accesses=n, hits=n_hit,
                           cache_read=lb * n, cache_write=lb * n_miss,
                           dram_read=lb * n_miss,
                           noc=lb * n * group_size)
        return n_miss * lb

    def multicast_bypass_read(self, tenant: str, nbytes: int, group_size: int) -> None:
        """memory -> a group of NPUs: ONE DRAM access total (vs
        ``group_size`` under private fetching)."""
        if group_size < 1:
            raise NecError("multicast group must be >= 1")
        self.ledger.charge(tenant, dram_read=nbytes, noc=nbytes * group_size)

    # -- bulk layer-level accounting ------------------------------------
    def charge_layer_execution(self, tenant: str, read_bytes: int,
                               write_bytes: int, access_bytes: int,
                               group_size: int = 1) -> None:
        """Charge one layer's execution in bulk (line-level semantics are
        exercised by codegen validation; the runtime and the simulator
        charge at layer granularity).  ``access_bytes`` is the logical
        NPU->cache request volume; hits are whatever part of it did not
        have to touch DRAM.  With ``group_size`` > 1 one fetch serves the
        whole NPU group (multicast), costing extra NoC deliveries only.
        """
        self.ledger.charge_bulk(tenant, *layer_charge(
            read_bytes, write_bytes, access_bytes, group_size,
            self.config.line_bytes))
