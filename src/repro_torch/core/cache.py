# Verbatim copy of src/repro/core/cache.py (the JAX package's framework-free
# scheduling code); only the package name in imports differs.
"""Shared-cache model with way partitioning and an NPU page pool.

Implements the architecture of paper Section III-B(1,3):

- The LLC is physically organized as ``num_slices`` slices x ``num_ways``
  ways x ``num_sets`` sets of ``line_bytes`` lines.
- A way-mask register per slice splits it into a general-purpose (CPU)
  subspace and an NPU subspace (ways >= ``cpu_ways`` belong to the NPU).
- The NPU subspace is divided into fixed-size *pages* (32 KB for a 16 MB
  cache in the paper) which are the allocation currency handed to
  tenants.  A page is a contiguous range of physical cache space in
  ``pcaddr`` terms; the pcaddr bit layout (byte offset | slice | set |
  way, low to high) stripes consecutive lines across slices so that a
  page draws bandwidth from every slice (Fig. 5b).

Page ownership is *refcounted*: :meth:`SharedCache.alloc` hands out
exclusive pages, :meth:`SharedCache.share` adds co-holders (copy-on-
write sharing — shared pages are read-only by convention; divergent
writes allocate private pages through the normal grant path), and
:meth:`SharedCache.free` decrements — a page returns to the pool only
when its LAST holder releases it.  On top of that,
:class:`PrefixIndex` keys shared KV-prefix page runs by
(arch, params, token-prefix hash) at prefill-chunk granularity, so
co-tenants arriving with a common prompt prefix attach to pages some
earlier tenant already filled instead of prefilling from scratch
(the serving layer in launch/serve.py drives it).
"""
from __future__ import annotations

import dataclasses
import hashlib
import heapq
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from repro_torch.core.types import ceil_div


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    total_bytes: int = 16 * 2**20
    num_slices: int = 8
    num_ways: int = 16
    npu_ways: int = 12            # ways assigned to the NPU subspace
    line_bytes: int = 64
    page_bytes: int = 32 * 2**10  # CaMDN page size

    def __post_init__(self):
        if self.npu_ways > self.num_ways:
            raise ValueError("npu_ways cannot exceed num_ways")
        if self.total_bytes % (self.num_slices * self.num_ways * self.line_bytes):
            raise ValueError("total_bytes must evenly split into slices*ways*lines")

    @property
    def slice_bytes(self) -> int:
        return self.total_bytes // self.num_slices

    @property
    def way_bytes(self) -> int:
        """Bytes of one way across all slices."""
        return self.total_bytes // self.num_ways

    @property
    def num_sets(self) -> int:
        return self.slice_bytes // (self.num_ways * self.line_bytes)

    @property
    def npu_bytes(self) -> int:
        return self.way_bytes * self.npu_ways

    @property
    def cpu_bytes(self) -> int:
        return self.way_bytes * (self.num_ways - self.npu_ways)

    @property
    def num_pages(self) -> int:
        return self.npu_bytes // self.page_bytes

    @property
    def lines_per_page(self) -> int:
        return self.page_bytes // self.line_bytes


@dataclasses.dataclass
class PcAddr:
    """Decomposed physical cache address (Fig. 5b bit fields)."""
    byte_offset: int
    slice_index: int
    set_index: int
    way_index: int


class SharedCache:
    """Page-granular state of the NPU subspace of the shared cache.

    Tracks (refcounted) page ownership per tenant and exposes the way
    mask; line-level data movement/traffic accounting lives in
    :mod:`repro.core.nec`.

    The free pool is a min-heap, so grants (and re-grants after churn)
    always prefer contiguous low pcpns — freed pages do not interleave
    tenants' holdings over time, keeping the pcaddr striping story (and
    re-grant page identity) deterministic.
    """

    def __init__(self, config: CacheConfig):
        self.config = config
        self._free: List[int] = list(range(config.num_pages))  # min-heap
        self._holders: Dict[int, Set[str]] = {}   # pcpn -> holder ids
        self._pages_of: Dict[str, Set[int]] = {}  # tenant id -> pcpns
        # per-page dequantization scale (precision-for-residency): the
        # max |amax|/qmax over the KV token rows a quantized page holds,
        # recorded alongside the page table and dropped when the page
        # returns to the pool.  Pages of native-precision tenants have
        # no entry.
        self._page_scale: Dict[int, float] = {}
        # called with the page shortfall when alloc would fail; may free
        # pages (e.g. PrefixIndex LRU eviction) and the alloc retries
        self.pressure_hook: Optional[Callable[[int], int]] = None
        # way-mask per slice: bit i set => way i belongs to the NPU subspace
        cpu_ways = config.num_ways - config.npu_ways
        self.way_mask: List[int] = [
            ((1 << config.num_ways) - 1) & ~((1 << cpu_ways) - 1)
            for _ in range(config.num_slices)
        ]

    # ---- page pool -------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_of(self, tenant: str) -> Set[int]:
        return set(self._pages_of.get(tenant, set()))

    def allocated_pages(self, tenant: str) -> int:
        return len(self._pages_of.get(tenant, ()))

    def alloc(self, tenant: str, n_pages: int) -> Optional[List[int]]:
        """Allocate ``n_pages`` exclusively to ``tenant`` (refcount 1);
        returns pcpns (lowest free pcpns first) or None if the pool
        cannot satisfy the request (caller decides to wait).  When the
        pool falls short the ``pressure_hook`` (if any) gets one chance
        to reclaim unreferenced pages before the request fails."""
        if n_pages < 0:
            raise ValueError("negative page count")
        if n_pages > len(self._free) and self.pressure_hook is not None:
            self.pressure_hook(n_pages - len(self._free))
        if n_pages > len(self._free):
            return None
        if n_pages == 0:
            return []
        got = [heapq.heappop(self._free) for _ in range(n_pages)]
        for p in got:
            self._holders[p] = {tenant}
        self._pages_of.setdefault(tenant, set()).update(got)
        return got

    def share(self, pages: List[int], tenant: str) -> List[int]:
        """Add ``tenant`` as a co-holder of already-allocated ``pages``
        (copy-on-write sharing: refcount++ per page).  The pages stay
        out of the pool until EVERY holder — original and shared — has
        freed them.  Validates the whole request before mutating, and
        is idempotent per (page, tenant).  Returns the shared pcpns."""
        to_share = list(dict.fromkeys(pages))
        bad = [p for p in to_share if p not in self._holders]
        if bad:
            raise KeyError(f"cannot share unallocated pages {sorted(bad)}")
        held = self._pages_of.setdefault(tenant, set())
        for p in to_share:
            self._holders[p].add(tenant)
            held.add(p)
        return to_share

    def free(self, tenant: str, pages: Optional[List[int]] = None) -> int:
        """Release ``tenant``'s hold on ``pages`` (or all its pages).
        A page returns to the pool only when its refcount drops to zero
        — co-holders of a shared page keep it resident.  Validates the
        whole (deduplicated) request before mutating any state, so a
        bad page id (including a double-free) leaves the pool
        untouched.  Returns the number of holds released."""
        owned = self._pages_of.get(tenant, set())
        if pages is None:
            to_free = list(owned)
        else:
            to_free = list(dict.fromkeys(pages))   # dedup, order kept
            bad = [p for p in to_free if p not in owned]
            if bad:
                raise KeyError(f"tenant {tenant} does not own pages {sorted(bad)}")
        for p in to_free:
            owned.discard(p)
            holders = self._holders[p]
            holders.discard(tenant)
            if not holders:
                del self._holders[p]
                self._page_scale.pop(p, None)
                heapq.heappush(self._free, p)
        if not owned:
            self._pages_of.pop(tenant, None)
        return len(to_free)

    # ---- per-page quantization scales -------------------------------
    def set_page_scale(self, pcpn: int, scale: float) -> None:
        """Record the dequantization scale of an allocated quantized
        page (max per-row scale over the token rows it holds)."""
        if pcpn not in self._holders:
            raise KeyError(f"page {pcpn} is not allocated")
        self._page_scale[pcpn] = float(scale)

    def page_scale(self, pcpn: int) -> Optional[float]:
        """Scale recorded for a page, or None (free / native page)."""
        return self._page_scale.get(pcpn)

    def page_scales_of(self, tenant: str) -> Dict[int, float]:
        return {p: self._page_scale[p]
                for p in self._pages_of.get(tenant, ())
                if p in self._page_scale}

    def refcount(self, pcpn: int) -> int:
        return len(self._holders.get(pcpn, ()))

    def holders_of(self, pcpn: int) -> Set[str]:
        return set(self._holders.get(pcpn, set()))

    def owner_of(self, pcpn: int) -> Optional[str]:
        """The EXCLUSIVE owner of a page: its sole holder, or None for
        free and shared (refcount > 1) pages — exclusively allocated
        pages keep the legacy single-owner semantics."""
        holders = self._holders.get(pcpn)
        if holders is not None and len(holders) == 1:
            return next(iter(holders))
        return None

    # ---- pcaddr decomposition (Fig. 5b) -----------------------------
    def decompose(self, pcaddr: int) -> PcAddr:
        c = self.config
        off_bits = c.line_bytes.bit_length() - 1
        slice_bits = (c.num_slices - 1).bit_length()
        set_bits = (c.num_sets - 1).bit_length()
        byte_offset = pcaddr & (c.line_bytes - 1)
        slice_index = (pcaddr >> off_bits) & (c.num_slices - 1)
        set_index = (pcaddr >> (off_bits + slice_bits)) & (c.num_sets - 1)
        way_index = pcaddr >> (off_bits + slice_bits + set_bits)
        return PcAddr(byte_offset, slice_index, set_index, way_index)

    def page_base_pcaddr(self, pcpn: int) -> int:
        return pcpn * self.config.page_bytes

    def check_way_partition(self, pcaddr: int) -> bool:
        """True iff this NPU-subspace pcaddr maps into an NPU-owned way."""
        a = self.decompose(pcaddr)
        cpu_ways = self.config.num_ways - self.config.npu_ways
        # NPU pages are laid out from way ``cpu_ways`` upward
        return a.way_index + cpu_ways < self.config.num_ways

    # ---- introspection ----------------------------------------------
    def snapshot(self) -> Dict[str, int]:
        return {t: len(ps) for t, ps in self._pages_of.items()}


# ---------------------------------------------------------------------
# Prefix-hash KV dedup
# ---------------------------------------------------------------------

@dataclasses.dataclass
class PrefixEntry:
    """One shared KV prefix resident in the page pool.

    ``pages`` are the pcpns this entry holds *beyond its parent* (the
    delta between the parent's KV reservation and this one), all held
    by the entry's ``holder`` id via :meth:`SharedCache.share`.  The
    full page run for a prefix is the union over its parent chain.
    ``payload`` is opaque to the allocator — the serving layer stores
    the on-device KV snapshot (and, for a full-prompt entry, the first
    decode token) there.
    """
    key: str                  # hex digest, unique per (arch, params, tokens)
    arch: str
    params_key: str
    kv_len: int               # tokens covered by this prefix
    parent: Optional[str]     # key of the next-shorter registered prefix
    pages: List[int]          # delta pages vs parent, held by ``holder``
    payload: Any
    tenants: Set[str] = dataclasses.field(default_factory=set)
    children: int = 0         # registered entries whose parent is this one
    last_used: int = 0        # LRU clock value of the last hit/attach

    @property
    def holder(self) -> str:
        return "pfx#" + self.key[:16]

    @property
    def refcount(self) -> int:
        return len(self.tenants)


class PrefixIndex:
    """Maps (arch, params, token-prefix hash) -> resident shared KV pages.

    Entries are registered at prefill-chunk granularity by the tenant
    that first computes a prefix (the *producer*) and attached to by
    later arrivals (*consumers*): attach/detach walk the parent chain
    so refcounts cover every page the consumer reads.  An entry's pages
    are held in the :class:`SharedCache` under the entry's own holder
    id, so the producer departing does NOT return them to the pool —
    they live until the index evicts the entry.  Eviction is LRU over
    entries with no attached tenants and no registered children, and
    runs under pool pressure: the index registers itself as the cache's
    ``pressure_hook``, so an alloc that would fail first reclaims cold
    prefixes and then retries.
    """

    def __init__(self, cache: SharedCache):
        self.cache = cache
        self.entries: Dict[str, PrefixEntry] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._tick = 0
        cache.pressure_hook = self.reclaim

    # ---- keys -------------------------------------------------------
    @staticmethod
    def prefix_key(arch: str, params_key: str, token_bytes: bytes) -> str:
        """Stable digest of (architecture, parameter identity, prompt
        prefix).  ``token_bytes`` is the raw little-endian int32 byte
        string of the prefix tokens — callers serialize so this module
        stays free of array dependencies."""
        h = hashlib.blake2b(digest_size=16)
        h.update(f"{arch}|{params_key}|".encode())
        h.update(token_bytes)
        return h.hexdigest()

    # ---- registration (producer side) -------------------------------
    def register(self, arch: str, params_key: str, token_bytes: bytes,
                 kv_len: int, pages: List[int], payload: Any,
                 parent: Optional[str] = None) -> str:
        """Publish a computed prefix: the entry takes its own refcounted
        hold on ``pages`` (the delta beyond ``parent``), so they survive
        the producer's departure.  Idempotent per key — a re-register of
        a resident prefix only refreshes its LRU stamp."""
        key = self.prefix_key(arch, params_key, token_bytes)
        ent = self.entries.get(key)
        if ent is not None:
            self._tick += 1
            ent.last_used = self._tick
            return key
        if parent is not None and parent not in self.entries:
            raise KeyError(f"parent prefix {parent} is not registered")
        ent = PrefixEntry(key=key, arch=arch, params_key=params_key,
                          kv_len=kv_len, parent=parent, pages=list(pages),
                          payload=payload)
        self.cache.share(ent.pages, ent.holder)
        if parent is not None:
            self.entries[parent].children += 1
        self._tick += 1
        ent.last_used = self._tick
        self.entries[key] = ent
        return key

    # ---- lookup (consumer side) -------------------------------------
    def lookup(self, arch: str, params_key: str,
               candidates: List[Tuple[int, bytes]],
               probe: bool = False) -> Optional[PrefixEntry]:
        """Longest-match probe: ``candidates`` is (kv_len, token_bytes)
        pairs tried in order (callers list chunk-grid multiples longest
        first); returns the first resident entry, or None.  ``probe``
        skips the hit/miss counters and LRU refresh — the fleet router
        uses it to rank replicas without perturbing eviction order."""
        for kv_len, token_bytes in candidates:
            ent = self.entries.get(self.prefix_key(arch, params_key,
                                                   token_bytes))
            if ent is not None:
                if not probe:
                    self.hits += 1
                    self._tick += 1
                    for e in self.chain(ent):
                        e.last_used = self._tick
                return ent
        if not probe:
            self.misses += 1
        return None

    def match_len(self, arch: str, params_key: str,
                  candidates: List[Tuple[int, bytes]]) -> int:
        """Longest resident prefix length (0 on miss) — router probe."""
        ent = self.lookup(arch, params_key, candidates, probe=True)
        return ent.kv_len if ent is not None else 0

    def touch(self, key: str) -> None:
        """Refresh an entry's LRU stamp without a lookup."""
        ent = self.entries.get(key)
        if ent is not None:
            self._tick += 1
            ent.last_used = self._tick

    def chain(self, entry: PrefixEntry) -> List[PrefixEntry]:
        """``entry`` plus all its ancestors, deepest first."""
        out = [entry]
        while out[-1].parent is not None:
            out.append(self.entries[out[-1].parent])
        return out

    def chain_pages(self, entry: PrefixEntry) -> List[int]:
        """All pcpns backing ``entry``'s full prefix (chain union)."""
        pages: List[int] = []
        for e in self.chain(entry):
            pages.extend(e.pages)
        return pages

    # ---- refcounting -------------------------------------------------
    def attach(self, key: str, tenant: str) -> PrefixEntry:
        """Refcount++ on the entry AND every ancestor, so no page the
        consumer reads can be evicted while it is attached."""
        ent = self.entries[key]
        self._tick += 1
        for e in self.chain(ent):
            e.tenants.add(tenant)
            e.last_used = self._tick
        return ent

    def detach(self, key: str, tenant: str) -> None:
        """Release ``tenant``'s hold down the chain.  Entries stay
        resident (warm for the next arrival) until pool pressure or an
        explicit reclaim evicts them."""
        ent = self.entries.get(key)
        if ent is None:
            return          # evicted while attached? attach prevents it,
        for e in self.chain(ent):    # but departure must stay total
            e.tenants.discard(tenant)

    # ---- eviction ----------------------------------------------------
    def _evictable(self) -> List[PrefixEntry]:
        return [e for e in self.entries.values()
                if not e.tenants and e.children == 0]

    def reclaim(self, shortfall: int) -> int:
        """LRU-evict unreferenced, childless entries until at least
        ``shortfall`` pages went back to the pool (shared pages only
        return when their last holder releases, so an entry whose pages
        a tenant still co-holds frees nothing yet).  Registered as the
        cache's ``pressure_hook``.  Returns pages actually freed."""
        freed_before = self.cache.free_pages
        while self.cache.free_pages - freed_before < shortfall:
            victims = self._evictable()
            if not victims:
                break
            victim = min(victims, key=lambda e: e.last_used)
            self.evict(victim.key)
        return self.cache.free_pages - freed_before

    def evict(self, key: str) -> None:
        # validate BEFORE popping: a refused eviction must leave the
        # index intact (children still point at this key)
        ent = self.entries[key]
        if ent.tenants:
            raise RuntimeError(f"evicting prefix {key} with attached "
                               f"tenants {sorted(ent.tenants)}")
        if ent.children:
            raise RuntimeError(f"evicting prefix {key} with {ent.children} "
                               "registered children")
        del self.entries[key]
        if ent.parent is not None and ent.parent in self.entries:
            self.entries[ent.parent].children -= 1
        self.cache.free(ent.holder, None)
        ent.payload = None
        self.evictions += 1

    def clear(self) -> None:
        """Drop every unreferenced entry (leaf-first)."""
        while True:
            victims = self._evictable()
            if not victims:
                return
            for v in victims:
                self.evict(v.key)

    # ---- introspection ----------------------------------------------
    def stats(self) -> Dict[str, int]:
        return {
            "entries": len(self.entries),
            "pages_held": sum(len(e.pages) for e in self.entries.values()),
            "attached": sum(len(e.tenants) for e in self.entries.values()),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
        }
