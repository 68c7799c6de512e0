# Verbatim copy of src/repro/core/codegen.py (lines 1-163: the NEC command
# stream a mapping candidate unrolls into; NecOp :29, generate_gemm_program
# :46, execute :106, run_candidate :131); only the package name in its
# imports differs. It imports no framework.
"""NPU program generation: unroll a mapping candidate's compact loop
table into an executable NEC command stream (paper III-C3: MCTs store
candidates "in a compact format instead of unrolled NPU instructions" —
this module is the unroller that runs at dispatch time).

The generated program is a sequence of NEC operations (fill / read /
write / writeback / bypass_read / bypass_write) at cache-line
granularity, executed against :class:`repro.core.nec.Nec`.  Because the
NEC does line-accurate traffic accounting, executing the program
*validates the mapper's analytic DRAM model*: tests assert the executed
byte counts match ``candidate.dram_bytes`` (tests/test_codegen.py).

Virtual-cache layout per the candidate's cache map: resident panels at
their assigned vcpn windows; streamed operands bypass.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Tuple

from repro_torch.core.cache import SharedCache
from repro_torch.core.cpt import CachePageTable
from repro_torch.core.mct import LoopTable, MappingCandidate, Residency
from repro_torch.core.nec import Nec
from repro_torch.core.types import GemmDims, LayerSpec, ceil_div


@dataclasses.dataclass(frozen=True)
class NecOp:
    op: str          # fill | read | write | writeback | bypass_read | bypass_write
    nbytes: int
    vcaddr: int = 0  # for cached ops (line-aligned window start)
    repeat: int = 1  # aggregated op: issued this many times back-to-back


def _tiles(total: int, tile: int) -> List[Tuple[int, int]]:
    """[(offset, size)] covering [0, total) in tile-sized steps."""
    out = []
    o = 0
    while o < total:
        out.append((o, min(tile, total - o)))
        o += tile
    return out


def generate_gemm_program(g: GemmDims, loop: LoopTable, eb: int,
                          panel_vcaddr: int = 0) -> Iterator[NecOp]:
    """Command stream for one GEMM under one loop table, aggregated at
    (rep, m-tile) granularity: the inner n-loop is folded into ``repeat``
    counts on each op, so the program length is O(reps * M/Tm) instead of
    O(reps * M/Tm * N/Tn) while the NEC's line-accurate counters stay
    bit-identical to the fully unrolled stream (large-N layers no longer
    pay one Python call per tile).

    Traffic contract (mirrors the mapper's model, core/mapping.py):
      STREAM  : A tiles bypass per (m,n), B tiles bypass per (m,n), C out
      A_PANEL : A row-panel filled per m-tile (cache-resident), B bypass
      B_PANEL : B filled once (resident across reps), A bypass
      BOTH    : B resident + A panel resident
    """
    r = g.reps
    res = loop.residency
    a_panel_base = panel_vcaddr + (g.b_bytes_one * eb
                                   if res == Residency.BOTH else 0)
    n_tiles = _tiles(g.N, loop.tn)
    n_cnt = len(n_tiles)
    n_full = sum(1 for _, ns in n_tiles if ns == loop.tn)
    n_rem = n_tiles[-1][1] if n_full < n_cnt else 0
    for rep in range(r):
        if res in (Residency.B_PANEL, Residency.BOTH):
            if rep == 0 or not g.b_reused:
                # B enters the cache once (per rep if not reused)
                yield NecOp("fill", g.b_bytes_one * eb, panel_vcaddr)
        for (mo, ms) in _tiles(g.M, loop.tm):
            a_panel_bytes = ms * g.K * eb
            if res in (Residency.A_PANEL, Residency.BOTH):
                # A row-panel becomes cache-resident for this m-tile,
                # then hits once per n-tile
                yield NecOp("fill", a_panel_bytes, a_panel_base)
                yield NecOp("read", a_panel_bytes, a_panel_base,
                            repeat=n_cnt)
            elif res == Residency.B_PANEL:
                # with B resident, A streams exactly once (scratchpad
                # holds the [tm, K] slab across the n loop)
                yield NecOp("bypass_read", a_panel_bytes)
            else:  # STREAM: A tile reloaded from DRAM for every n-tile
                yield NecOp("bypass_read", a_panel_bytes, repeat=n_cnt)
            # B operand: one full-size op per n-tile + the remainder tile
            if res in (Residency.B_PANEL, Residency.BOTH):
                if n_full:
                    yield NecOp("read", g.K * loop.tn * eb, panel_vcaddr,
                                repeat=n_full)  # hits
                if n_rem:
                    yield NecOp("read", g.K * n_rem * eb, panel_vcaddr)
            else:
                if n_full:
                    yield NecOp("bypass_read", g.K * loop.tn * eb,
                                repeat=n_full)
                if n_rem:
                    yield NecOp("bypass_read", g.K * n_rem * eb)
            # C tiles out (bypass-write: LWM outputs go to DRAM); the
            # whole n-row sums exactly to ms * N bytes
            yield NecOp("bypass_write", ms * g.N * eb)


def execute(ops: Iterator[NecOp], nec: Nec, cpt: CachePageTable,
            tenant: str) -> None:
    """Run a command stream against the NEC (line-accurate accounting).
    Every op — including its ``repeat`` count — is dispatched as ONE
    whole-window NEC call: the NEC folds repeats in arithmetically
    (fill is idempotent on resident lines; read/write/writeback carry a
    ``repeat`` argument), so counters are identical to issuing the op
    that many times while the Python-level cost stays O(#ops)."""
    for o in ops:
        if o.op == "fill":
            nec.fill(tenant, cpt, o.vcaddr, o.nbytes, repeat=o.repeat)
        elif o.op == "read":
            nec.read(tenant, cpt, o.vcaddr, o.nbytes, repeat=o.repeat)
        elif o.op == "write":
            nec.write(tenant, cpt, o.vcaddr, o.nbytes, repeat=o.repeat)
        elif o.op == "writeback":
            nec.writeback(tenant, cpt, o.vcaddr, o.nbytes, repeat=o.repeat)
        elif o.op == "bypass_read":
            nec.bypass_read(tenant, o.nbytes, repeat=o.repeat)
        elif o.op == "bypass_write":
            nec.bypass_write(tenant, o.nbytes, repeat=o.repeat)
        else:
            raise ValueError(o.op)


def run_candidate(layer: LayerSpec, cand: MappingCandidate,
                  cache: SharedCache, nec: Nec, tenant: str) -> int:
    """Allocate the candidate's pages, install the CPT, execute the
    unrolled program for every GEMM, release.  Returns DRAM bytes moved
    (from the NEC's line-accurate counters).  The tenant's residency
    bitmap comes from the NEC's arena, so sweeping many candidates
    through one :class:`Nec` reuses a single allocation across GEMMs."""
    before = nec.per_tenant.get(tenant)
    before_total = before.dram_total if before else 0
    pages = cache.alloc(tenant, cand.p_need)
    if pages is None:
        raise RuntimeError("insufficient pages for candidate")
    cpt = CachePageTable(cache.config)
    cpt.map_pages(pages)
    try:
        vbase = 0
        for g, loop in zip(layer.gemms, cand.loops):
            execute(generate_gemm_program(g, loop, layer.elem_bytes,
                                          panel_vcaddr=vbase),
                    nec, cpt, tenant)
            # next GEMM's panels start after this one's resident bytes
            resident = 0
            if loop.residency in (Residency.B_PANEL, Residency.BOTH):
                resident += g.b_bytes_one * layer.elem_bytes
            if loop.residency in (Residency.A_PANEL, Residency.BOTH):
                resident += loop.tm * g.K * layer.elem_bytes
            vbase += ceil_div(resident, cache.config.page_bytes) * \
                cache.config.page_bytes
    finally:
        cache.free(tenant, pages)
        nec.invalidate_tenant(tenant)
    after = nec.per_tenant[tenant].dram_total
    return after - before_total
