# Verbatim copy of src/repro/core/vmem.py (the JAX package's framework-free
# scheduling code); only the package name in imports differs.
"""Bridge: CaMDN cache pages -> TPU VMEM tile configurations.

On the paper's SoC a mapping candidate's page budget bounds the shared-
cache working set.  On TPU the analogous budget is the *VMEM working
set* a Pallas kernel claims through its BlockSpecs.  This module turns a
page budget into concrete, hardware-aligned tile shapes for the kernels
in ``repro.kernels`` — the LWM candidates of the JAX serving path — and
decides when the LBM (fused-block) kernel variant is admissible.

TPU alignment rules honored here (v5e):
  * minor (lane) dimension tiles are multiples of 128,
  * second-minor (sublane) tiles are multiples of 8 (fp32) / 16 (bf16),
  * MXU-efficient matmul tiles are multiples of 128 on M/N/K.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.core.mct import MappingCandidate
from repro_torch.core.types import align_up, ceil_div

LANE = 128
PAGE_BYTES = 32 * 2**10
# v5e has ~128 MiB of VMEM per core usable by Pallas; XLA reserves a slice.
VMEM_BYTES = 96 * 2**20
VMEM_PAGES = VMEM_BYTES // PAGE_BYTES


def sublane(dtype_bytes: int) -> int:
    return {4: 8, 2: 16, 1: 32}.get(dtype_bytes, 8)


# Per-row quantization scale width: one fp32 scale per (token, kv-head)
# row of a quantized KV cache, stored alongside the page table entries.
KV_SCALE_BYTES = 4


def kv_row_bytes(kv_heads: int, head_dim: int, kv_eb: int,
                 scaled: bool = False) -> int:
    """Bytes one cached token row (K+V across the KV heads) occupies at
    element width ``kv_eb``; ``scaled`` adds the per-row fp32 dequant
    scales a quantized cache carries.  Single source of truth for the
    KV page reservation math in launch/serve.py and the effective-pages
    accounting in the quant benchmark."""
    row = 2 * kv_heads * head_dim * kv_eb
    if scaled:
        row += 2 * kv_heads * KV_SCALE_BYTES
    return row


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """A matmul tile choice for kernels/cache_matmul.py."""
    bm: int
    bn: int
    bk: int
    vmem_bytes: int
    fused_block: bool = False   # LBM variant: intermediates stay in VMEM

    @property
    def pages(self) -> int:
        return ceil_div(self.vmem_bytes, PAGE_BYTES)


def tile_vmem_bytes(bm: int, bn: int, bk: int, dtype_bytes: int,
                    acc_bytes: int = 4) -> int:
    """Working set of one (bm,bn,bk) matmul tile: A+B double-buffered in
    dtype, C accumulator in fp32."""
    return 2 * (bm * bk + bk * bn) * dtype_bytes + bm * bn * acc_bytes


def candidates_for_matmul(m: int, n: int, k: int, dtype_bytes: int,
                          budgets_pages: Tuple[int, ...] = (4, 16, 64, 256),
                          ) -> List[TileConfig]:
    """Enumerate hardware-aligned tile configs, one per page budget —
    the TPU analogue of the per-usage-limit LWM candidates."""
    sl = sublane(dtype_bytes)
    out: List[TileConfig] = []
    seen = set()
    for budget in budgets_pages:
        cap = budget * PAGE_BYTES
        best: Optional[TileConfig] = None
        bk_opts = [x for x in (128, 256, 512, 1024, 2048) if x <= max(k, 128)]
        bmn_opts = [x for x in (128, 256, 512, 1024) ]
        for bk in bk_opts:
            for bm in bmn_opts:
                if bm > max(m, 128):
                    continue
                for bn in bmn_opts:
                    if bn > max(n, 128):
                        continue
                    vb = tile_vmem_bytes(bm, bn, bk, dtype_bytes)
                    if vb > cap:
                        continue
                    # prefer larger K tiles (fewer accumulator spills),
                    # then larger M*N (better reuse)
                    score = (bk, bm * bn, min(bm, bn))
                    if best is None or score > (best.bk, best.bm * best.bn,
                                                min(best.bm, best.bn)):
                        best = TileConfig(bm, bn, bk, vb)
        if best and (best.bm, best.bn, best.bk) not in seen:
            seen.add((best.bm, best.bn, best.bk))
            out.append(best)
    if not out:  # smallest legal tile as last resort
        out.append(TileConfig(LANE, LANE, LANE,
                              tile_vmem_bytes(LANE, LANE, LANE, dtype_bytes)))
    return out


def fused_ffn_block_s(seq_block: int, dtype_bytes: int) -> int:
    """Fused-FFN sequence block: sublane-aligned, capped at two lanes."""
    sl = sublane(dtype_bytes)
    return min(2 * LANE, align_up(max(seq_block, sl), sl))


def min_fused_block_f(d_ff: int) -> int:
    """Smallest legal fused-FFN d_ff block: block_fused_ffn requires a
    divisor of d_ff, and below one lane the MXU utilization collapses —
    so the largest divisor <= LANE."""
    for x in range(min(d_ff, LANE), 0, -1):
        if d_ff % x == 0:
            return x
    return d_ff


def fused_ffn_vmem_bytes(block_s: int, block_f: int, d_model: int,
                         dtype_bytes: int) -> int:
    """VMEM working set of one fused-FFN grid step: x + out tiles,
    double-buffered weight tiles (wg/wu/wd), the fp32 accumulator, and
    the two fp32 hidden tiles that never reach HBM (the LBM guarantee).
    Single source of truth shared by admissibility (below), the serve-
    side LBM page bill, and the block-size search in core/plan.py."""
    io = 2 * block_s * d_model * dtype_bytes
    weights = 2 * 3 * d_model * block_f * dtype_bytes
    acc = block_s * d_model * 4
    hidden = 2 * block_s * block_f * 4
    return io + weights + acc + hidden


def fused_ffn_pages(seq_block: int, d_model: int, d_ff: int,
                    dtype_bytes: int) -> int:
    """VMEM pages the *smallest legal* fused (LBM) FFN configuration
    claims.  This is the page bill an LBM candidate must quote on the
    VMEM substrate: a grant that admits it is guaranteed to admit some
    fused block shape in core/plan.lower_ffn (same formula, same
    minimum block)."""
    bs = fused_ffn_block_s(seq_block, dtype_bytes)
    bf = min_fused_block_f(d_ff)
    return ceil_div(fused_ffn_vmem_bytes(bs, bf, d_model, dtype_bytes),
                    PAGE_BYTES)


def fused_ffn_admissible(seq_block: int, d_model: int, d_ff: int,
                         dtype_bytes: int, pages_avail: int) -> bool:
    """LBM admissibility on TPU: does any legal fused FFN block shape
    keep its working set within the granted page budget?"""
    return fused_ffn_pages(seq_block, d_model, d_ff,
                           dtype_bytes) <= pages_avail


def prefill_chunk_tokens(pages: int, d_model: int, d_ff: int,
                         dtype_bytes: int, *, align: int = LANE,
                         max_tokens: int = 2 * LANE) -> int:
    """Cache-aware prefill chunk sizing: the largest ``align``-multiple
    of tokens whose chunk working set fits the granted pages.  The
    working set mirrors :func:`fused_ffn_vmem_bytes` with the chunk as
    the sequence block — the double-buffered weight block (fixed per
    chunk) plus the per-token x/out rows, fp32 accumulator row, and fp32
    hidden rows — so a grant that admits the fused (LBM) kernel admits
    a full ``max_tokens`` chunk, and smaller tiled grants degrade to
    one-LANE chunks.  Floored at one ``align`` unit so a starved tenant
    still makes progress (with small tiled kernels) instead of
    stalling, and capped at ``max_tokens`` (the scheduling-graph
    seq_block the chunk MCT was built for).

    ``align`` is LANE for attention archs (chunk boundaries stay on the
    MXU tile / KV-window grid) and lcm(LANE, ssm_chunk) for SSM archs
    (interior chunk boundaries must land on SSD chunk boundaries for
    the chunked == one-shot bitwise contract)."""
    align = max(align, 1)
    bf = min_fused_block_f(max(d_ff, 1))
    weights = 2 * 3 * d_model * bf * dtype_bytes
    per_token = 2 * d_model * dtype_bytes + 4 * d_model + 2 * bf * 4
    fit = max(0, pages * PAGE_BYTES - weights) // per_token
    tokens = (fit // align) * align
    cap = max((max_tokens // align) * align, align)
    return max(align, min(tokens, cap))


def select_tile(cands: List[TileConfig], pages_avail: int) -> TileConfig:
    """Best-fit selection (mirrors MCT.best_fit): the largest-footprint
    candidate whose VMEM claim fits the granted pages."""
    fitting = [c for c in cands if c.pages <= pages_avail]
    if not fitting:
        return min(cands, key=lambda c: c.pages)
    return max(fitting, key=lambda c: (c.bk, c.bm * c.bn))


def lower_matmul_tile(m: int, n: int, k: int, dtype_bytes: int,
                      pages: int) -> TileConfig:
    """Enumerate + best-fit select in one step: the single entry point
    for turning a page grant into a matmul tile (used by both the
    kernel wrappers in kernels/ops.py and the KernelPlan lowering in
    core/plan.py — previously duplicated at each call site)."""
    return select_tile(candidates_for_matmul(m, n, k, dtype_bytes), pages)


def lower_selection(sel, pages: int, *, seq_block: int, d_model: int,
                    d_ff: int, dtype_bytes: int, head_dim: int = 0,
                    ssm_chunk: int = 0, down_pages: Optional[int] = None,
                    kv_dtype: str = "native"):
    """Lower a granted :class:`~repro.core.allocator.Selection` into a
    :class:`~repro.core.plan.KernelPlan` (deferred import: plan.py
    builds on this module's tile machinery)."""
    from repro_torch.core.plan import lower_selection as _lower
    return _lower(sel, pages, seq_block=seq_block, d_model=d_model,
                  d_ff=d_ff, dtype_bytes=dtype_bytes, head_dim=head_dim,
                  ssm_chunk=ssm_chunk, down_pages=down_pages,
                  kv_dtype=kv_dtype)
