# Verbatim copy of src/repro/core/plan.py (the JAX package's framework-free
# scheduling code); only the package name in imports differs.
"""KernelPlan: the lowering layer from an allocator grant to Pallas
execution.

The paper's core claim is that cache-aware mapping *changes what the NPU
executes*: the candidate selected per usage limit fixes tile shapes and
whether the fused-block (LBM) variant runs.  On the JAX side the
allocator's decisions live in a :class:`~repro.core.allocator.Selection`
(candidate + page grant); this module lowers that into a concrete,
hashable per-layer execution plan:

  Selection (candidate, granted pages)
      -> KernelPlan (matmul TileConfig / fused-FFN blocks / attention
         block sizes / SSD chunk)
      -> kernels.ops dispatch (cache_matmul / block_fused_ffn /
         flash_attention)

Every plan field is a plain int/bool/frozen dataclass so a KernelPlan
can be passed to ``jax.jit`` as a *static* argument: each (tenant, plan)
pair compiles once and is cached, and shrinking a tenant's grant
observably switches it from LBM fused kernels to smaller-tile LWM
kernels mid-serve (launch/serve.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.allocator import Selection
from repro_torch.core.vmem import (LANE, PAGE_BYTES, TileConfig,
                             fused_ffn_block_s, fused_ffn_vmem_bytes,
                             lower_matmul_tile, min_fused_block_f,
                             prefill_chunk_tokens)


@dataclasses.dataclass(frozen=True)
class FfnPlan:
    """How one SwiGLU FFN executes under a page grant."""
    fused: bool                          # LBM: block_fused_ffn
    block_s: int = 0                     # fused: sequence block
    block_f: int = 0                     # fused: d_ff block
    up_tile: Optional[TileConfig] = None    # LWM: gate/up matmul tile
    down_tile: Optional[TileConfig] = None  # LWM: down matmul tile
    vmem_bytes: int = 0                  # fused: working set at lowering

    @property
    def vmem_pages(self) -> int:
        if self.fused:
            return -(-self.vmem_bytes // PAGE_BYTES)
        return max(self.up_tile.pages, self.down_tile.pages)


@dataclasses.dataclass(frozen=True)
class AttnPlan:
    """Flash-attention block sizes (prefill self-attention path).

    ``kv_dtype`` is the precision-for-residency axis: "native" keeps
    K/V in the compute dtype; "int8"/"fp8_e4m3" stream quantized K/V
    blocks through the dequant-fused kernel with per-row fp32 scales.
    """
    block_q: int = LANE
    block_kv: int = LANE
    kv_dtype: str = "native"


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """Concrete per-layer execution plan lowered from a granted
    Selection.  Hashable -> valid ``jax.jit`` static argument."""
    kind: str                            # "LBM" | "LWM"
    pages: int                           # grant the plan was lowered for
    ffn: FfnPlan
    attn: AttnPlan = AttnPlan()
    ssm_chunk: int = 0                   # 0 = architecture default

    @property
    def kv_dtype(self) -> str:
        return self.attn.kv_dtype

    def describe(self) -> str:
        kv = "" if self.attn.kv_dtype == "native" else f"+kv:{self.attn.kv_dtype}"
        if self.ffn.fused:
            return (f"LBM[bs{self.ffn.block_s}xbf{self.ffn.block_f}]"
                    f"@{self.pages}p{kv}")
        t = self.ffn.up_tile
        return f"LWM[{t.bm}x{t.bn}x{t.bk}]@{self.pages}p{kv}"


def lower_ffn(seq_block: int, d_model: int, d_ff: int, dtype_bytes: int,
              pages: int, want_fused: bool,
              down_pages: Optional[int] = None) -> FfnPlan:
    """Lower one FFN under a page grant.  LBM is taken only when the
    candidate asked for it AND some legal fused block shape (a divisor
    of d_ff, no smaller than min_fused_block_f) fits the grant — the
    same formula and floor fused_ffn_pages quotes, so an admitted LBM
    grant always lowers fused.  Otherwise each GEMM gets the best tile
    fitting its own grant."""
    if want_fused:
        bs = fused_ffn_block_s(seq_block, dtype_bytes)
        cap = pages * PAGE_BYTES
        for bf in range(min(d_ff, 1024), min_fused_block_f(d_ff) - 1, -1):
            if d_ff % bf:
                continue
            vb = fused_ffn_vmem_bytes(bs, bf, d_model, dtype_bytes)
            if vb <= cap:
                return FfnPlan(fused=True, block_s=bs, block_f=bf,
                               vmem_bytes=vb)
        # no legal fused block shape fits the grant: demote to tiled
    up = lower_matmul_tile(seq_block, d_ff, d_model, dtype_bytes, pages)
    down = lower_matmul_tile(seq_block, d_model, d_ff, dtype_bytes,
                             pages if down_pages is None else down_pages)
    return FfnPlan(fused=False, up_tile=up, down_tile=down)


def lower_attn(head_dim: int, dtype_bytes: int, pages: int,
               kv_dtype: str = "native",
               kv_dtype_bytes: Optional[int] = None) -> AttnPlan:
    """Largest flash-attention blocks whose working set (q tile, k/v
    double buffers, fp32 stats + score tile) fits the grant.  Quantized
    KV prices the k/v double buffers at the storage width plus the fp32
    per-row scale stripe, so a tight grant that only admits LANE blocks
    at bf16 can admit larger blocks at int8."""
    if head_dim <= 0:
        return AttnPlan(kv_dtype=kv_dtype)
    kvb = dtype_bytes if kv_dtype_bytes is None else kv_dtype_bytes
    scale = 4 if kvb < dtype_bytes else 0  # fp32 scale per streamed row
    cap = pages * PAGE_BYTES
    best = (LANE, LANE)
    for bq in (128, 256, 512):
        for bkv in (128, 256, 512):
            vb = (bq * head_dim * dtype_bytes
                  + 4 * bkv * (head_dim * kvb + scale)
                  + bq * head_dim * 4 + bq * bkv * 4)
            if vb <= cap and bq * bkv > best[0] * best[1]:
                best = (bq, bkv)
    return AttnPlan(*best, kv_dtype=kv_dtype)


def lower_ssm_chunk(default_chunk: int, pages: int) -> int:
    """Largest SSD chunk (halving from the arch default, floor 64) whose
    quadratic intra-chunk working set fits the grant."""
    if default_chunk <= 0:
        return 0
    cap = pages * PAGE_BYTES
    c = default_chunk
    while c > 64 and 12 * c * c > cap:
        c //= 2
    return max(c, min(64, default_chunk))


def lower_prefill_chunk(plan: KernelPlan, *, d_model: int, d_ff: int,
                        dtype_bytes: int, align: int = LANE,
                        max_tokens: int = 2 * LANE,
                        remaining: Optional[int] = None) -> int:
    """Lower a granted KernelPlan into the prefill chunk length it
    admits: the number of prompt tokens one chunk may carry before its
    working set outgrows the pages the plan was lowered for.  A fused
    (LBM) grant admits large chunks; a starved tiled grant degrades to
    one-LANE chunks instead of thrashing the shared VMEM pool — the
    serving-side knob that makes CaMDN's dynamic allocation visible as
    chunk shapes resizing at runtime.

    ``remaining`` clamps the chunk to the prompt tokens left AND
    absorbs a sub-``align`` tail into this chunk: a lone tail (e.g. one
    token of a 129-token prompt chunked at 128) would contract its
    attention through a different XLA path than the same tokens inside
    a larger chunk, breaking the chunked == one-shot bitwise contract.
    With absorption every emitted chunk either ends the prompt or
    leaves at least ``align`` tokens, so interior boundaries stay
    aligned and no chunk is ever smaller than ``align`` (unless the
    whole prompt is).  The cost is bounded: an absorbed final chunk
    exceeds the grant-lowered length by at most ``align - 1`` tokens —
    one extra LANE row of working set beyond what the chunk MCT was
    admitted and charged for, accepted as modeling slack on the last
    chunk of a non-aligned prompt."""
    tokens = prefill_chunk_tokens(plan.pages, d_model, d_ff, dtype_bytes,
                                  align=align, max_tokens=max_tokens)
    if remaining is not None:
        tokens = min(tokens, remaining)
        if 0 < remaining - tokens < align:
            tokens = remaining
    return tokens


def lower_selection(sel: Selection, pages: int, *, seq_block: int,
                    d_model: int, d_ff: int, dtype_bytes: int,
                    head_dim: int = 0, ssm_chunk: int = 0,
                    down_pages: Optional[int] = None,
                    kv_dtype: str = "native") -> KernelPlan:
    """Lower a granted Selection into the KernelPlan the model stack
    executes.  ``pages`` is the grant actually held for the (head)
    layer; ``down_pages`` optionally gives the down-projection GEMM its
    own grant when the runtime re-allocates between the two FFN GEMMs.
    ``kv_dtype`` pins the KV precision the tenant was admitted at
    ("native" | "int8" | "fp8_e4m3"); it rides the plan so jit entries
    keyed on the plan compile the matching cache structure.
    """
    want_fused = sel.candidate.kind == "LBM"
    if kv_dtype == "native":
        kv_bytes = dtype_bytes
    else:
        from repro_torch.core.types import elem_bytes
        kv_bytes = elem_bytes(kv_dtype)
    ffn = lower_ffn(seq_block, d_model, d_ff, dtype_bytes, pages,
                    want_fused, down_pages=down_pages)
    return KernelPlan(
        kind="LBM" if ffn.fused else "LWM",
        pages=pages,
        ffn=ffn,
        attn=lower_attn(head_dim, dtype_bytes, pages,
                        kv_dtype=kv_dtype, kv_dtype_bytes=kv_bytes),
        ssm_chunk=lower_ssm_chunk(ssm_chunk, pages))
