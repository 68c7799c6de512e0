"""Public wrappers of the port's kernels: KernelPlan dispatch (the
grant -> kernel link), budget-driven tile selection, and the Hopper tile
legalization.  Port of src/repro/kernels/ops.py (``planned_matmul``,
``budgeted_matmul``, ``planned_ffn``, ``fused_ffn``,
``planned_matmul_quant``, ``planned_ffn_quant``, ``attention``,
``ssd_intra_chunk``).

The plan stays the decision: LBM or LWM, the grant, and its tile.  The
plan's tiles were sized for 96 MiB of TPU VMEM (core/vmem.py), with
bm/bn up to 1024 and bk up to 2048; a Hopper thread block has at most the
device's opt-in shared memory per block (227 KB on the H100).  So the
plan's tile is kept as an upper bound and legalized: the kernel runs the
compiled Hopper tile that fits under it and in shared memory, chosen for
the operands' dtype and row count: fp32 keeps the fp32-FMA (``simt``)
tiles; bf16 takes the tensor-core (``wgmma``) tiles of cache_matmul,
cache_matmul_quant, block_fused_ffn and flash attention (native K/V at
head dims 64 and 128, quantized K/V at 128) and ssd_chunk's wgmma kind,
and for decode rows the ``gemv`` tiles of the two matmuls and of
block_fused_ffn.
Where the reference pads operands to tile boundaries through HBM
(``_pad_to``), the Hopper kernels mask their ragged edges instead.  CPU
tensors take the kernels' plain versions.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, TypeVar

import torch
import torch.nn.functional as F

from repro_torch.core.plan import FfnPlan
from repro_torch.core.vmem import TileConfig, lower_matmul_tile
from repro_torch.kernels import block_fused_ffn as kffn
from repro_torch.kernels import cache_matmul as kmm
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import quant as kquant
from repro_torch.kernels import ssd_scan as kssd

_T = TypeVar("_T")


def smem_limit(device: torch.device) -> Optional[int]:
    """Shared memory one thread block may use on ``device`` (the opt-in
    maximum, read from the device); None on the CPU, where the plain
    versions run and no tile applies."""
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).shared_memory_per_block_optin


def sm_count(device: torch.device) -> Optional[int]:
    """The device's SM count (the grids the kernels fill); None on the
    CPU."""
    return kmm._sm_count(device) if device.type == "cuda" else None


def _pick(fits: Sequence[_T], rows: int, row_dim: str, area) -> _T:
    """The tile wasting the fewest rows: the smallest row block covering
    ``rows`` if one fits, else the largest; ties go to the larger
    ``area`` (more bytes in flight per block)."""
    size = lambda t: getattr(t, row_dim)  # noqa: E731
    covering = [t for t in fits if size(t) >= rows]
    if covering:
        best = min(size(t) for t in covering)
    else:
        best = max(size(t) for t in fits)
    return max((t for t in fits if size(t) == best), key=area)


def _legalize_simt(tile: TileConfig, m: int, limit: Optional[int],
                   menu: Sequence[_T]) -> _T:
    """The tile of ``menu`` for a plan tile: no dimension above the
    plan's, shared memory within ``limit``, the fewest wasted rows.  When
    no compiled tile fits under the plan's bound, the smallest one runs
    (the floor, as the reference's tile selection falls back to its
    smallest candidate)."""
    fits = [t for t in menu
            if t.bm <= tile.bm and t.bn <= tile.bn and t.bk <= tile.bk
            and (limit is None or t.smem_bytes <= limit)]
    if not fits:
        fits = [min(menu, key=lambda t: (t.bm * t.bn, t.smem_bytes))]
    return _pick(fits, m, "bm", lambda t: t.bn * t.bk)


def matmul_kind(m: int, dtype: torch.dtype, k: Optional[int] = None,
                n: Optional[int] = None) -> str:
    """The tile kind a cache_matmul call of ``m`` rows runs: fp32 ->
    ``simt`` (IEEE fp32, no tensor cores); bf16 with at most 8 rows ->
    ``gemv``; more rows -> ``wgmma``, unless the row length K or N of an
    operand is not a multiple of 8 (TMA needs 16-byte row strides), which
    goes to ``simt``."""
    if dtype != torch.bfloat16:
        return "simt"
    if m <= max(t.bm for t in kmm.TILES if t.kind == "gemv"):
        return "gemv"
    if any(x is not None and x % 8 for x in (k, n)):
        return "simt"
    return "wgmma"


def legalize_matmul_tile(tile: TileConfig, m: int, limit: Optional[int],
                         dtype: torch.dtype, k: Optional[int] = None,
                         n: Optional[int] = None) -> kmm.HopperTile:
    """The compiled cache_matmul tile for a plan tile, operands of ``m``
    rows in ``dtype`` (K and N, where given, route misaligned rows): a
    tile of :func:`matmul_kind`'s kind no larger than the plan's in any
    dimension and within ``limit``, the fewest wasted rows (bf16 at 9 to
    64 rows takes the 64-row wgmma tile, more rows the 128-row one).
    Where no tile of that kind fits under the plan, or the kind is
    ``simt``, the simt tiles' rule applies."""
    kind = matmul_kind(m, dtype, k, n)
    if kind != "simt":
        fits = [t for t in kmm.TILES if t.kind == kind and dtype in t.dtypes
                and t.bm <= tile.bm and t.bn <= tile.bn and t.bk <= tile.bk
                and (limit is None or t.smem_bytes <= limit)]
        if fits:
            return _pick(fits, m, "bm", lambda t: t.bn * t.bk)
    return _legalize_simt(tile, m, limit,
                          [t for t in kmm.TILES if t.kind == "simt"])


def matmul_quant_kind(m: int, dtype: torch.dtype, k: Optional[int] = None,
                      n: Optional[int] = None) -> str:
    """The tile kind a cache_matmul_quant call of ``m`` rows of A in
    ``dtype`` runs: :func:`matmul_kind`'s rule, except that the 1-byte
    codes' rows are 16-byte aligned for TMA only when N is a multiple of
    16: fp32 -> ``simt``; bf16 with at most 8 rows -> ``gemv``; more rows
    -> ``wgmma``, unless K is not a multiple of 8 or N not of 16, which
    goes to ``simt``."""
    kind = matmul_kind(m, dtype, k, n)
    return "simt" if kind == "wgmma" and n is not None and n % 16 else kind


def legalize_matmul_quant_tile(tile: TileConfig, m: int, limit: Optional[int],
                               dtype: torch.dtype, k: Optional[int] = None,
                               n: Optional[int] = None) -> kmm.QuantTile:
    """The compiled cache_matmul_quant tile for a plan tile, A of ``m``
    rows in ``dtype`` (K and N, where given, route misaligned rows): a
    tile of :func:`matmul_quant_kind`'s kind no larger than the plan's
    in any dimension and within ``limit`` (bf16 at 9 to 64 rows takes the
    64-row wgmma tile, more rows the 128-row one); where none fits, or the
    kind is ``simt``, :func:`legalize_matmul_tile`'s simt rule over the
    quant menu's simt tiles."""
    kind = matmul_quant_kind(m, dtype, k, n)
    if kind != "simt":
        fits = [t for t in kmm.QUANT_TILES if t.kind == kind
                and dtype in t.dtypes and t.bm <= tile.bm and t.bn <= tile.bn
                and t.bk <= tile.bk
                and (limit is None or t.smem_bytes <= limit)]
        if fits:
            return _pick(fits, m, "bm", lambda t: t.bn * t.bk)
    return _legalize_simt(tile, m, limit,
                          [t for t in kmm.QUANT_TILES if t.kind == "simt"])


def ffn_kind(s: int, dtype: torch.dtype, d: Optional[int] = None,
             f: Optional[int] = None) -> str:
    """The tile kind a block_fused_ffn call of ``s`` rows runs: bf16 with
    at most 8 rows (decode) -> ``gemv``, more rows -> ``wgmma``, either
    only where d_model and d_ff are multiples of 8 (16-byte weight
    vectors, TMA's 16-byte row strides); fp32 and misaligned shapes ->
    ``simt``."""
    if dtype != torch.bfloat16:
        return "simt"
    if (d is not None and d % 8) or (f is not None and f % 8):
        return "simt"
    return "gemv" if s <= max(t.bs for t in kffn.TILES
                              if t.kind == "gemv") else "wgmma"


def legalize_ffn_tile(block_s: int, block_f: int, s: int,
                      limit: Optional[int], dtype: torch.dtype,
                      d: Optional[int] = None,
                      f: Optional[int] = None) -> kffn.FfnTile:
    """The compiled block_fused_ffn tile for a plan's fused blocks and
    ``s`` rows of x in ``dtype`` (d_model ``d`` and d_ff ``f``, where
    given, route misaligned rows): the [bs, bf] hidden tile no larger
    than the plan's [block_s, block_f] (the LBM working set the grant
    admitted), shared memory within ``limit``; a tile of
    :func:`ffn_kind`'s kind where one fits (bf16 decode rows the 8-row
    gemv tile, 9 to 64 rows the 64-row wgmma tile, more rows the 128-row
    one), else a simt tile, the smallest when none fits."""
    kind = ffn_kind(s, dtype, d, f)
    if kind != "simt":
        fits = [t for t in kffn.TILES if t.kind == kind
                and dtype in t.dtypes and t.bs <= block_s and t.bf <= block_f
                and (limit is None or t.smem_bytes <= limit)]
        if fits:
            return _pick(fits, s, "bs", lambda t: t.bf * t.bk)
    simt = [t for t in kffn.TILES if t.kind == "simt"]
    fits = [t for t in simt
            if t.bs <= block_s and t.bf <= block_f
            and (limit is None or t.smem_bytes <= limit)]
    if not fits:
        fits = [min(simt, key=lambda t: (t.bs * t.bf, t.smem_bytes))]
    return _pick(fits, s, "bs", lambda t: t.bf * t.bk)


def legalize_attn_tile(block_q: int, block_kv: int, hd: int, s: int,
                       limit: Optional[int], dtype: torch.dtype,
                       quantized: bool = False, heads: int = 0,
                       sms: Optional[int] = None) -> kfa.AttnTile:
    """The compiled flash-attention tile for a plan's blocks: head dim
    ``hd``, [bq, bkv] no larger than the plan's [block_q, block_kv],
    shared memory within ``limit``.  bf16 q takes the ``wgmma`` tile of
    the head dim for its K/V storage (native, or int8 / e4m3 codes when
    ``quantized``) where one fits.  Where the head dim has wgmma tiles of
    several q rows (hd 64: 128 and 64) and the grid is known, ``heads``
    (batch x query heads) q tiles of each row block and the card's
    ``sms``, the largest whose grid still gives every SM a block, else
    the smallest: whisper-tiny's decoder prefill (2 x 6 heads, up to 448
    rows) gives 128-row tiles at most 48 blocks for 132 SMs, so it takes
    64 rows; a batch of 8 at 448 rows takes 128 (each measured faster on
    an H100, chip_smoke.py's kernels phase).  fp32, head dims without a
    wgmma tile and an unknown grid take the simt rule: the fewest wasted
    rows of the ``s`` query rows, then the largest score tile, and the
    smallest tile of the head dim when none fits.  Raises for a head dim
    with no compiled tile."""
    own = [t for t in kfa.TILES if t.hd == hd]
    if not own:
        raise ValueError(f"flash_attention: head dim {hd} not compiled "
                         f"(have {sorted({t.hd for t in kfa.TILES})})")
    kv = "quantized" if quantized else "native"

    def fits(kind):
        return [t for t in own if t.kind == kind and dtype in t.dtypes
                and kv in t.kv and t.bq <= block_q and t.bkv <= block_kv
                and (limit is None or t.smem_bytes <= limit)]

    wgmma = fits("wgmma") if dtype == torch.bfloat16 else []
    if wgmma and heads and sms:
        filled = [t for t in wgmma if heads * -(-s // t.bq) >= sms]
        return max(filled, key=lambda t: t.bq) if filled else \
            min(wgmma, key=lambda t: t.bq)
    if wgmma:
        return _pick(wgmma, s, "bq", lambda t: t.bq * t.bkv)
    simt = [t for t in own if t.kind == "simt"]
    return _pick(fits("simt") or
                 [min(simt, key=lambda t: (t.bq * t.bkv, t.smem_bytes))],
                 s, "bq", lambda t: t.bq * t.bkv)


def planned_matmul(a: torch.Tensor, b: torch.Tensor,
                   tile: TileConfig) -> torch.Tensor:
    """Matmul through an explicit, already-lowered plan tile (legalized
    for Hopper) — the KernelPlan dispatch point."""
    hopper = legalize_matmul_tile(tile, a.shape[0], smem_limit(a.device),
                                  a.dtype, a.shape[1], b.shape[1])
    return kmm.cache_matmul(a, b, hopper)


def budgeted_matmul(a: torch.Tensor, b: torch.Tensor,
                    pages: int = 64) -> torch.Tensor:
    """Matmul through the tile candidate selected for a page budget."""
    m, k = a.shape
    n = b.shape[1]
    tile = lower_matmul_tile(m, n, k, a.element_size(), pages)
    return planned_matmul(a, b, tile)


def fused_ffn(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
              wd: torch.Tensor, block_s: int = 256,
              block_f: int = 512) -> torch.Tensor:
    """The fused (LBM) FFN with the plan's blocks as the upper bound of
    the on-chip hidden tile.  The row block is not clamped to S as the
    reference clamps it: S rows are masked in the kernel, so the
    legalization picks the smallest compiled row block covering S."""
    s, d = x.shape
    f = wg.shape[1]
    tile = legalize_ffn_tile(block_s, min(block_f, f), s,
                             smem_limit(x.device), x.dtype, d, f)
    return kffn.block_fused_ffn(x, wg, wu, wd, tile)


def planned_ffn(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                wd: torch.Tensor, plan: FfnPlan) -> torch.Tensor:
    """SwiGLU FFN executed the way the plan's candidate prescribes:

      LBM (plan.fused)  -> block_fused_ffn; the hidden activation never
                           reaches device memory.
      LWM (tiled)       -> three cache_matmul launches with the plan's
                           tiles; the hidden tensors round-trip HBM.

    x: [S, d]; wg/wu: [d, f]; wd: [f, d].
    """
    if plan.fused:
        return fused_ffn(x, wg, wu, wd, block_s=plan.block_s,
                         block_f=plan.block_f)
    g = planned_matmul(x, wg, plan.up_tile)
    u = planned_matmul(x, wu, plan.up_tile)
    h = (F.silu(g.float()) * u.float()).to(x.dtype)
    return planned_matmul(h, wd, plan.down_tile)


def planned_matmul_quant(a: torch.Tensor, b_q: torch.Tensor,
                         b_scale: torch.Tensor,
                         tile: TileConfig) -> torch.Tensor:
    """Dequant-fused planned matmul: ``b_q`` pre-quantized (int8 / fp8)
    with per-column scales ``b_scale`` [1, N]
    (``kernels/quant.py::quantize_cols``).  B streams at quantized width
    through the plan's tile, legalized for the quant kernel's menu."""
    hopper = legalize_matmul_quant_tile(tile, a.shape[0], smem_limit(a.device),
                                        a.dtype, a.shape[1], b_q.shape[1])
    return kmm.cache_matmul_quant(a, b_q, b_scale, hopper)


def ffn_quant_tiles(plan: FfnPlan, s: int, d: int,
                    f: int) -> Tuple[TileConfig, TileConfig]:
    """The (gate/up, down) plan tiles :func:`planned_ffn_quant` runs for
    x [s, d] and d_ff ``f``: the plan's own, or for a fused plan the
    gate/up tile lowered from its pages at one byte an element, serving
    the down GEMM too (the reference's fallback)."""
    up = plan.up_tile if plan.up_tile is not None else \
        lower_matmul_tile(s, f, d, 1, plan.vmem_pages)
    return up, plan.down_tile if plan.down_tile is not None else up


def planned_ffn_quant(x: torch.Tensor, wg: torch.Tensor, wg_s: torch.Tensor,
                      wu: torch.Tensor, wu_s: torch.Tensor, wd: torch.Tensor,
                      wd_s: torch.Tensor, plan: FfnPlan) -> torch.Tensor:
    """SwiGLU FFN over pre-quantized weights (per-column scales), each
    GEMM through the dequant-fused kernel with the plan's tiles.
    Quantized weights always run tiled (LWM), as in the reference; a
    fused plan's tiles come from :func:`ffn_quant_tiles`."""
    tile_up, tile_dn = ffn_quant_tiles(plan, x.shape[0], x.shape[1],
                                       wg.shape[1])
    g = planned_matmul_quant(x, wg, wg_s, tile_up)
    u = planned_matmul_quant(x, wu, wu_s, tile_up)
    h = (F.silu(g.float()) * u.float()).to(x.dtype)
    return planned_matmul_quant(h, wd, wd_s, tile_dn)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, block_q: int = 128, block_kv: int = 128,
              kv_dtype: str = "native") -> torch.Tensor:
    """Flash attention with the plan's blocks as the upper bound of the
    kernel's tile.  ``kv_dtype`` != "native" quantizes K/V per row and
    runs the dequant-fused kernel (the plan-lowered prefill path of a
    precision-downgraded tenant).  q: [B, H, S, hd]; k, v:
    [B, Hkv, Sk, hd].  Ragged S and Sk are masked in the kernel, where
    the reference pads them (``_pad_to``); non-causal, the reference's
    zero-padded keys take part in its softmax, the port's masked ones do
    not."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    tile = legalize_attn_tile(block_q, block_kv, q.shape[3], q.shape[2],
                              smem_limit(q.device), q.dtype,
                              kv_dtype != "native", q.shape[0] * q.shape[1],
                              sm_count(q.device))
    if kv_dtype != "native":
        kq, ks = kquant.quantize_rows(k, kv_dtype)
        vq, vs = kquant.quantize_rows(v, kv_dtype)
        return kfa.flash_attention_quantized(q, kq, vq, ks[..., 0], vs[..., 0],
                                             causal, tile)
    return kfa.flash_attention(q, k, v, causal, tile)


def ssd_kind(dtype: torch.dtype, n: int, p: int) -> str:
    """The kind an ssd_chunk call with state size ``n`` and head dim
    ``p`` runs: bf16 -> ``wgmma`` where N is a multiple of 16 (up to
    ``kssd.MAX_WGMMA_STATE``) and P one of ``kssd.WGMMA_HEAD_DIMS``
    (``kssd.wgmma_takes``); fp32 and other shapes -> ``simt``."""
    return "wgmma" if kssd.wgmma_takes(dtype, n, p) else "simt"


def ssd_intra_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, chunk: int = 256
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Intra-chunk SSD (y_diag and the chunk states) through the
    ssd_chunk kernel of :func:`ssd_kind`'s kind.  x [BH, S, P]; dt
    [BH, S]; A [BH]; B, C [BH, S, N] or, shared by the heads of a batch
    row, [BH / heads, S, N], which is how the model passes them: no
    broadcast copy is made.  The call goes through
    ``kssd.SsdChunk``, so its gradient runs the ssd_chunk_bwd kernel on
    the card and its plain version on the CPU."""
    return kssd.SsdChunk.apply(x.contiguous(), dt.contiguous(),
                               A.contiguous(), B.contiguous(),
                               C.contiguous(), chunk,
                               ssd_kind(x.dtype, B.shape[-1], x.shape[-1]))
