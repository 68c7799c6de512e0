"""Public wrappers of the port's kernels: KernelPlan dispatch (the
grant -> kernel link), budget-driven tile selection, and the Hopper tile
legalization.  Port of src/repro/kernels/ops.py (``planned_matmul``,
``budgeted_matmul``, ``planned_ffn``, ``fused_ffn``).

The plan stays the decision: LBM or LWM, the grant, and its tile.  The
plan's tiles were sized for 96 MiB of TPU VMEM (core/vmem.py), with
bm/bn up to 1024 and bk up to 2048; a Hopper thread block has at most the
device's opt-in shared memory per block (227 KB on the H100).  So the
plan's tile is kept as an upper bound and legalized: the kernel runs the
compiled Hopper tile that fits under it and in shared memory, chosen for
the operand's row count.  Where the reference pads operands to tile
boundaries through HBM (``_pad_to``), the Hopper kernels mask their
ragged edges instead.  CPU tensors take the kernels' plain versions.
"""
from __future__ import annotations

from typing import Optional, Sequence, TypeVar

import torch
import torch.nn.functional as F

from repro_torch.core.plan import FfnPlan
from repro_torch.core.vmem import TileConfig, lower_matmul_tile
from repro_torch.kernels import block_fused_ffn as kffn
from repro_torch.kernels import cache_matmul as kmm

_T = TypeVar("_T")


def smem_limit(device: torch.device) -> Optional[int]:
    """Shared memory one thread block may use on ``device`` (the opt-in
    maximum, read from the device); None on the CPU, where the plain
    versions run and no tile applies."""
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).shared_memory_per_block_optin


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


def legalize_matmul_tile(tile: TileConfig, m: int,
                         limit: Optional[int]) -> kmm.HopperTile:
    """The compiled cache_matmul tile for a plan tile: no dimension above
    the plan's, shared memory within ``limit``.  When no compiled tile
    fits under the plan's bound, the smallest one runs (the floor, as the
    reference's tile selection falls back to its smallest candidate)."""
    fits = [t for t in kmm.TILES
            if t.bm <= tile.bm and t.bn <= tile.bn and t.bk <= tile.bk
            and (limit is None or t.smem_bytes <= limit)]
    if not fits:
        fits = [min(kmm.TILES, key=lambda t: (t.bm * t.bn, t.smem_bytes))]
    return _pick(fits, m, "bm", lambda t: t.bn * t.bk)


def legalize_ffn_tile(block_s: int, block_f: int, s: int,
                      limit: Optional[int]) -> kffn.FfnTile:
    """The compiled block_fused_ffn tile for a plan's fused blocks: the
    [bs, bf] hidden tile no larger than the plan's [block_s, block_f]
    (the LBM working set the grant admitted), shared memory within
    ``limit``; the smallest tile when none fits."""
    fits = [t for t in kffn.TILES
            if t.bs <= block_s and t.bf <= block_f
            and (limit is None or t.smem_bytes <= limit)]
    if not fits:
        fits = [min(kffn.TILES, key=lambda t: (t.bs * t.bf, t.smem_bytes))]
    return _pick(fits, s, "bs", lambda t: t.bf * t.bk)


def planned_matmul(a: torch.Tensor, b: torch.Tensor,
                   tile: TileConfig) -> torch.Tensor:
    """Matmul through an explicit, already-lowered plan tile (legalized
    for Hopper) — the KernelPlan dispatch point."""
    hopper = legalize_matmul_tile(tile, a.shape[0], smem_limit(a.device))
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
    s = x.shape[0]
    tile = legalize_ffn_tile(block_s, min(block_f, wg.shape[1]), s,
                             smem_limit(x.device))
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
