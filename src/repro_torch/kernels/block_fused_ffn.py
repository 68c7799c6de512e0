"""block_fused_ffn: the LBM fused SwiGLU FFN as a hand-written Hopper kernel.

Replaces ``src/repro/kernels/block_fused_ffn.py::block_fused_ffn``
(Pallas, body ``_ffn_kernel``):
y = ((silu(x@wg) * (x@wu)).astype(x.dtype)) @ wd, fp32 accumulation,
with the [bs, bf] hidden tile kept on chip.  The CUDA source,
``csrc/block_fused_ffn.cu``, says why it splits over d_ff with fp32
partials and a fixed-order second pass (no atomics), what that costs,
and what bounds it on the H100 (at decode: the weight bytes, which the
``gemv`` tile streams in 16-byte vectors with a thread-block cluster per
d_ff tile; at prefill: the operations, and the partials' traffic, which
the ``wgmma`` tile cuts by summing them across a thread-block
cluster).

* :func:`block_fused_ffn` is the wrapper.  For CPU tensors it computes
  the plain version; for CUDA tensors it launches the kernel (its two
  passes), or raises.  It adds one to :data:`launches` per launch.
* :func:`block_fused_ffn_plain` is the plain PyTorch version, with the
  reference's cast points.
* :data:`TILES` is the menu the CUDA source compiles;
  ``kernels/ops.py::legalize_ffn_tile`` picks one under a plan's blocks.
  A tile has a kind, ``simt`` (fp32 FMA), ``gemv`` (bf16 decode rows,
  weights streamed into registers) or ``wgmma`` (bf16, tensor cores);
  :data:`launches_by_kind` counts the launches of each, and
  :data:`launches_by_shape` by the weights' shape (``"dxf"``).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.cache_matmul import (BF16, DTYPES, KINDS, _sm_count,
                                              dtype_mask, no_backward)


WGMMA_STAGES = 3      # csrc/block_fused_ffn.cu::FfnWgmma::stages
CLUSTER = 8           # csrc/block_fused_ffn.cu::FFN_CLUSTER
EXCHANGE_LD = 136     # csrc/block_fused_ffn.cu::FfnWgmma::ex_ld
GEMV_THREADS = 256    # csrc/block_fused_ffn.cu::FG_THREADS
GEMV_MAX_CLUSTER = 8  # the portable cluster size


@dataclasses.dataclass(frozen=True)
class FfnTile:
    """One compiled block shape: bs rows of x and bf columns of d_ff per
    thread block, d_model consumed bk at a time.  ``simt``: a [tm, tn]
    register tile per thread.  ``wgmma``: bs / 64 warpgroups of tm = 64
    rows, each issuing wgmma of width tn = bf, the blocks of a d_ff group
    of :data:`CLUSTER` tiles summing their partials as a cluster.
    ``gemv``: up to bs rows of x, a cluster of :func:`gemv_cluster`
    blocks per bf-wide d_ff tile splitting d_model, bk rows of x staged
    at a time, tn columns a thread."""
    bs: int
    bf: int
    bk: int
    tm: int
    tn: int
    kind: str = "simt"
    dtypes: Tuple[torch.dtype, ...] = DTYPES

    @property
    def smem_bytes(self) -> int:
        if self.kind == "gemv":    # x slab, exchange, h, cross-thread sums
            return 4 * self.bs * (self.bk + 3 * self.bf
                                  + GEMV_THREADS * self.tn)
        if self.kind == "wgmma":   # alignment, ring, fp32 exchange, barriers
            slot = max(2 * self.bs * self.bk + 2 * 2 * self.bk * self.bf,
                       2 * self.bf * self.bf)
            return (1024 + WGMMA_STAGES * slot + 4 * self.bs * EXCHANGE_LD
                    + 2 * WGMMA_STAGES * 8)
        x = self.bk * (self.bs + 1)
        gu = 2 * self.bk * self.bf
        h = self.bf * (self.bs + 1)
        wd = self.bf * self.bf
        return 4 * (x + gu + h + wd)

    def menu_fields(self) -> Tuple[int, ...]:
        """The entry as ``block_fused_ffn_tile`` describes it."""
        return (KINDS.index(self.kind), dtype_mask(self.dtypes), self.bs,
                self.bf, self.bk, self.tm, self.tn, self.smem_bytes)


# Index i is tile i of csrc/block_fused_ffn.cu (checked when it loads).
TILES = (FfnTile(8, 64, 64, 1, 2),
         FfnTile(16, 64, 32, 2, 2),
         FfnTile(32, 64, 32, 2, 4),
         FfnTile(64, 64, 32, 4, 4),
         FfnTile(64, 128, 64, 64, 128, "wgmma", BF16),
         FfnTile(128, 128, 64, 64, 128, "wgmma", BF16),
         FfnTile(8, 64, 1024, 8, 8, "gemv", BF16))

launches = 0
launches_by_kind: Dict[str, int] = dict.fromkeys(KINDS, 0)
# launches by the weights' shape, "dxf" (d_model x d_ff)
launches_by_shape: Dict[str, int] = {}
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("block_fused_ffn")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.block_fused_ffn_f32, lib.block_fused_ffn_bf16):
            fn.argtypes = [ptr] * 6 + [i32, i32, i32, i32, i32, ptr]
            fn.restype = i32
        lib.block_fused_ffn_tile.argtypes = [i32, ctypes.POINTER(i32)]
        lib.block_fused_ffn_tile.restype = i32
        build.check_menu(lib.block_fused_ffn_tile, TILES, "block_fused_ffn")
        _lib = lib
    return _lib


def block_fused_ffn_plain(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                          wd: torch.Tensor) -> torch.Tensor:
    """Plain version (the reference's ``ffn_ref``): fp32 products and
    sums, h rounded to x's dtype before the down product."""
    g = torch.matmul(x.float(), wg.float())
    u = torch.matmul(x.float(), wu.float())
    h = (F.silu(g) * u).to(x.dtype)
    return torch.matmul(h.float(), wd.float()).to(x.dtype)


def gemv_cluster(d: int, f: int, sms: int) -> int:
    """Blocks of the ``gemv`` tile's cluster on each 64-wide d_ff tile
    (d_model split among them): the fewest of 1, 2, 4, 8 that give the
    ceil(f / 64) tiles two blocks per SM, with at least 64 d_model rows
    a block (on an H100: yi-9b's d_ff 11008 and zamba2's 10240 take 2,
    whisper-tiny's 1536 at d_model 384 takes 4; sizes 1 to 8 timed in
    turns there, by chip_smoke.py's kernels phase).  A function of the
    shapes and the SM count alone, so launches of one shape on one card
    add their partials alike."""
    bf = next(t.bf for t in TILES if t.kind == "gemv")
    tiles, c = -(-f // bf), 1
    while (c < GEMV_MAX_CLUSTER and tiles * c < 2 * sms
           and 2 * c <= d // 64):
        c *= 2
    return c


def partial_bytes(tile: FfnTile, s: int, d: int, f: int) -> int:
    """Bytes of the fp32 partial outputs one launch writes (and its second
    pass reads): one [s, d] slab per bf-wide d_ff block (``simt``, and
    ``gemv``, whose cluster writes its tile's slab once), or per cluster
    of :data:`CLUSTER` such blocks (``wgmma``)."""
    slabs = -(-f // tile.bf)
    if tile.kind == "wgmma":
        slabs = -(-slabs // CLUSTER)
    return 4 * slabs * s * d


def block_fused_ffn(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                    wd: torch.Tensor, tile: FfnTile) -> torch.Tensor:
    """y = silu(x@wg) * (x@wu) @ wd through the Hopper kernel with block
    shape ``tile`` (one of :data:`TILES` compiled for x's dtype; the plain
    version ignores it).  x: [S, d]; wg/wu: [d, f]; wd: [f, d].  Ragged S,
    d_model and d_ff are masked in the kernel: no padding.  A ``wgmma``
    or ``gemv`` tile needs d and f to be multiples of 8 (TMA's, or the
    weight vectors', 16-byte rows), and a gemv tile at most its bs
    rows.  No backward: raises under grad
    (``cache_matmul.no_backward``)."""
    no_backward("block_fused_ffn", x, wg, wu, wd)
    if x.dim() != 2 or wg.dim() != 2 or wu.shape != wg.shape \
            or x.shape[1] != wg.shape[0] or wd.shape != (wg.shape[1], x.shape[1]):
        raise ValueError(f"block_fused_ffn: shapes x{tuple(x.shape)} "
                         f"wg{tuple(wg.shape)} wu{tuple(wu.shape)} "
                         f"wd{tuple(wd.shape)}")
    ws = (x, wg, wu, wd)
    if x.dtype not in DTYPES or any(w.dtype != x.dtype for w in ws):
        raise TypeError(f"block_fused_ffn: dtypes {[w.dtype for w in ws]}; "
                        f"want one of {DTYPES} for all")
    if any(w.device != x.device for w in ws):
        raise ValueError("block_fused_ffn: operands on different devices")
    if x.device.type == "cpu":
        return block_fused_ffn_plain(x, wg, wu, wd)
    if x.device.type != "cuda":
        raise ValueError(f"block_fused_ffn: unsupported device {x.device}")
    if not all(w.is_contiguous() for w in ws):
        raise ValueError("block_fused_ffn: operands must be contiguous")
    s, d = x.shape
    f = wg.shape[1]
    if x.dtype not in tile.dtypes:
        raise TypeError(f"block_fused_ffn: tile {tile} is not compiled for "
                        f"{x.dtype}")
    if tile.kind != "simt" and (d % 8 or f % 8
                                or any(w.data_ptr() % 16 for w in ws)):
        raise ValueError(f"block_fused_ffn: the {tile.kind} tile needs "
                         f"d_model and d_ff multiples of 8 and 16-byte "
                         f"aligned operands (d={d}, f={f})")
    if tile.kind == "gemv" and s > tile.bs:
        raise ValueError(f"block_fused_ffn: the gemv tile takes at most "
                         f"{tile.bs} rows, not {s}")
    y = torch.empty((s, d), dtype=x.dtype, device=x.device)
    if s == 0 or d == 0:
        return y
    partial = torch.empty(partial_bytes(tile, s, d, f) // 4,
                          dtype=torch.float32, device=x.device)
    lib = _library()
    fn = lib.block_fused_ffn_f32 if x.dtype == torch.float32 else lib.block_fused_ffn_bf16
    with torch.cuda.device(x.device):
        cluster = (gemv_cluster(d, f, _sm_count(x.device))
                   if tile.kind == "gemv" else 0)
        err = fn(x.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
                 partial.data_ptr(), y.data_ptr(), s, d, f, TILES.index(tile),
                 cluster, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"block_fused_ffn: launch failed with CUDA error "
                           f"{err} (S={s}, d={d}, f={f}, tile={tile})")
    global launches
    launches += 1
    launches_by_kind[tile.kind] += 1
    launches_by_shape[f"{d}x{f}"] = launches_by_shape.get(f"{d}x{f}", 0) + 1
    return y
