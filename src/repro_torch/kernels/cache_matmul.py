"""cache_matmul and cache_matmul_quant: the LWM matmuls as hand-written
Hopper kernels.

Replaces ``src/repro/kernels/cache_matmul.py::cache_matmul`` (Pallas,
body ``_matmul_kernel``): C[M,N] = A[M,K] @ B[K,N] with an fp32
accumulator, cast to A's dtype at the end; and ``cache_matmul_quant``
(body ``_matmul_quant_kernel``): the same with B stored as int8 or
float8_e4m3 codes and one fp32 scale per column, dequantized on chip.
The CUDA sources, ``csrc/cache_matmul.cu`` and
``csrc/cache_matmul_quant.cu``, say how each kernel is laid out and what
bounds it on the H100 (at decode: the bytes of B).

* :func:`cache_matmul` / :func:`cache_matmul_quant` are the wrappers.
  For CPU tensors they compute the plain version; for CUDA tensors they
  launch the kernel, or raise.  They add one to :data:`launches` /
  :data:`launches_quant` per kernel launch.
* :func:`cache_matmul_plain` / :func:`cache_matmul_quant_plain` are the
  plain PyTorch versions, with the reference's cast points.
* :data:`TILES` / :data:`QUANT_TILES` are the menus of tile shapes the
  CUDA sources compile; ``kernels/ops.py::legalize_matmul_tile`` and
  ``legalize_matmul_quant_tile`` pick one under a plan's tile.  A
  cache_matmul tile has a kind: ``simt`` (fp32 FMA from shared memory,
  fp32 and bf16), ``gemv`` (bf16 decode rows, B streamed into registers)
  or ``wgmma`` (bf16, tensor cores fed by TMA); :data:`launches_by_kind`
  counts the launches of each.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build

DTYPES = (torch.float32, torch.bfloat16)
CODE_DTYPES = (torch.int8, torch.float8_e4m3fn)


KINDS = ("simt", "gemv", "wgmma")
GEMV_WARPS = 8        # csrc/cache_matmul.cu::GEMV_NW
WGMMA_STAGES = 4      # csrc/cache_matmul.cu::Wgmma::stages


def dtype_mask(dtypes) -> int:
    """The C menus' dtype mask: 1 for float32, 2 for bfloat16."""
    return sum(1 << DTYPES.index(d) for d in dtypes)


@dataclasses.dataclass(frozen=True)
class HopperTile:
    """One compiled tile: a [bm, bn] output tile per thread block, K
    consumed bk at a time.  ``simt``: a [tm, tn] register tile per thread.
    ``gemv``: up to bm rows of A, bn columns per block, bk rows of A
    staged at a time, tm x tn sums per thread.  ``wgmma``: bm / 64
    warpgroups of tm = 64 rows, each issuing wgmma of width tn = bn."""
    bm: int
    bn: int
    bk: int
    tm: int
    tn: int
    kind: str = "simt"
    dtypes: Tuple[torch.dtype, ...] = DTYPES

    @property
    def smem_bytes(self) -> int:
        if self.kind == "gemv":     # A slab, then the warps' partial sums
            return 4 * max(self.bk * self.bm, GEMV_WARPS * self.bm * self.bn)
        if self.kind == "wgmma":    # alignment, bf16 A/B ring, 2 barriers a stage
            return (1024 + WGMMA_STAGES * 2 * (self.bm * self.bk + self.bk * self.bn)
                    + 2 * WGMMA_STAGES * 8)
        return 4 * (self.bk * (self.bm + 1) + self.bk * self.bn)

    def menu_fields(self) -> Tuple[int, ...]:
        """The entry as ``cache_matmul_tile`` describes it."""
        return (KINDS.index(self.kind), dtype_mask(self.dtypes), self.bm,
                self.bn, self.bk, self.tm, self.tn, self.smem_bytes)


BF16 = (torch.bfloat16,)
# Index i is tile i of csrc/cache_matmul.cu (checked when it loads).
TILES = (HopperTile(8, 32, 256, 1, 1),
         HopperTile(16, 64, 64, 2, 2),
         HopperTile(32, 64, 64, 2, 4),
         HopperTile(64, 64, 32, 4, 4),
         HopperTile(128, 128, 32, 8, 8),
         HopperTile(8, 32, 32, 1, 1),
         HopperTile(8, 256, 256, 8, 8, "gemv", BF16),
         HopperTile(64, 256, 64, 64, 256, "wgmma", BF16),
         HopperTile(128, 256, 64, 64, 256, "wgmma", BF16))


@dataclasses.dataclass(frozen=True)
class QuantTile:
    """A compiled tile of the quantized kernel: a [bm, bn] output tile per
    thread block, K consumed bk at a time, a [tm, tn] register tile per
    thread.  B lands in shared memory dequantized, as fp32 like A, beside
    the block's [bn] fp32 scale stripe (``QTile::smem`` in
    csrc/cache_matmul_quant.cu)."""
    bm: int
    bn: int
    bk: int
    tm: int
    tn: int

    @property
    def smem_bytes(self) -> int:
        return 4 * (self.bk * (self.bm + 1) + self.bk * self.bn + self.bn)


# Index i is tile i of csrc/cache_matmul_quant.cu (checked when it loads).
QUANT_TILES = (QuantTile(8, 32, 256, 1, 1),
               QuantTile(16, 64, 64, 2, 2),
               QuantTile(32, 64, 64, 2, 4),
               QuantTile(64, 64, 32, 4, 4),
               QuantTile(128, 128, 32, 8, 8),
               QuantTile(8, 32, 32, 1, 1))


def gemv_split(n: int, k: int, sms: int) -> Tuple[int, int]:
    """(kchunk, ranges) for the gemv tile: K cut into ranges of kchunk
    rows (a multiple of 32) so that the ceil(n / bn) column blocks times
    the ranges give about four blocks per SM; a second pass adds the
    ranges' fp32 partial sums in order.  A function of the shapes and the
    SM count alone, so launches of one shape on one card sum alike."""
    bn = next(t.bn for t in TILES if t.kind == "gemv")
    want = max(1, -(-4 * sms // -(-n // bn)))
    kchunk = max(32, -(-(-(-k // want)) // 32) * 32)
    return kchunk, max(1, -(-k // kchunk))


launches = 0
launches_by_kind: Dict[str, int] = dict.fromkeys(KINDS, 0)
launches_quant = 0
_lib = None
_qlib = None
_sms: Dict[int, int] = {}


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("cache_matmul")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.cache_matmul_f32.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr]
        lib.cache_matmul_bf16.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32,
                                          i32, i32, ptr]
        lib.cache_matmul_f32.restype = lib.cache_matmul_bf16.restype = i32
        lib.cache_matmul_tile.argtypes = [i32, ctypes.POINTER(i32)]
        lib.cache_matmul_tile.restype = i32
        build.check_menu(lib.cache_matmul_tile, TILES, "cache_matmul")
        _lib = lib
    return _lib


def cache_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version (the reference's ``matmul_ref``): fp32 products and
    sums, cast to A's dtype."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"cache_matmul: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in DTYPES:
        raise TypeError(f"cache_matmul: dtypes {a.dtype}, {b.dtype}; "
                        f"want one of {DTYPES} for both")
    if a.device != b.device:
        raise ValueError(f"cache_matmul: devices {a.device}, {b.device}")


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def cache_matmul(a: torch.Tensor, b: torch.Tensor,
                 tile: HopperTile) -> torch.Tensor:
    """C[M,N] = A[M,K] @ B[K,N] through the Hopper kernel with ``tile``
    (one of :data:`TILES` compiled for A's dtype; the plain version
    ignores it).  Ragged M/N/K edges are masked in the kernel: no
    padding.  A ``gemv`` tile takes at most bm rows; a ``wgmma`` tile
    needs K and N to be multiples of 8 (TMA's 16-byte row strides)."""
    _check(a, b)
    if a.device.type == "cpu":
        return cache_matmul_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"cache_matmul: unsupported device {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("cache_matmul: operands must be contiguous")
    m, k = a.shape
    n = b.shape[1]
    if a.dtype not in tile.dtypes:
        raise TypeError(f"cache_matmul: tile {tile} is not compiled for "
                        f"{a.dtype}")
    if tile.kind == "gemv" and m > tile.bm:
        raise ValueError(f"cache_matmul: {m} rows exceed the gemv tile's "
                         f"{tile.bm}")
    if tile.kind == "wgmma" and (k % 8 or n % 8 or a.data_ptr() % 16
                                 or b.data_ptr() % 16):
        raise ValueError(f"cache_matmul: the wgmma tile needs K, N multiples "
                         f"of 8 and 16-byte aligned operands (K={k}, N={n})")
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0 or n == 0:
        return c
    lib = _library()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        if a.dtype == torch.float32:
            err = lib.cache_matmul_f32(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                       m, n, k, TILES.index(tile), stream)
        else:
            kchunk, ranges = (gemv_split(n, k, _sm_count(a.device))
                              if tile.kind == "gemv" else (0, 1))
            partial = (torch.empty((ranges, m, n), dtype=torch.float32,
                                   device=a.device) if ranges > 1 else None)
            err = lib.cache_matmul_bf16(
                a.data_ptr(), b.data_ptr(), c.data_ptr(),
                None if partial is None else partial.data_ptr(), m, n, k,
                TILES.index(tile), kchunk, stream)
    if err != 0:
        raise RuntimeError(f"cache_matmul: launch failed with CUDA error {err}"
                           f" (M={m}, N={n}, K={k}, tile={tile})")
    global launches
    launches += 1
    launches_by_kind[tile.kind] += 1
    return c


# ------------------------------------------------------------- quant --
def _quant_library() -> ctypes.CDLL:
    global _qlib
    if _qlib is None:
        lib = build.load("cache_matmul_quant")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.cache_matmul_quant_f32_i8, lib.cache_matmul_quant_f32_f8,
                   lib.cache_matmul_quant_bf16_i8,
                   lib.cache_matmul_quant_bf16_f8):
            fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
            fn.restype = i32
        lib.cache_matmul_quant_tile.argtypes = [i32, ctypes.POINTER(i32)]
        lib.cache_matmul_quant_tile.restype = i32
        build.check_menu(lib.cache_matmul_quant_tile, QUANT_TILES,
                         "cache_matmul_quant")
        _qlib = lib
    return _qlib


def cache_matmul_quant_plain(a: torch.Tensor, b_q: torch.Tensor,
                             b_scale: torch.Tensor) -> torch.Tensor:
    """Plain version: the codes dequantized in fp32 (``q.float() * s``),
    fp32 products and sums, cast to A's dtype (the reference's
    ``jnp.dot`` of A and the fp32 dequantized B)."""
    return torch.matmul(a.float(), b_q.float() * b_scale).to(a.dtype)


def _check_quant(a: torch.Tensor, b_q: torch.Tensor,
                 b_scale: torch.Tensor) -> None:
    if (a.dim() != 2 or b_q.dim() != 2 or a.shape[1] != b_q.shape[0]
            or tuple(b_scale.shape) != (1, b_q.shape[1])):
        raise ValueError(f"cache_matmul_quant: shapes {tuple(a.shape)} @ "
                         f"{tuple(b_q.shape)}, scale {tuple(b_scale.shape)}")
    if (a.dtype not in DTYPES or b_q.dtype not in CODE_DTYPES
            or b_scale.dtype != torch.float32):
        raise TypeError(f"cache_matmul_quant: dtypes {a.dtype}, {b_q.dtype}, "
                        f"{b_scale.dtype}; want A in {DTYPES}, B in "
                        f"{CODE_DTYPES}, scale float32")
    if not (a.device == b_q.device == b_scale.device):
        raise ValueError(f"cache_matmul_quant: devices {a.device}, "
                         f"{b_q.device}, {b_scale.device}")


def cache_matmul_quant(a: torch.Tensor, b_q: torch.Tensor,
                       b_scale: torch.Tensor, tile: QuantTile) -> torch.Tensor:
    """C[M,N] = A[M,K] @ (B_q[K,N] * b_scale[1,N]) through the Hopper
    kernel with ``tile`` (one of :data:`QUANT_TILES`; the plain version
    ignores it).  B is read as 1-byte codes and dequantized on chip: no
    fp copy of B is made.  Ragged edges are masked in the kernel."""
    _check_quant(a, b_q, b_scale)
    if a.device.type == "cpu":
        return cache_matmul_quant_plain(a, b_q, b_scale)
    if a.device.type != "cuda":
        raise ValueError(f"cache_matmul_quant: unsupported device {a.device}")
    if not (a.is_contiguous() and b_q.is_contiguous()
            and b_scale.is_contiguous()):
        raise ValueError("cache_matmul_quant: operands must be contiguous")
    m, k = a.shape
    n = b_q.shape[1]
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0 or n == 0:
        return c
    lib = _quant_library()
    fn = getattr(lib, "cache_matmul_quant_{}_{}".format(
        "f32" if a.dtype == torch.float32 else "bf16",
        "i8" if b_q.dtype == torch.int8 else "f8"))
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b_q.data_ptr(), b_scale.data_ptr(),
                 c.data_ptr(), m, n, k, QUANT_TILES.index(tile),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"cache_matmul_quant: launch failed with CUDA "
                           f"error {err} (M={m}, N={n}, K={k}, tile={tile})")
    global launches_quant
    launches_quant += 1
    return c
