"""cache_matmul: the LWM matmul as a hand-written Hopper kernel.

Replaces ``src/repro/kernels/cache_matmul.py::cache_matmul`` (Pallas,
body ``_matmul_kernel``): C[M,N] = A[M,K] @ B[K,N] with an fp32
accumulator, cast to A's dtype at the end.  The CUDA source,
``csrc/cache_matmul.cu``, says how the kernel is laid out and what bounds
it on the H100 (at decode: the bytes of B).

* :func:`cache_matmul` is the wrapper.  For CPU tensors it computes the
  plain version; for CUDA tensors it launches the kernel, or raises.  It
  adds one to :data:`launches` per kernel launch.
* :func:`cache_matmul_plain` is the plain PyTorch version, with the
  reference's cast points.
* :data:`TILES` is the menu of tile shapes the CUDA source compiles;
  ``kernels/ops.py::legalize_matmul_tile`` picks one under a plan's tile.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build

DTYPES = (torch.float32, torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class HopperTile:
    """One compiled tile shape: a [bm, bn] output tile per thread block,
    K consumed bk at a time, a [tm, tn] register tile per thread."""
    bm: int
    bn: int
    bk: int
    tm: int
    tn: int

    @property
    def smem_bytes(self) -> int:
        return 4 * (self.bk * (self.bm + 1) + self.bk * self.bn)


# Index i is tile i of csrc/cache_matmul.cu (checked when it loads).
TILES = (HopperTile(8, 32, 256, 1, 1),
         HopperTile(16, 64, 64, 2, 2),
         HopperTile(32, 64, 64, 2, 4),
         HopperTile(64, 64, 32, 4, 4),
         HopperTile(128, 128, 32, 8, 8),
         HopperTile(8, 32, 32, 1, 1))

launches = 0
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("cache_matmul")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.cache_matmul_f32, lib.cache_matmul_bf16):
            fn.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, ptr]
            fn.restype = i32
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


def cache_matmul(a: torch.Tensor, b: torch.Tensor,
                 tile: HopperTile) -> torch.Tensor:
    """C[M,N] = A[M,K] @ B[K,N] through the Hopper kernel with ``tile``
    (one of :data:`TILES`; the plain version ignores it).  Ragged M/N/K
    edges are masked in the kernel: no padding."""
    _check(a, b)
    if a.device.type == "cpu":
        return cache_matmul_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"cache_matmul: unsupported device {a.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("cache_matmul: operands must be contiguous")
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0 or n == 0:
        return c
    lib = _library()
    fn = lib.cache_matmul_f32 if a.dtype == torch.float32 else lib.cache_matmul_bf16
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
                 TILES.index(tile), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"cache_matmul: launch failed with CUDA error {err}"
                           f" (M={m}, N={n}, K={k}, tile={tile})")
    global launches
    launches += 1
    return c
