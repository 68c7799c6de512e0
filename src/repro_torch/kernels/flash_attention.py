"""flash_attention and flash_attention_quantized: GQA attention with an
online softmax as one hand-written Hopper kernel.

Replaces the two entry points of ``src/repro/kernels/flash_attention.py``
(Pallas, one body ``_flash_kernel``): ``flash_attention`` (K/V in q's
dtype) and ``flash_attention_quantized`` (K/V int8 or float8_e4m3 with
one fp32 scale per row, dequantized on chip).  The CUDA source,
``csrc/flash_attention.cu``, is one kernel templated on the K/V load; it
says how the kernel is laid out and what bounds it on the H100 (at the
prefill path's shape: operations).

* :func:`flash_attention` and :func:`flash_attention_quantized` are the
  wrappers.  For CPU tensors they compute the plain versions; for CUDA
  tensors they launch the kernel, or raise.  Each adds one to its own
  counter, :data:`launches` and :data:`launches_quantized`, per launch.
* :func:`flash_attention_plain` and
  :func:`flash_attention_quantized_plain` are the plain PyTorch versions
  (the reference's ``attention_ref`` semantics and cast points).
* :data:`TILES` is the menu of (hd, BQ, BKV) tiles the CUDA source
  compiles; ``kernels/ops.py::legalize_attn_tile`` picks one under a
  plan's blocks.  The two ``wgmma`` tiles (bf16 q, hd 128) run
  tensor-core kernels, one for native K/V and one for int8 / e4m3 K/V
  (codes converted to bf16 on chip, scales folded into the scores and
  into P); the ``simt`` tiles run the fp32-FMA one, for native and
  quantized K/V.  :data:`launches_by_kind` and
  :data:`launches_quantized_by_kind` split the native and the quantized
  launches by kind.

Layouts are the reference's: q [B, H, S, hd]; k, v [B, Hkv, Sk, hd] with
H % Hkv == 0 (q-head h reads KV head h // (H // Hkv)); scales
[B, Hkv, Sk].  The causal mask assumes q and k both start at position 0,
as the reference's does.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.cache_matmul import DTYPES, KINDS, dtype_mask

NEG_INF = -1e30
# quantized K/V storage dtype -> the C entry point's kv_kind
KV_KINDS = {torch.int8: 1, torch.float8_e4m3fn: 2}


@dataclasses.dataclass(frozen=True)
class AttnTile:
    """One compiled tile: head dim hd, a [bq, bkv] score tile per thread
    block, for the K/V storage in ``kv`` ("native": q's dtype;
    "quantized": int8 / e4m3 codes with row scales).  ``simt``: a
    [tm, tn] register tile of it per thread, fp32 FMA (fp32 and bf16,
    native or quantized K/V).  ``wgmma``: warpgroups of tm = 64 q rows
    issuing wgmma of width tn (bf16 q)."""
    hd: int
    bq: int
    bkv: int
    tm: int
    tn: int
    kind: str = "simt"
    dtypes: Tuple[torch.dtype, ...] = DTYPES
    kv: Tuple[str, ...] = ("native", "quantized")

    @property
    def smem_bytes(self) -> int:
        tile = 2 * self.hd * self.bq        # bf16 q, or a bf16 K or V tile
        if self.kind == "wgmma" and self.kv == ("native",):
            # alignment, q and a 2-stage K/V ring, a q barrier, full/empty
            # per stage
            return 1024 + tile * (1 + 2 * WGMMA_STAGES) + (1 + 2 * WGMMA_STAGES) * 8
        if self.kind == "wgmma":
            # alignment, q, the converted K/V tiles of each buffer, one
            # stage of K/V codes, each buffer's K and V row scales, the q,
            # full and empty barriers
            codes = self.hd * self.bkv
            return (1024 + tile * (1 + 2 * WGMMA_QUANT_BUFS) + 2 * codes
                    + WGMMA_QUANT_BUFS * 2 * 4 * self.bkv + 3 * 8)
        q = self.hd * (self.bq + 1)
        k = self.hd * (self.bkv + 1)
        v = self.bkv * self.hd
        p = self.bkv * (self.bq + 1)
        return 4 * (q + k + v + p)

    def menu_fields(self) -> Tuple[int, ...]:
        """The entry as ``flash_attention_tile`` describes it."""
        return (KINDS.index(self.kind), dtype_mask(self.dtypes), self.hd,
                self.bq, self.bkv, self.tm, self.tn,
                sum(1 << KV_STORAGE.index(k) for k in self.kv),
                self.smem_bytes)


KV_STORAGE = ("native", "quantized")   # the menu's K/V mask: bits 1, 2
WGMMA_STAGES = 2      # csrc/flash_attention.cu::FlashWgmma::stages
WGMMA_QUANT_BUFS = 2  # csrc/flash_attention.cu::FlashWgmmaQuant::bufs
# Index i is tile i of csrc/flash_attention.cu (checked when it loads).
TILES = (AttnTile(32, 64, 64, 4, 4),
         AttnTile(32, 128, 128, 8, 8),
         AttnTile(64, 64, 64, 4, 4),
         AttnTile(64, 128, 128, 8, 8),
         AttnTile(128, 64, 64, 4, 4),
         AttnTile(128, 128, 64, 8, 4),
         AttnTile(128, 128, 128, 64, 128, "wgmma", (torch.bfloat16,),
                  ("native",)),
         AttnTile(128, 128, 128, 64, 128, "wgmma", (torch.bfloat16,),
                  ("quantized",)))

launches = 0
launches_by_kind: Dict[str, int] = {"simt": 0, "wgmma": 0}
launches_quantized = 0
launches_quantized_by_kind: Dict[str, int] = {"simt": 0, "wgmma": 0}
_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("flash_attention")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_fwd.argtypes = ([ptr] * 6 + [i32] * 8
                                            + [ctypes.c_float, i32, ptr])
        lib.flash_attention_fwd.restype = i32
        lib.flash_attention_tile.argtypes = [i32, ctypes.POINTER(i32)]
        lib.flash_attention_tile.restype = i32
        build.check_menu(lib.flash_attention_tile, TILES, "flash_attention")
        _lib = lib
    return _lib


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """Plain version (the reference's ``attention_ref``): fp32 scores
    times hd**-0.5, masked to -1e30, softmax, p cast to V's dtype, an
    fp32 P.V product, cast to q's dtype."""
    S, hd = q.shape[2], q.shape[3]
    groups = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(groups, dim=1)
    v = v.repeat_interleave(groups, dim=1)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd ** -0.5
    if causal:
        mask = torch.ones((S, k.shape[2]), dtype=torch.bool,
                          device=q.device).tril()
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def flash_attention_quantized_plain(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor, k_scale: torch.Tensor,
                                    v_scale: torch.Tensor,
                                    causal: bool = True) -> torch.Tensor:
    """Plain version of the dequant-fused kernel: K/V dequantized to fp32
    by their row scales, then :func:`flash_attention_plain` (p stays
    fp32, since V is)."""
    kd = k.float() * k_scale[..., None]
    vd = v.float() * v_scale[..., None]
    return flash_attention_plain(q, kd, vd, causal)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           tile: AttnTile, scales=()) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or k.shape[1] == 0 or q.shape[1] % k.shape[1]:
        raise ValueError(f"flash_attention: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    if q.shape[3] != tile.hd:
        raise ValueError(f"flash_attention: head dim {q.shape[3]}, tile "
                         f"{tile}")
    for s in scales:
        if s.shape != k.shape[:3] or s.dtype != torch.float32:
            raise ValueError(f"flash_attention: scale {tuple(s.shape)} "
                             f"{s.dtype}, want {tuple(k.shape[:3])} float32")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: q dtype {q.dtype}; want one of "
                        f"{DTYPES}")
    kv = "quantized" if scales else "native"
    if q.dtype not in tile.dtypes or kv not in tile.kv:
        raise TypeError(f"flash_attention: tile {tile} is not compiled for "
                        f"q {q.dtype} with {kv} K/V")
    if any(t.device != q.device for t in (k, v, *scales)):
        raise ValueError("flash_attention: operands on different devices")


def _launch(q, k, v, ks, vs, kv_kind: int, causal: bool,
            tile: AttnTile) -> torch.Tensor:
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    ops = (q, k, v) + tuple(t for t in (ks, vs) if t is not None)
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("flash_attention: operands must be contiguous")
    B, H, S, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(q.device):
        err = _library().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(ks), ptr(vs),
            o.data_ptr(), int(q.dtype == torch.bfloat16), kv_kind, B, H,
            Hkv, S, Sk, int(causal), hd ** -0.5, TILES.index(tile),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: launch failed with CUDA error "
                           f"{err} (q{tuple(q.shape)} k{tuple(k.shape)} "
                           f"{k.dtype}, tile={tile})")
    global launches, launches_quantized
    if kv_kind:
        launches_quantized += 1
        launches_quantized_by_kind[tile.kind] += 1
    else:
        launches += 1
        launches_by_kind[tile.kind] += 1
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, tile: AttnTile) -> torch.Tensor:
    """Attention through the Hopper kernel with ``tile`` (one of
    :data:`TILES`, of q's head dim; the plain version ignores it).  K/V
    in q's dtype.  Ragged S and Sk are masked in the kernel: no
    padding."""
    _check(q, k, v, tile)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes q {q.dtype}, k {k.dtype},"
                        f" v {v.dtype}; want one dtype")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    return _launch(q, k, v, None, None, 0, causal, tile)


def flash_attention_quantized(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, k_scale: torch.Tensor,
                              v_scale: torch.Tensor, causal: bool,
                              tile: AttnTile) -> torch.Tensor:
    """Dequant-fused attention: ``k``/``v`` int8 or float8_e4m3fn
    [B, Hkv, Sk, hd] with fp32 row scales [B, Hkv, Sk]; q stays in the
    compute dtype.  K/V cross device memory at their stored width and
    are dequantized on chip."""
    _check(q, k, v, tile, (k_scale, v_scale))
    if k.dtype not in KV_KINDS or v.dtype != k.dtype:
        raise TypeError(f"flash_attention_quantized: K/V dtypes {k.dtype}, "
                        f"{v.dtype}; want one of {tuple(KV_KINDS)}")
    if q.device.type == "cpu":
        return flash_attention_quantized_plain(q, k, v, k_scale, v_scale,
                                               causal)
    return _launch(q, k, v, k_scale, v_scale, KV_KINDS[k.dtype], causal, tile)
