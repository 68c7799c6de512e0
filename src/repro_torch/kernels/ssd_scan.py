"""ssd_chunk: the intra-chunk part of Mamba2's SSD scan as one
hand-written Hopper kernel.

Replaces ``src/repro/kernels/ssd_scan.py::ssd_chunk`` (Pallas, body
``_ssd_chunk_kernel``).  The CUDA source, ``csrc/ssd_chunk.cu``, says how
a chunk is split over thread blocks and what bounds the kernel on the
H100 (at the prefill path's shape: bytes).  It has two kinds: ``simt``
(fp32 FMA; every fp32 call) and ``wgmma`` (bf16 x, B, C on the tensor
cores, the fp32 weights split into two bf16 halves);
``kernels/ops.py::ssd_kind`` routes a call.

* :func:`ssd_chunk` is the wrapper.  For CPU tensors it computes the
  plain version; for CUDA tensors it launches the kernel of the kind
  asked for, or raises.  It adds one to :data:`launches` and to the
  kind's count in :data:`launches_by_kind` per launch.
* :func:`ssd_chunk_plain` is the plain PyTorch version, with the
  reference's signature (B and C broadcast to [BH, S, N]) and its cast
  points: every input to fp32, cum = cumsum(-dt * A), the exponent masked
  to -inf above the diagonal before ``exp``.

Layouts are the reference's: x [BH, S, P]; dt [BH, S]; A [BH]; B, C
[BH, S, N] or, shared by the heads of a batch row, [BH / heads, S, N]
(block b*h reads row bh // heads, so no broadcast copy is made on the
card).  Outputs y_diag [BH, S, P] and states [BH, S / chunk, N, P], both
fp32.  The chunk length is any divisor of S from 1 to :data:`MAX_CHUNK`.

The gradient: :class:`SsdChunk` is the ``torch.autograd.Function`` the
model calls (``kernels/ops.py::ssd_intra_chunk``).  It saves x, dt, A, B
and C only, and the forward's kind; its backward is :func:`ssd_chunk_bwd`
of that kind, the hand-written kernel of ``csrc/ssd_chunk_bwd.cu`` on the
card (one launch, counted in :data:`launches_bwd` and
:data:`launches_bwd_by_kind`: ``simt`` for fp32, ``wgmma`` on the tensor
cores for the bf16 calls the forward's wgmma kind takes) and
:func:`ssd_chunk_bwd_plain`, the explicit formulas in fp32, on the CPU.
The kernel recomputes cum and L from dt and A, as the forward's kind
does.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.cache_matmul import DTYPES

MAX_CHUNK = 256          # longest chunk the kernel's cum stripe holds
HEAD_DIMS = (16, 32, 64)   # head dims P the source compiles (simt)
WGMMA_HEAD_DIMS = (32, 64)   # head dims P of the wgmma kind (bf16)
MAX_WGMMA_STATE = 256    # the wgmma kind's largest N (a multiple of 16)
BQ = BKV = BN = 64       # y rows, column / reduction rows, state rows a block
KINDS = ("simt", "wgmma")
_KIND_IDS = {"simt": 0, "wgmma": 2}   # the C entry point's kind

launches = 0
launches_by_kind: Dict[str, int] = {k: 0 for k in KINDS}
launches_bwd = 0
launches_bwd_by_kind: Dict[str, int] = {k: 0 for k in KINDS}
_lib = None
_bwd_lib = None
BWD_TILE = 64            # rows and columns of the backward's tiles
BWD_HEAD_GROUP = 4       # heads a wgmma backward block sums dB and dC over


def smem_bytes(n: int, p: int, kind: str = "simt") -> int:
    """Shared memory of one launch of ``kind`` at state size ``n`` and
    head dim ``p`` (``csrc/ssd_chunk.cu::smem_bytes`` and
    ``wgmma_smem_bytes``, checked when it loads).  simt: the cum and dt
    stripes plus the larger of the y and state blocks' tiles, fp32.
    wgmma: 1024 bytes of alignment, the two stripes and the larger
    role's bf16 tiles in 64-row boxes of 128 bytes a row (C, B and x; or
    the hi and lo weighted B and x)."""
    if kind == "wgmma":
        boxes = -(-n // 64)
        return 1024 + 4 * 2 * MAX_CHUNK + max(2 * boxes + 1, 3) * BQ * 128
    y = n * (BQ + 1) + n * (BKV + 1) + BKV * p + BKV * (BQ + 1)
    state = BKV * BN + BKV * p
    return 4 * (2 * MAX_CHUNK + max(y, state))


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("ssd_chunk")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ssd_chunk_fwd.argtypes = [ptr] * 7 + [i32] * 8 + [ptr]
        lib.ssd_chunk_fwd.restype = i32
        lib.ssd_chunk_smem_bytes.argtypes = [i32, i32, i32]
        lib.ssd_chunk_smem_bytes.restype = i32
        for kind in KINDS:
            for n, p in ((128, 64), (16, 32), (8, 16), (256, 64)):
                got = lib.ssd_chunk_smem_bytes(n, p, _KIND_IDS[kind])
                if got != smem_bytes(n, p, kind):
                    raise RuntimeError(
                        f"ssd_chunk: {kind} shared memory at N {n}, P {p} "
                        f"is {got} in the library, "
                        f"{smem_bytes(n, p, kind)} in Python")
        _lib = lib
    return _lib


def ssd_chunk_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor,
                    chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version (the reference kernel's arithmetic, in fp32).
    x [BH, S, P]; dt [BH, S]; A [BH]; B, C [BH, S, N].  Returns (y_diag
    [BH, S, P], states [BH, S // chunk, N, P])."""
    BH, S, P = x.shape
    N = B.shape[-1]
    n_c = S // chunk
    xr = x.reshape(BH, n_c, chunk, P).float()
    dtr = dt.reshape(BH, n_c, chunk).float()
    Br = B.reshape(BH, n_c, chunk, N).float()
    Cr = C.reshape(BH, n_c, chunk, N).float()
    cum = torch.cumsum(-dtr * A.float()[:, None, None], dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    L = torch.exp(torch.where(tri, diff, torch.full_like(diff, -torch.inf)))
    scores = torch.matmul(Cr, Br.transpose(-1, -2))
    w = scores * L * dtr[:, :, None, :]
    y = torch.matmul(w, xr).reshape(BH, S, P)
    decay_out = torch.exp(cum[..., -1:] - cum)
    states = torch.matmul((Br * (decay_out * dtr)[..., None]).transpose(-1, -2),
                          xr)
    return y, states


def wgmma_takes(dtype: torch.dtype, n: int, p: int) -> bool:
    """Whether the wgmma kind runs x, B, C of ``dtype`` with state size
    ``n`` and head dim ``p``: bf16, N a multiple of 16 up to
    :data:`MAX_WGMMA_STATE`, P one of :data:`WGMMA_HEAD_DIMS`."""
    return (dtype == torch.bfloat16 and n % 16 == 0
            and 16 <= n <= MAX_WGMMA_STATE and p in WGMMA_HEAD_DIMS)


def _check(x, dt, A, B, C, chunk: int, kind: str) -> int:
    """Validate shapes, dtypes, devices and the kind; return the heads
    sharing one row of B and C."""
    if x.dim() != 3 or dt.shape != x.shape[:2] or A.shape != x.shape[:1] \
            or B.dim() != 3 or C.shape != B.shape or B.shape[1] != x.shape[1] \
            or B.shape[0] == 0 or x.shape[0] % B.shape[0]:
        raise ValueError(f"ssd_chunk: shapes x{tuple(x.shape)} "
                         f"dt{tuple(dt.shape)} A{tuple(A.shape)} "
                         f"B{tuple(B.shape)} C{tuple(C.shape)}")
    S = x.shape[1]
    if not 1 <= chunk <= MAX_CHUNK or S % chunk:
        raise ValueError(f"ssd_chunk: chunk {chunk} must divide S {S} and "
                         f"lie in [1, {MAX_CHUNK}]")
    if x.dtype not in DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd_chunk: x, B, C dtypes {x.dtype}, {B.dtype}, "
                        f"{C.dtype}; want one of {DTYPES}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_chunk: dt {dt.dtype}, A {A.dtype}; want "
                        "float32")
    if any(t.device != x.device for t in (dt, A, B, C)):
        raise ValueError("ssd_chunk: operands on different devices")
    if kind not in KINDS:
        raise ValueError(f"ssd_chunk: kind {kind!r}; want one of {KINDS}")
    N, P = B.shape[-1], x.shape[-1]
    if kind == "wgmma" and not wgmma_takes(x.dtype, N, P):
        raise TypeError(f"ssd_chunk: the wgmma kind takes bf16 with N a "
                        f"multiple of 16 up to {MAX_WGMMA_STATE} and P in "
                        f"{WGMMA_HEAD_DIMS}; got {x.dtype}, N {N}, P {P}")
    return x.shape[0] // B.shape[0]


def _launch(x, dt, A, B, C, chunk: int, heads: int, kind: str):
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk: unsupported device {x.device}")
    if not all(t.is_contiguous() for t in (x, dt, A, B, C)):
        raise ValueError("ssd_chunk: operands must be contiguous")
    BH, S, P = x.shape
    N = B.shape[-1]
    if P not in HEAD_DIMS:
        raise ValueError(f"ssd_chunk: head dim {P} not compiled (have "
                         f"{HEAD_DIMS})")
    limit = torch.cuda.get_device_properties(
        x.device).shared_memory_per_block_optin
    need = smem_bytes(N, P, kind)
    if need > limit:
        raise ValueError(f"ssd_chunk: N {N}, P {P} needs {need} bytes of "
                         f"shared memory ({kind}), the device {limit}")
    y = torch.empty((BH, S, P), dtype=torch.float32, device=x.device)
    states = torch.empty((BH, S // chunk, N, P), dtype=torch.float32,
                         device=x.device)
    if y.numel() == 0:
        return y, states
    with torch.cuda.device(x.device):
        err = _library().ssd_chunk_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), states.data_ptr(),
            int(x.dtype == torch.bfloat16), BH, S, chunk, N, P, heads,
            _KIND_IDS[kind], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk: launch failed with CUDA error {err} "
                           f"(x{tuple(x.shape)} {x.dtype} B{tuple(B.shape)} "
                           f"chunk {chunk}, {kind})")
    global launches
    launches += 1
    launches_by_kind[kind] += 1
    return y, states


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              B: torch.Tensor, C: torch.Tensor, chunk: int,
              kind: str = "simt") -> Tuple[torch.Tensor, torch.Tensor]:
    """Intra-chunk SSD through the Hopper kernel of ``kind`` (one of
    :data:`KINDS`; ``kernels/ops.py::ssd_kind`` routes the model's
    calls; the plain version ignores it).  x [BH, S, P] (fp32 or bf16);
    dt [BH, S] and A [BH] fp32; B, C [G, S, N] in x's dtype, with G = BH
    (the reference's layout) or G dividing BH (row bh // (BH / G) serves
    head bh).  Returns (y_diag [BH, S, P], states [BH, S // chunk, N,
    P]), fp32."""
    heads = _check(x, dt, A, B, C, chunk, kind)
    if x.device.type == "cpu":
        if heads > 1:
            B = B.repeat_interleave(heads, dim=0)
            C = C.repeat_interleave(heads, dim=0)
        return ssd_chunk_plain(x, dt, A, B, C, chunk)
    return _launch(x, dt, A, B, C, chunk, heads, kind)


# ------------------------------------------------------------ backward --
def bwd_smem_bytes(n: int, p: int, kind: str = "simt") -> int:
    """Shared memory of one backward launch of ``kind`` at state size
    ``n`` and head dim ``p`` (``csrc/ssd_chunk_bwd.cu::bwd_smem_bytes``
    and ``wgmma_bwd_smem_bytes``, checked when it loads).  simt: the cum,
    dt and decay stripes, then the larger of the column block's tiles (B
    and C transposed [n][65], x and gy transposed [p][65], gy [64][p], two
    [64][65] weight tiles) and the dB / dC blocks', fp32.  wgmma: 1024
    bytes of alignment, the three stripes and the reduction rows (4096),
    then 64-row bf16 boxes of 128 bytes a row: B_j (``nb`` boxes, N
    rounded up to whole state slices) and x_j, then the larger of C_i with
    gy_i's hi and lo (nb + 2) and gS's hi and lo (2 nb)."""
    if kind == "wgmma":
        nb = 1 if n <= 64 else 2 * -(-n // 128)
        return 1024 + 4096 + (nb + 1 + max(nb + 2, 2 * nb)) * 64 * 128
    ld = BWD_TILE + 1
    col = 2 * n * ld + 2 * p * ld + BWD_TILE * p + 2 * BWD_TILE * ld
    bc = 2 * p * ld + BWD_TILE * ld + BWD_TILE * BWD_TILE + p * BWD_TILE
    return 4 * (3 * MAX_CHUNK + max(col, bc))


def _bwd_library() -> ctypes.CDLL:
    global _bwd_lib
    if _bwd_lib is None:
        lib = build.load("ssd_chunk_bwd")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ssd_chunk_bwd.argtypes = [ptr] * 13 + [i32] * 9 + [ptr]
        lib.ssd_chunk_bwd.restype = i32
        lib.ssd_chunk_bwd_smem_bytes.argtypes = [i32, i32, i32]
        lib.ssd_chunk_bwd_smem_bytes.restype = i32
        for kind in KINDS:
            for n, p in ((128, 64), (64, 64), (16, 32), (192, 32), (256, 64)):
                got = lib.ssd_chunk_bwd_smem_bytes(n, p, _KIND_IDS[kind])
                if got != bwd_smem_bytes(n, p, kind):
                    raise RuntimeError(
                        f"ssd_chunk_bwd: {kind} shared memory at N {n}, P "
                        f"{p} is {got} in the library, "
                        f"{bwd_smem_bytes(n, p, kind)} in Python")
        _bwd_lib = lib
    return _bwd_lib


def _reverse_cumsum(t: torch.Tensor) -> torch.Tensor:
    return t.flip(-1).cumsum(-1).flip(-1)


def ssd_chunk_bwd_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                        B: torch.Tensor, C: torch.Tensor, chunk: int,
                        gy: torch.Tensor, gS: torch.Tensor):
    """Plain version of the backward: the explicit formulas of
    ``csrc/ssd_chunk_bwd.cu``'s header, in fp32.  x [BH, S, P]; dt
    [BH, S]; A [BH]; B, C [BH, S, N] (the reference's broadcast layout);
    gy [BH, S, P] and gS [BH, S // chunk, N, P], the gradients of y_diag
    and the states.  Returns (dx, ddt, dA, dB, dC), fp32, dB and dC per
    head."""
    BH, S, P = x.shape
    N = B.shape[-1]
    n_c = S // chunk
    xr = x.reshape(BH, n_c, chunk, P).float()
    dtr = dt.reshape(BH, n_c, chunk).float()
    Br = B.reshape(BH, n_c, chunk, N).float()
    Cr = C.reshape(BH, n_c, chunk, N).float()
    gyr = gy.reshape(BH, n_c, chunk, P).float()
    gSr = gS.float()
    a = A.float()[:, None, None]
    cum = torch.cumsum(-dtr * a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    L = torch.exp(torch.where(tri, diff, torch.full_like(diff, -torch.inf)))
    e = torch.exp(cum[..., -1:] - cum)                        # [BH,c,Q]
    ed = e * dtr
    CL = torch.matmul(Cr, Br.transpose(-1, -2)) * L           # [..,i,j]
    G = torch.matmul(gyr, xr.transpose(-1, -2))               # [..,i,j]
    dtj = dtr[..., None, :]
    W = G * L * dtj
    u = torch.matmul(Br, gSr)                                 # B_j gS [..,Q,P]
    v = torch.matmul(xr, gSr.transpose(-1, -2))               # gS x_j [..,Q,N]
    s = (u * xr).sum(-1)                                      # B_j^T gS x_j
    dx = torch.matmul((CL * dtj).transpose(-1, -2), gyr) + ed[..., None] * u
    dC = torch.matmul(W, Br)
    dB = torch.matmul(W.transpose(-1, -2), Cr) + ed[..., None] * v
    T = G * CL
    R = T * dtj
    sterm = ed * s
    dcum = R.sum(-1) - R.sum(-2) - sterm
    dcum[..., -1] += sterm.sum(-1)
    rc = _reverse_cumsum(dcum)
    ddt = T.sum(-2) + e * s - a * rc
    dA = -(dtr * rc).sum((1, 2))
    return (dx.reshape(BH, S, P), ddt.reshape(BH, S), dA,
            dB.reshape(BH, S, N), dC.reshape(BH, S, N))


def bwd_head_group(heads: int, kind: str) -> int:
    """Heads one backward block sums dB and dC over, in head order: 1 for
    simt (per-head slabs), the largest divisor of ``heads`` up to
    :data:`BWD_HEAD_GROUP` for wgmma."""
    return math.gcd(heads, BWD_HEAD_GROUP) if kind == "wgmma" else 1


def _launch_bwd(x, dt, A, B, C, chunk: int, heads: int, gy, gS, kind: str):
    """The backward kernel of ``kind``, then the fixed-order torch pass of
    its header: dcum summed over the column tiles and the states' term
    added at each chunk's last position, the reverse cumsum, ddt's -A rc
    term and dA.  dB and dC come back summed over groups of
    :func:`bwd_head_group` heads, [BH / group, S, N]."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk_bwd: unsupported device {x.device}")
    BH, S, P = x.shape
    N = B.shape[-1]
    if P not in HEAD_DIMS:
        raise ValueError(f"ssd_chunk_bwd: head dim {P} not compiled (have "
                         f"{HEAD_DIMS})")
    limit = torch.cuda.get_device_properties(
        x.device).shared_memory_per_block_optin
    need = bwd_smem_bytes(N, P, kind)
    if need > limit:
        raise ValueError(f"ssd_chunk_bwd: N {N}, P {P} needs {need} bytes "
                         f"of shared memory ({kind}), the device {limit}")
    group = bwd_head_group(heads, kind)
    n_c, n_t = S // chunk, -(-chunk // BWD_TILE)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((BH, S, P), **f32)
    ddt = torch.empty((BH, S), **f32)
    dcum = torch.empty((BH, n_c, 2, chunk), **f32)
    rowpart = torch.zeros((BH, n_t, S), **f32)
    dB = torch.empty((BH // group, S, N), **f32)
    dC = torch.empty((BH // group, S, N), **f32)
    if dx.numel() == 0:
        return dx, ddt, torch.zeros((BH,), **f32), dB, dC
    with torch.cuda.device(x.device):
        err = _bwd_library().ssd_chunk_bwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), gy.data_ptr(), gS.data_ptr(), dx.data_ptr(),
            ddt.data_ptr(), dcum.data_ptr(), rowpart.data_ptr(),
            dB.data_ptr(), dC.data_ptr(), int(x.dtype == torch.bfloat16),
            BH, S, chunk, N, P, heads, _KIND_IDS[kind], group,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk_bwd: launch failed with CUDA error "
                           f"{err} (x{tuple(x.shape)} {x.dtype} "
                           f"B{tuple(B.shape)} chunk {chunk}, {kind})")
    global launches_bwd
    launches_bwd += 1
    launches_bwd_by_kind[kind] += 1
    total = rowpart.sum(1).reshape(BH, n_c, chunk) + dcum[:, :, 0]
    total[..., -1] += dcum[:, :, 1].sum(-1)
    rc = _reverse_cumsum(total)
    ddt = ddt.reshape(BH, n_c, chunk) - A[:, None, None] * rc
    dA = -(dt.reshape(BH, n_c, chunk) * rc).sum((1, 2))
    return dx, ddt.reshape(BH, S), dA, dB, dC


def ssd_chunk_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, chunk: int,
                  gy: torch.Tensor, gS: torch.Tensor, kind: str = "simt"):
    """The gradient of :func:`ssd_chunk` through the Hopper backward
    kernel of ``kind`` (``csrc/ssd_chunk_bwd.cu``; :func:`wgmma_takes`
    decides which calls the ``wgmma`` kind takes, as for the forward; the
    plain version ignores it).  Operands as :func:`ssd_chunk`'s (B, C
    [G, S, N], G dividing BH), gy [BH, S, P] and gS [BH, S // chunk, N,
    P] the gradients of its outputs.  Returns (dx, ddt, dA, dB, dC),
    fp32, dB and dC in B's layout [G, S, N]: the per-head (simt) or
    per-group (wgmma, summed in the kernel) partials summed over the
    heads that share a row, in head order.  For CPU tensors it computes
    :func:`ssd_chunk_bwd_plain`; for CUDA tensors it launches the kernel
    or raises."""
    heads = _check(x, dt, A, B, C, chunk, kind)
    BH, S, P = x.shape
    N = B.shape[-1]
    if gy.shape != x.shape or gS.shape != (BH, S // chunk, N, P) \
            or gy.dtype != torch.float32 or gS.dtype != torch.float32 \
            or gy.device != x.device or gS.device != x.device:
        raise ValueError(f"ssd_chunk_bwd: gradients gy{tuple(gy.shape)} "
                         f"{gy.dtype}, gS{tuple(gS.shape)} {gS.dtype}")
    if x.device.type == "cpu":
        Bb = B.repeat_interleave(heads, dim=0) if heads > 1 else B
        Cb = C.repeat_interleave(heads, dim=0) if heads > 1 else C
        dx, ddt, dA, dB, dC = ssd_chunk_bwd_plain(x, dt, A, Bb, Cb, chunk,
                                                  gy, gS)
    else:
        if not all(t.is_contiguous() for t in (x, dt, A, B, C, gy, gS)):
            raise ValueError("ssd_chunk_bwd: operands must be contiguous")
        dx, ddt, dA, dB, dC = _launch_bwd(x, dt, A, B, C, chunk, heads,
                                          gy, gS, kind)
    G = B.shape[0]
    parts = dB.shape[0] // G
    return (dx, ddt, dA, dB.reshape(G, parts, S, N).sum(1),
            dC.reshape(G, parts, S, N).sum(1))


class SsdChunk(torch.autograd.Function):
    """:func:`ssd_chunk` with a gradient.  The forward launches the kernel
    of ``kind`` (or the plain version, on the CPU) and saves only x, dt,
    A, B and C, and the kind; the backward is :func:`ssd_chunk_bwd` of the
    same kind and returns each gradient in its input's dtype.  Both are
    looked up in this module at call time, so a control run may put the
    plain versions in their place."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk: int, kind: str):
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk, ctx.kind = chunk, kind
        return ssd_chunk(x, dt, A, B, C, chunk, kind=kind)

    @staticmethod
    def backward(ctx, gy, gS):
        x, dt, A, B, C = ctx.saved_tensors
        dx, ddt, dA, dB, dC = ssd_chunk_bwd(
            x, dt, A, B, C, ctx.chunk, gy.float().contiguous(),
            gS.float().contiguous(), kind=ctx.kind)
        return (dx.to(x.dtype), ddt.to(dt.dtype), dA.to(A.dtype),
                dB.to(B.dtype), dC.to(C.dtype), None, None)
