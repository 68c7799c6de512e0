"""ssd_chunk: the intra-chunk part of Mamba2's SSD scan as one
hand-written Hopper kernel.

Replaces ``src/repro/kernels/ssd_scan.py::ssd_chunk`` (Pallas, body
``_ssd_chunk_kernel``).  The CUDA source, ``csrc/ssd_chunk.cu``, says how
a chunk is split over thread blocks and what bounds the kernel on the
H100 (at the prefill path's shape: bytes).

* :func:`ssd_chunk` is the wrapper.  For CPU tensors it computes the
  plain version; for CUDA tensors it launches the kernel, or raises.  It
  adds one to :data:`launches` per launch.
* :func:`ssd_chunk_plain` is the plain PyTorch version, with the
  reference's signature (B and C broadcast to [BH, S, N]) and its cast
  points: every input to fp32, cum = cumsum(-dt * A), the exponent masked
  to -inf above the diagonal before ``exp``.

Layouts are the reference's: x [BH, S, P]; dt [BH, S]; A [BH]; B, C
[BH, S, N] or, shared by the heads of a batch row, [BH / heads, S, N]
(block b*h reads row bh // heads, so no broadcast copy is made on the
card).  Outputs y_diag [BH, S, P] and states [BH, S / chunk, N, P], both
fp32.  The chunk length is any divisor of S from 1 to :data:`MAX_CHUNK`.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.cache_matmul import DTYPES

MAX_CHUNK = 256          # longest chunk the kernel's cum stripe holds
HEAD_DIMS = (16, 32, 64)   # head dims P the source compiles
BQ = BKV = BN = 64       # y rows, column / reduction rows, state rows a block

launches = 0
_lib = None


def smem_bytes(n: int, p: int) -> int:
    """Shared memory of one launch at state size ``n`` and head dim
    ``p`` (``csrc/ssd_chunk.cu::smem_bytes``, checked when it loads): the
    cum and dt stripes plus the larger of the y and state blocks'
    tiles, fp32."""
    y = n * (BQ + 1) + n * (BKV + 1) + BKV * p + BKV * (BQ + 1)
    state = BKV * BN + BKV * p
    return 4 * (2 * MAX_CHUNK + max(y, state))


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load("ssd_chunk")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ssd_chunk_fwd.argtypes = [ptr] * 7 + [i32] * 7 + [ptr]
        lib.ssd_chunk_fwd.restype = i32
        lib.ssd_chunk_smem_bytes.argtypes = [i32, i32]
        lib.ssd_chunk_smem_bytes.restype = i32
        for n, p in ((128, 64), (16, 32), (8, 16)):
            if lib.ssd_chunk_smem_bytes(n, p) != smem_bytes(n, p):
                raise RuntimeError(
                    f"ssd_chunk: shared memory at N {n}, P {p} is "
                    f"{lib.ssd_chunk_smem_bytes(n, p)} in the library, "
                    f"{smem_bytes(n, p)} in Python")
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


def _check(x, dt, A, B, C, chunk: int) -> int:
    """Validate shapes, dtypes and devices; return the heads sharing one
    row of B and C."""
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
    return x.shape[0] // B.shape[0]


def _launch(x, dt, A, B, C, chunk: int, heads: int):
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
    if smem_bytes(N, P) > limit:
        raise ValueError(f"ssd_chunk: N {N}, P {P} needs {smem_bytes(N, P)} "
                         f"bytes of shared memory, the device {limit}")
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
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk: launch failed with CUDA error {err} "
                           f"(x{tuple(x.shape)} {x.dtype} B{tuple(B.shape)} "
                           f"chunk {chunk})")
    global launches
    launches += 1
    return y, states


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              B: torch.Tensor, C: torch.Tensor,
              chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Intra-chunk SSD through the Hopper kernel.  x [BH, S, P] (fp32 or
    bf16); dt [BH, S] and A [BH] fp32; B, C [G, S, N] in x's dtype, with
    G = BH (the reference's layout) or G dividing BH (row bh // (BH / G)
    serves head bh).  Returns (y_diag [BH, S, P], states
    [BH, S // chunk, N, P]), fp32."""
    heads = _check(x, dt, A, B, C, chunk)
    if x.device.type == "cpu":
        if heads > 1:
            B = B.repeat_interleave(heads, dim=0)
            C = C.repeat_interleave(heads, dim=0)
        return ssd_chunk_plain(x, dt, A, B, C, chunk)
    return _launch(x, dt, A, B, C, chunk, heads)
