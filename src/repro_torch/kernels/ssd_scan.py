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
"""
from __future__ import annotations

import ctypes
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
_lib = None


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
