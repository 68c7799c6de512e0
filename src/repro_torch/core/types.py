# Verbatim copy of src/repro/core/types.py (the JAX package's framework-free
# scheduling code); only the package name in imports differs.
"""Shared datatypes for the CaMDN core.

The unit of scheduling in CaMDN is a *layer* of a DNN model.  For the
mapper (Section III-C of the paper) every layer is normalized to one or
more GEMM-shaped operands (im2col for convolutions, per-gate GEMMs for
LSTM cells, per-projection GEMMs for attention), because the NPU in the
paper (Gemmini-class, 32x32 systolic PE array) executes GEMM tiles.

All sizes are in *bytes* unless suffixed otherwise.  The element size is
configurable per model (the paper's NPU is int8-centric; transformers in
the zoo use bf16).
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Dict, List, Optional, Sequence, Tuple


class LayerKind(enum.Enum):
    GEMM = "gemm"          # plain matmul (FC / projection / conv-as-im2col)
    DWCONV = "dwconv"      # depthwise conv: per-channel small GEMMs, memory-bound
    ATTN = "attn"          # attention score+value GEMM pair (seq-dependent)
    LSTM = "lstm"          # recurrent cell: per-timestep gate GEMMs, weight-reuse heavy
    ELEMENTWISE = "eltwise"  # activation / norm / residual: pure streaming


@dataclasses.dataclass(frozen=True)
class GemmDims:
    """A single GEMM: C[M,N] += A[M,K] @ B[K,N].

    ``reps`` repeats the same GEMM (e.g. timesteps of an LSTM, heads of an
    attention layer, channels of a depthwise conv) with ``b_reused``
    indicating whether the B operand (weights) is identical across reps.
    """
    M: int
    N: int
    K: int
    reps: int = 1
    b_reused: bool = True  # B identical across reps (weights); False for attn scores

    @property
    def flops(self) -> int:
        return 2 * self.M * self.N * self.K * self.reps

    @property
    def a_bytes_one(self) -> int:
        return self.M * self.K

    @property
    def b_bytes_one(self) -> int:
        return self.K * self.N

    @property
    def c_bytes_one(self) -> int:
        return self.M * self.N


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One schedulable layer.

    ``input_bytes`` / ``output_bytes`` are the *inter-layer* activation
    tensors (the ones LBM can keep cache-resident).  ``weight_bytes`` is
    the parameter footprint streamed from DRAM.  ``gemms`` describe the
    compute for the mapper; elementwise layers have no GEMMs.
    """
    name: str
    kind: LayerKind
    gemms: Tuple[GemmDims, ...]
    input_bytes: int
    output_bytes: int
    weight_bytes: int
    elem_bytes: int = 1  # bytes per element (1 = int8 NPU, 2 = bf16)

    @property
    def flops(self) -> int:
        if self.kind == LayerKind.ELEMENTWISE:
            # ~1 op per byte moved
            return self.input_bytes + self.output_bytes
        return sum(g.flops for g in self.gemms)

    @property
    def compulsory_dram_bytes(self) -> int:
        """Lower bound: every distinct tensor moved exactly once."""
        return self.input_bytes + self.output_bytes + self.weight_bytes


@dataclasses.dataclass
class ModelGraph:
    """A linear layer graph (sufficient for the paper's benchmarks: all
    eight models are sequential at the granularity the scheduler sees;
    residual edges are folded into layer input/output footprints)."""
    name: str
    layers: List[LayerSpec]
    qos_ms: float = 0.0  # latency target (Table I)

    @property
    def total_flops(self) -> int:
        return sum(l.flops for l in self.layers)

    @property
    def total_weight_bytes(self) -> int:
        return sum(l.weight_bytes for l in self.layers)


# Byte width per element, by dtype name.  Single source of truth for
# every capacity/traffic computation (serve working sets, KV page
# reservations, roofline byte counts).  Deliberately NOT a .get() with a
# default: an unknown dtype silently priced at 4 bytes once under-counted
# bf16 working sets by 2x, so unknown names fail loud instead.
_ELEM_BYTES = {
    "float64": 8,
    "float32": 4,
    "int32": 4,
    "bfloat16": 2,
    "float16": 2,
    "int8": 1,
    "uint8": 1,
    "fp8_e4m3": 1,
    "float8_e4m3fn": 1,
    "fp8_e5m2": 1,
    "float8_e5m2": 1,
}


def elem_bytes(dtype: str) -> int:
    """Bytes per element for a dtype name; raises on unknown dtypes."""
    try:
        return _ELEM_BYTES[dtype]
    except KeyError:
        raise ValueError(
            f"elem_bytes: unknown dtype {dtype!r} (known: "
            f"{sorted(_ELEM_BYTES)}); refusing to guess a byte width"
        ) from None


def align_up(x: int, a: int) -> int:
    return ((x + a - 1) // a) * a


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)
