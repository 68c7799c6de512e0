"""Peaks of the card and the bytes of a gemv launch, from shapes alone.
A model's operations are its family's (``families/<family>.py``,
``span_flops``).

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the full 700 W power
limit (a card set lower runs slower under load; every run prints its
limit beside its numbers).
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12      # dense bf16 / fp16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12     # HBM3 bandwidth


def gemv_bytes(m: int, k: int, n: int, elem: int = 2) -> int:
    """One ``cache_matmul`` of A [m, k] by B [k, n] into C [m, n]: each
    input byte read once, each output byte written once (the split-K
    partial sums the kernel keeps in fp32 scratch are not counted)."""
    return elem * (k * n + m * k + m * n)
