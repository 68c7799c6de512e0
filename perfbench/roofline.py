"""Peaks of the card and the operations and bytes of the work the cells
run, from shapes alone.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the full 700 W power
limit (a card set lower runs slower under load; every run prints its
limit beside its numbers).
"""
from __future__ import annotations

from typing import Any, Dict

PEAK_BF16_FLOPS = 989e12      # dense bf16 / fp16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12     # HBM3 bandwidth


def head_dim(arch: Dict[str, Any]) -> int:
    return arch.get("head_dim") or arch["d_model"] // arch["num_heads"]


def gemv_bytes(m: int, k: int, n: int, elem: int = 2) -> int:
    """One ``cache_matmul`` of A [m, k] by B [k, n] into C [m, n]: each
    input byte read once, each output byte written once (the split-K
    partial sums the kernel keeps in fp32 scratch are not counted)."""
    return elem * (k * n + m * k + m * n)


def matmul_flops_per_token(arch: Dict[str, Any]) -> int:
    """Multiply-add operations (x2) of one token's projections, FFN or
    routed experts and router, in every layer, and its logits."""
    d, L = arch["d_model"], arch["num_layers"]
    hd = head_dim(arch)
    q, kv = arch["num_heads"] * hd, arch["num_kv_heads"] * hd
    attn = d * q + 2 * d * kv + q * d
    f = arch["d_ff"]
    if arch.get("num_experts"):
        ffn = arch["experts_per_token"] * 3 * d * f + d * arch["num_experts"]
    else:
        ffn = 3 * d * f
    return 2 * (L * (attn + ffn) + d * arch["vocab_size"])


def span_flops(arch: Dict[str, Any], start: int, stop: int) -> int:
    """One row's model operations for the tokens at positions
    [start, stop), each attending causally over itself and every earlier
    position."""
    if stop <= start:
        return 0
    n = stop - start
    ctx_sum = (start + 1 + stop) * n // 2          # sum of p + 1 over the span
    return (n * matmul_flops_per_token(arch)
            + 4 * arch["num_layers"] * arch["num_heads"] * head_dim(arch)
            * ctx_sum)
