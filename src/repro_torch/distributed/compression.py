"""Gradient compression for a slow cross-node axis: int8 quantization with
error feedback (port of src/repro/distributed/compression.py:
``init_error_state`` :27, ``compress_grads`` :32, ``compressed_bytes``
:52).

Nodes reduce locally at full precision and exchange int8-compressed
gradients across the slow axis; the residual (grad - reconstruction) is
carried into the next step's gradient before compression (error
feedback), which keeps the quantization bias out of the optimizer's
trajectory.  Pure tree transforms over the port's param trees, on the
port's symmetric per-tensor int8 pair (``kernels/quant.py``).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.kernels.quant import dequantize_int8, quantize_int8  # noqa: F401
from repro_torch.optim.adamw import tree_leaves, tree_map


def init_error_state(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_grads(grads: Any, error: Any) -> Tuple[Any, Any]:
    """Returns (compressed-and-reconstructed grads, new error residual).

    The reconstruction is what crosses the slow axis; the residual
    (grad - reconstruction) is added to next step's gradient before
    compression (error feedback / EF-SGD)."""
    def one(g, e):
        g32 = g.float() + e
        q, s = quantize_int8(g32)
        rec = dequantize_int8(q, s)
        return rec, g32 - rec

    pairs = tree_map(one, grads, error)
    rec = tree_map(lambda g, p: p[0], grads, pairs)
    new_err = tree_map(lambda g, p: p[1], grads, pairs)
    return rec, new_err


def compressed_bytes(params: Any) -> Tuple[int, int]:
    """(raw fp32 bytes, int8+scale bytes) crossing the slow axis a step."""
    leaves = tree_leaves(params)
    raw = sum(leaf.numel() * 4 for leaf in leaves)
    comp = sum(leaf.numel() * 1 + 4 for leaf in leaves)
    return raw, comp
