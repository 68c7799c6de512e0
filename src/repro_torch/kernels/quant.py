"""Shared symmetric quantization helpers (port of
src/repro/kernels/quant.py, the whole module).

One module owns every quantize/dequantize of the port: the per-tensor
int8 pair; the per-row KV quantization (one fp32 scale per token row
per KV head, so a row's scale depends only on that row) that the
dequant-fused flash attention kernel and the quantized KV caches of
``models/attention.py::mha`` use; and the per-column weight
quantization whose codes and scales ``kernels/ops.py::planned_ffn_quant``
streams through the cache_matmul_quant kernel.

All quantization here is symmetric (no zero point): ``q = round(x / s)``
with ``s = amax / qmax`` and the ``amax == 0`` guard mapping all-zero
inputs to scale 1.0, so dequantization is exact on zeros.  ``qmax`` is
127 for int8 and 448 for float8_e4m3 (finfo max).  Values are clamped
to ``[-qmax, qmax]`` before the cast; ``torch.round`` rounds half to
even, as ``jnp.round`` does, and the cast to float8_e4m3fn rounds to
nearest even, as JAX's does.
"""
from __future__ import annotations

from typing import Tuple

import torch

# kv_dtype plan axis values.  "native" means the cache keeps the model
# compute dtype (bf16 at full width, fp32 in the reduced configs).
KV_DTYPES: Tuple[str, ...] = ("native", "fp8_e4m3", "int8")

# name -> (storage dtype, symmetric quantization range max)
_QUANT_SPECS = {
    "int8": (torch.int8, 127.0),
    "fp8_e4m3": (torch.float8_e4m3fn, 448.0),
}


def is_quantized(kv_dtype: str) -> bool:
    return kv_dtype in _QUANT_SPECS


def kv_storage_dtype(kv_dtype: str) -> torch.dtype:
    """torch dtype a quantized KV cache stores K/V in."""
    return _QUANT_SPECS[kv_dtype][0]


def kv_qmax(kv_dtype: str) -> float:
    return _QUANT_SPECS[kv_dtype][1]


def kv_dtype_of(dtype: torch.dtype) -> str:
    """kv_dtype name for a storage dtype (inverse of
    :func:`kv_storage_dtype`); raises on non-quantized dtypes."""
    for name, (dt, _) in _QUANT_SPECS.items():
        if dtype == dt:
            return name
    raise ValueError(f"{dtype} is not a quantized KV storage dtype")


def _scale(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    return torch.where(amax > 0, amax / qmax, torch.ones_like(amax))


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns (q, scale)."""
    scale = _scale(x.float().abs().amax(), 127.0)
    q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _quantize(x: torch.Tensor, scale: torch.Tensor,
              kv_dtype: str) -> torch.Tensor:
    dt, qmax = _QUANT_SPECS[kv_dtype]
    y = x.float() / scale
    if dt == torch.int8:
        y = torch.round(y)
    return torch.clamp(y, -qmax, qmax).to(dt)


def quantize_rows(x: torch.Tensor, kv_dtype: str
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric quantization with one scale per trailing-dim row.

    Returns ``(q, scale)`` with ``q.shape == x.shape`` in the storage
    dtype and ``scale.shape == x.shape[:-1] + (1,)`` in fp32.  For K/V
    shaped ``[B, Hkv, S, hd]`` this is one scale per (batch, kv-head,
    token) row.
    """
    scale = _scale(x.float().abs().amax(dim=-1, keepdim=True),
                   _QUANT_SPECS[kv_dtype][1])
    return _quantize(x, scale, kv_dtype), scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_rows` (scale broadcasts over the row)."""
    return (q.float() * scale).to(dtype)


def quantize_cols(w: torch.Tensor, kv_dtype: str = "int8"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-column symmetric quantization for a ``[K, N]`` weight.

    Returns ``(q, scale)`` with ``scale.shape == (1, N)``, the layout a
    dequant-fused matmul streams beside each N-tile.
    """
    scale = _scale(w.float().abs().amax(dim=0, keepdim=True),
                   _QUANT_SPECS[kv_dtype][1])
    return _quantize(w, scale, kv_dtype), scale
