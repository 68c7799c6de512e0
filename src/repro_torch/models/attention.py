"""GQA self-attention with RoPE, causal / sliding-window masks, native
and quantized (int8 / fp8_e4m3) KV caches and the plan-lowered flash
path (port of src/repro/models/attention.py, the paths the dense slices
use).

Plain PyTorch, as the reference's attention is plain ``jnp``, except
under an attention plan: cache-free causal self-attention then runs
through the flash-attention kernel with the plan's blocks and KV
precision (``kernels/ops.py::attention``).  A quantized cache stores
per-row codes and fp32 scales; the cached path dequantizes the live
window in plain ops, as the reference's does.  Not yet ported, and
raising ``NotImplementedError`` rather than computing something else:
cross-attention.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels import quant as kquant
from repro_torch.models.base import ArchConfig
from repro_torch.models.layers import Params, apply_rope, init_linear, linear

NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg: ArchConfig) -> Params:
    d, hd, dt = cfg.d_model, cfg.hd, cfg.torch_dtype
    return {
        "wq": init_linear(gen, d, cfg.num_heads * hd, dt),
        "wk": init_linear(gen, d, cfg.num_kv_heads * hd, dt),
        "wv": init_linear(gen, d, cfg.num_kv_heads * hd, dt),
        "wo": init_linear(gen, cfg.num_heads * hd, d, dt),
    }


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n, hd))


def _mask_bias(q_len: int, kv_len: int, causal: bool, window: int,
               q_offset: Any = 0,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """[q_len, kv_len] additive bias; q_offset = absolute pos of query 0
    (a host int or a device int64 scalar)."""
    qpos = torch.arange(q_len, device=device)[:, None] + q_offset
    kpos = torch.arange(kv_len, device=device)[None, :]
    ok = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= kpos > qpos - window
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def _write_rows(buf: torch.Tensor, pos: torch.Tensor,
                rows: torch.Tensor) -> None:
    """``buf[:, pos] = rows`` at device positions.  ``index_copy_`` has no
    float8 kernel, so 1-byte float codes are copied through a uint8 view
    (the same bytes)."""
    if buf.is_floating_point() and buf.element_size() == 1:
        buf, rows = buf.view(torch.uint8), rows.view(torch.uint8)
    buf.index_copy_(1, pos, rows)


def mha(params: Params, x: torch.Tensor, cfg: ArchConfig, *,
        positions: Optional[torch.Tensor] = None,
        causal: bool = True,
        kv_cache: Optional[Dict[str, torch.Tensor]] = None,
        cache_index: Optional[torch.Tensor] = None,
        kv_len: Optional[int] = None,
        xattn_kv: Optional[torch.Tensor] = None,
        attn_plan: Optional[Any] = None,
        ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """GQA attention.

    x: [B, S, d].  kv_cache None -> self-attention over x.  With
    kv_cache {"k","v"} [B, L, Hkv, hd] and ``cache_index`` (a device
    int64 scalar, the absolute position of x's first token) the S new
    tokens are written into the cache IN PLACE at [cache_index,
    cache_index + S) (``index_copy_`` along the sequence axis, so that a
    captured CUDA graph reads the position at replay) and attend causally
    over the cache prefix; the same cache dict is returned.  A quantized
    cache (it has "k_scale" / "v_scale" [B, L, Hkv, 1] fp32 leaves) gets
    the new rows quantized per row and their codes and scales written in
    place; its read is sliced to the window first and only then
    dequantized to x's dtype.  ``kv_len``
    bounds the read to the cache's first kv_len positions (positions
    past the index are masked anyway), so reads scale with the live
    prefix, not max_len.  Requires cache_index + S <= kv_len.
    ``attn_plan`` (core.plan.AttnPlan) routes cache-free causal
    self-attention through the flash kernel with the plan's block sizes
    and KV precision.
    """
    if xattn_kv is not None:
        raise NotImplementedError("cross-attention not yet ported")
    B, S, _ = x.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q = _split_heads(linear(params["wq"], x), H, hd)          # [B,S,H,hd]
    k = _split_heads(linear(params["wk"], x), Hkv, hd)
    v = _split_heads(linear(params["wv"], x), Hkv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if kv_cache is not None:
        if cache_index is None:
            raise ValueError("mha: a KV cache needs cache_index")
        new = {"k": k, "v": v}
        if "k_scale" in kv_cache:
            # row-local scales: chunked and one-shot prefill write the
            # same codes, and a decode step never rescales history
            kv_name = kquant.kv_dtype_of(kv_cache["k"].dtype)
            new["k"], new["k_scale"] = kquant.quantize_rows(k, kv_name)
            new["v"], new["v_scale"] = kquant.quantize_rows(v, kv_name)
        pos = cache_index + torch.arange(S, device=x.device)
        for name, rows in new.items():
            _write_rows(kv_cache[name], pos, rows)
        new_cache = kv_cache
        window = {name: buf[:, :kv_len] for name, buf in kv_cache.items()}
        k, v = window["k"], window["v"]
        if "k_scale" in kv_cache:
            k = kquant.dequantize_rows(k, window["k_scale"], x.dtype)
            v = kquant.dequantize_rows(v, window["v_scale"], x.dtype)
        bias = _mask_bias(S, k.shape[1], True, cfg.sliding_window,
                          q_offset=cache_index, device=x.device)
    else:
        new_cache = None
        if attn_plan is not None and causal and cfg.sliding_window == 0:
            # plan-lowered flash path: block sizes from the grant
            from repro_torch.kernels import ops as kops
            ctx = kops.attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=True, block_q=attn_plan.block_q,
                block_kv=attn_plan.block_kv, kv_dtype=attn_plan.kv_dtype)
            ctx = ctx.transpose(1, 2).reshape(B, S, H * hd)
            return linear(params["wo"], ctx.to(x.dtype)), None
        bias = _mask_bias(S, S, causal, cfg.sliding_window, device=x.device)

    # grouped heads: fold the group dim into the contractions; fp32
    # products and sums, as the reference's preferred_element_type
    groups = H // Hkv
    qg = q.reshape(B, S, Hkv, groups, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())
    scores = scores * (hd ** -0.5) + bias
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    ctx = torch.einsum("bkgqs,bskh->bqkgh", probs.float(),
                       v.float()).to(x.dtype)
    ctx = ctx.reshape(B, S, H * hd)
    return linear(params["wo"], ctx), new_cache


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int,
                  dtype: Optional[torch.dtype] = None,
                  kv_dtype: Optional[str] = None,
                  device: Any = "cuda") -> Dict[str, torch.Tensor]:
    """KV cache buffers [B, max_len, Hkv, hd].  ``kv_dtype`` None /
    "native" keeps the compute dtype; "int8" / "fp8_e4m3" stores K/V as
    codes of that type with per-row fp32 scales [B, max_len, Hkv, 1],
    initialised to ones (src/repro/models/attention.py::init_kv_cache)."""
    shape = (batch, max_len, cfg.num_kv_heads, cfg.hd)
    if kv_dtype is not None and kv_dtype not in kquant.KV_DTYPES:
        raise ValueError(f"kv_dtype {kv_dtype!r}: want one of "
                         f"{kquant.KV_DTYPES}")
    if kv_dtype is not None and kv_dtype != "native":
        qdt = kquant.kv_storage_dtype(kv_dtype)
        sshape = shape[:-1] + (1,)
        return {"k": torch.zeros(shape, dtype=qdt, device=device),
                "v": torch.zeros(shape, dtype=qdt, device=device),
                "k_scale": torch.ones(sshape, dtype=torch.float32,
                                      device=device),
                "v_scale": torch.ones(sshape, dtype=torch.float32,
                                      device=device)}
    dt = dtype or cfg.torch_dtype
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}
