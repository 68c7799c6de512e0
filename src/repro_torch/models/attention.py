"""GQA self-attention with RoPE, causal / sliding-window masks and a
native KV cache (port of src/repro/models/attention.py, the paths the
dense serving slice uses).

Plain PyTorch, as the reference's attention is plain ``jnp``.  Not yet
ported, and raising ``NotImplementedError`` rather than computing
something else: the plan-lowered flash-attention path, quantized KV
caches and cross-attention.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

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
               q_offset: int = 0,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """[q_len, kv_len] additive bias; q_offset = absolute pos of query 0."""
    qpos = torch.arange(q_len, device=device)[:, None] + q_offset
    kpos = torch.arange(kv_len, device=device)[None, :]
    ok = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= kpos > qpos - window
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def mha(params: Params, x: torch.Tensor, cfg: ArchConfig, *,
        positions: Optional[torch.Tensor] = None,
        causal: bool = True,
        kv_cache: Optional[Dict[str, torch.Tensor]] = None,
        cache_index: Optional[int] = None,
        kv_len: Optional[int] = None,
        xattn_kv: Optional[torch.Tensor] = None,
        attn_plan: Optional[Any] = None,
        ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """GQA attention.

    x: [B, S, d].  kv_cache None -> self-attention over x.  With
    kv_cache {"k","v"} [B, L, Hkv, hd] and ``cache_index`` (a host int,
    the absolute position of x's first token) the S new tokens are
    written into the cache IN PLACE at [cache_index, cache_index + S) and
    attend causally over the cache prefix; the same cache dict is
    returned.  ``kv_len`` bounds the read to the cache's first kv_len
    positions (positions past the index are masked anyway), so reads
    scale with the live prefix, not max_len.  Requires
    cache_index + S <= kv_len.
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
        if "k_scale" in kv_cache:
            raise NotImplementedError("quantized KV cache not yet ported")
        kv_cache["k"][:, cache_index:cache_index + S] = k
        kv_cache["v"][:, cache_index:cache_index + S] = v
        new_cache = kv_cache
        k, v = kv_cache["k"], kv_cache["v"]
        if kv_len is not None and kv_len < k.shape[1]:
            k, v = k[:, :kv_len], v[:, :kv_len]
        bias = _mask_bias(S, k.shape[1], True, cfg.sliding_window,
                          q_offset=cache_index, device=x.device)
    else:
        new_cache = None
        if attn_plan is not None and causal and cfg.sliding_window == 0:
            raise NotImplementedError("flash_attention not yet ported")
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
    """Native-precision KV cache buffers [B, max_len, Hkv, hd]."""
    if kv_dtype is not None and kv_dtype != "native":
        raise NotImplementedError(f"KV cache dtype {kv_dtype!r} not yet ported")
    shape = (batch, max_len, cfg.num_kv_heads, cfg.hd)
    dt = dtype or cfg.torch_dtype
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}
