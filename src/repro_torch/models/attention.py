"""GQA self-attention with RoPE, causal / sliding-window masks, native
and quantized (int8 / fp8_e4m3) KV caches and the plan-lowered flash
path (port of src/repro/models/attention.py, the paths the dense slices
use).

Plain PyTorch, as the reference's attention is plain ``jnp``, except
under an attention plan: cache-free causal self-attention then runs
through the flash-attention kernel with the plan's blocks and KV
precision (``kernels/ops.py::attention``).  A quantized cache stores
per-row codes and fp32 scales; the cached path dequantizes the live
window in plain ops, as the reference's does.  Cross-attention (an
encoder-decoder's decoder over the encoder output) is plain too: K and
V projected from ``xattn_kv`` at every call, no RoPE, no mask and no
cache.  Over a tensor-parallel group whose split falls on head
boundaries (:func:`head_shards`), each shard attends over its own heads
on its own device, through its own KV cache leaves (:func:`_mha_heads`).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.distributed import tensor_parallel as tp
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
    and KV precision.  Cross-attention: ``xattn_kv`` [B, L_enc, d] (the
    encoder output) gives K and V, with no RoPE on q or k, no mask and
    no cache update (the cache and plan arguments are ignored).
    """
    B, S, _ = x.shape
    H, Hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    if head_shards(params, cfg) is not None:
        return _mha_heads(params, x, cfg, positions=positions, causal=causal,
                          kv_cache=kv_cache, cache_index=cache_index,
                          kv_len=kv_len, xattn_kv=xattn_kv,
                          attn_plan=attn_plan)
    src = x if xattn_kv is None else xattn_kv
    q = _split_heads(linear(params["wq"], x), H, hd)          # [B,S,H,hd]
    k = _split_heads(linear(params["wk"], src), Hkv, hd)
    v = _split_heads(linear(params["wv"], src), Hkv, hd)
    ctx = _context(q, k, v, cfg, x.dtype, positions=positions, causal=causal,
                   kv_cache=kv_cache, cache_index=cache_index, kv_len=kv_len,
                   cross=xattn_kv is not None, attn_plan=attn_plan)
    return (linear(params["wo"], ctx),
            kv_cache if xattn_kv is None else None)


def _context(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             cfg: ArchConfig, dtype: torch.dtype, *, positions: torch.Tensor,
             causal: bool, kv_cache: Optional[Dict[str, torch.Tensor]],
             cache_index: Optional[torch.Tensor], kv_len: Optional[int],
             cross: bool, attn_plan: Optional[Any]) -> torch.Tensor:
    """Attention of q [B, S, h, hd] over the new k, v [B, S, hkv, hd] (or
    the encoder's, ``cross``), through the cache when one is given (its
    leaves [B, L, hkv, .], written in place), before the output
    projection: the context [B, S, h * hd] in ``dtype``.  The head counts
    are q's and k's, so a tensor-parallel shard passes its own heads and
    its head range of the cache."""
    B, S, h, hd = q.shape
    if cross:
        bias = torch.zeros((S, k.shape[1]), dtype=torch.float32,
                           device=q.device)
        return _attend(q, k, v, bias, dtype)
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
        pos = cache_index + torch.arange(S, device=q.device)
        for name, rows in new.items():
            _write_rows(kv_cache[name], pos, rows)
        window = {name: buf[:, :kv_len] for name, buf in kv_cache.items()}
        k, v = window["k"], window["v"]
        if "k_scale" in kv_cache:
            k = kquant.dequantize_rows(k, window["k_scale"], dtype)
            v = kquant.dequantize_rows(v, window["v_scale"], dtype)
        bias = _mask_bias(S, k.shape[1], True, cfg.sliding_window,
                          q_offset=cache_index, device=q.device)
        return _attend(q, k, v, bias, dtype)
    if attn_plan is not None and causal and cfg.sliding_window == 0:
        # plan-lowered flash path: block sizes from the grant
        from repro_torch.kernels import ops as kops
        ctx = kops.attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=True, block_q=attn_plan.block_q,
            block_kv=attn_plan.block_kv, kv_dtype=attn_plan.kv_dtype)
        return ctx.transpose(1, 2).reshape(B, S, h * hd).to(dtype)
    bias = _mask_bias(S, S, causal, cfg.sliding_window, device=q.device)
    return _attend(q, k, v, bias, dtype)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            bias: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Plain GQA attention of q [B, S, H, hd] over k, v [B, L, Hkv, hd]
    with an additive ``bias`` [S, L]: the context [B, S, H * hd].  The
    group dim is folded into the contractions; fp32 products and sums,
    as the reference's preferred_element_type."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, H // Hkv, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float())
    scores = scores * (hd ** -0.5) + bias
    probs = torch.softmax(scores, dim=-1).to(dtype)
    ctx = torch.einsum("bkgqs,bskh->bqkgh", probs.float(),
                       v.float()).to(dtype)
    return ctx.reshape(B, S, H * hd)


def head_shards(params: Params, cfg: ArchConfig
                ) -> Optional[List[torch.device]]:
    """The devices of a tensor-parallel group over which this attention
    splits by heads: wq / wk / wv split by columns and wo by rows into n
    pieces, with H and Hkv divisible by n, so that every piece holds
    whole heads and GQA's head mapping stays inside a shard.  None
    otherwise: the projections (split or not) go through
    ``layers.linear``, which puts their whole outputs on x's device, and
    attention runs there over a whole cache."""
    ws = [params[n]["w"] for n in ("wq", "wk", "wv", "wo")]
    if not all(tp.is_sharded(w) for w in ws):
        return None
    n = len(ws[0].pieces)
    if (any(len(w.pieces) != n for w in ws) or cfg.num_heads % n
            or cfg.num_kv_heads % n):
        return None
    return ws[1].devices


def shard_name(name: str, r: int) -> str:
    """A head-split cache's name for shard ``r``'s piece of leaf
    ``name``."""
    return f"{name}@{r}"


def cache_shard(cache: Dict[str, torch.Tensor], r: int
                ) -> Dict[str, torch.Tensor]:
    """Shard ``r``'s leaves of a head-split KV cache, under their plain
    names."""
    tag = shard_name("", r)
    out = {name[:-len(tag)]: leaf for name, leaf in cache.items()
           if name.endswith(tag)}
    if not out:
        raise ValueError(f"a KV cache with leaves {sorted(cache)} has no "
                         f"shard {r}: a head-split attention takes the "
                         f"cache init_caches makes from its params")
    return out


def _mha_heads(params: Params, x: torch.Tensor, cfg: ArchConfig, *,
               positions: torch.Tensor, causal: bool,
               kv_cache: Optional[Dict[str, torch.Tensor]],
               cache_index: Optional[torch.Tensor], kv_len: Optional[int],
               xattn_kv: Optional[torch.Tensor], attn_plan: Optional[Any]
               ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """:func:`mha` over a group split by heads (:func:`head_shards`).
    Shard r projects its q, k and v heads on its device, writes and reads
    its own cache leaves there (``shard_name(name, r)``: its KV heads, see
    :func:`init_kv_cache`), attends over its heads (one flash launch a
    shard under a plan) and multiplies its context by its rows of wo; the
    partial outputs are summed in shard order on x's device."""
    wq, wk, wv, wo = (params[n]["w"] for n in ("wq", "wk", "wv", "wo"))
    n = len(wq.pieces)
    hq, hk, hd = cfg.num_heads // n, cfg.num_kv_heads // n, cfg.hd
    src = x if xattn_kv is None else xattn_kv
    cache = kv_cache if xattn_kv is None else None
    ctxs = []
    for r, (q, k, v) in enumerate(zip(tp.col(x, wq), tp.col(src, wk),
                                      tp.col(src, wv))):
        dev = q.device
        ctxs.append(_context(
            _split_heads(q, hq, hd), _split_heads(k, hk, hd),
            _split_heads(v, hk, hd), cfg, x.dtype,
            positions=positions.to(dev), causal=causal, kv_len=kv_len,
            cache_index=(cache_index.to(dev) if torch.is_tensor(cache_index)
                         else cache_index),
            kv_cache=None if cache is None else cache_shard(cache, r),
            cross=xattn_kv is not None, attn_plan=attn_plan))
    return tp.row(ctxs, wo, x.device), cache


def init_kv_cache(cfg: ArchConfig, batch: int, max_len: int,
                  dtype: Optional[torch.dtype] = None,
                  kv_dtype: Optional[str] = None,
                  device: Any = "cuda",
                  shards: Optional[List[torch.device]] = None
                  ) -> Dict[str, torch.Tensor]:
    """KV cache buffers [B, max_len, Hkv, hd].  ``kv_dtype`` None /
    "native" keeps the compute dtype; "int8" / "fp8_e4m3" stores K/V as
    codes of that type with per-row fp32 scales [B, max_len, Hkv, 1],
    initialised to ones (src/repro/models/attention.py::init_kv_cache).
    ``shards``: the devices of a group whose attention splits by heads
    (:func:`head_shards`); each leaf is then one leaf a shard,
    ``shard_name(name, r)`` [B, max_len, Hkv / n, .] on device r."""
    if kv_dtype is not None and kv_dtype not in kquant.KV_DTYPES:
        raise ValueError(f"kv_dtype {kv_dtype!r}: want one of "
                         f"{kquant.KV_DTYPES}")
    if shards is not None:
        heads = cfg.num_kv_heads // len(shards)
        return {shard_name(name, r): leaf
                for r, dev in enumerate(shards)
                for name, leaf in _kv_buffers(cfg, batch, max_len, heads,
                                              dtype, kv_dtype, dev).items()}
    return _kv_buffers(cfg, batch, max_len, cfg.num_kv_heads, dtype,
                       kv_dtype, device)


def _kv_buffers(cfg: ArchConfig, batch: int, max_len: int, heads: int,
                dtype: Optional[torch.dtype], kv_dtype: Optional[str],
                device: Any) -> Dict[str, torch.Tensor]:
    shape = (batch, max_len, heads, cfg.hd)
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
