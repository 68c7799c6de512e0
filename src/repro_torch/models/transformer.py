"""Dense decoder LM: init, forward, KV-cached decode and chunked prefill
(port of the dense-family paths of src/repro/models/transformer.py).

Layers are a Python list of per-layer param dicts, and the decode caches
a list with one KV dict per layer; one plain Python loop over layers
replaces both of the reference's unrolled and scanned variants.  Cache
writes happen in place (slice assignment into the layer's buffers), so
``decode_step`` / ``decode_epoch`` / ``prefill_chunk`` return the very
cache list they were given, updated.  Positions and cache indices are
host ints: the serving loop knows them without reading the device.

Other families (MoE, SSM, hybrid, encoder-decoder, VLM) raise
``NotImplementedError`` until their slices are ported.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch

from repro_torch.models.attention import init_attention, init_kv_cache, mha
from repro_torch.models.base import ArchConfig
from repro_torch.models.layers import (Params, embed, ffn, init_embedding,
                                       init_ffn, init_norm, rms_norm, unembed)

Caches = List[dict]


def _require_dense(cfg: ArchConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} not "
                                  "yet ported (dense only)")


# ---------------------------------------------------------------- init --
def init_dense_layer(gen: torch.Generator, cfg: ArchConfig) -> Params:
    dt, dev = cfg.torch_dtype, gen.device
    return {"ln1": init_norm(cfg.d_model, dt, dev),
            "attn": init_attention(gen, cfg),
            "ln2": init_norm(cfg.d_model, dt, dev),
            "mlp": init_ffn(gen, cfg.d_model, cfg.d_ff, dt)}


def num_groups(cfg: ArchConfig) -> int:
    return cfg.num_layers


def init_lm(gen: torch.Generator, cfg: ArchConfig) -> Params:
    """Random params on ``gen``'s device, drawn in a fixed order."""
    _require_dense(cfg)
    dt = cfg.torch_dtype
    return {"embed": init_embedding(gen, cfg.padded_vocab, cfg.d_model, dt),
            "layers": [init_dense_layer(gen, cfg)
                       for _ in range(num_groups(cfg))],
            "final_norm": init_norm(cfg.d_model, dt, gen.device)}


# ------------------------------------------------------------- blocks --
def _dense_block(p: Params, x: torch.Tensor, cfg: ArchConfig, *,
                 causal: bool = True, kv_cache=None,
                 cache_index: Optional[int] = None,
                 kv_len: Optional[int] = None, positions=None, plan=None):
    h, new_cache = mha(p["attn"], rms_norm(p["ln1"], x, cfg.norm_eps), cfg,
                       causal=causal, kv_cache=kv_cache,
                       cache_index=cache_index, kv_len=kv_len,
                       positions=positions,
                       attn_plan=plan.attn if plan is not None else None)
    x = x + h
    y = rms_norm(p["ln2"], x, cfg.norm_eps)
    out = ffn(p["mlp"], y, plan=plan.ffn if plan is not None else None)
    return x + out, new_cache


# ------------------------------------------------------------ forward --
def lm_forward(params: Params, tokens: torch.Tensor, cfg: ArchConfig, *,
               plan=None) -> Tuple[torch.Tensor, float]:
    """Prefill forward without a cache.  tokens: [B, S] -> (logits
    [B, S, V] fp32, aux loss 0.0).  A plan routes causal attention
    through flash attention, which is not yet ported (raises)."""
    _require_dense(cfg)
    x = embed(params["embed"], tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for lp in params["layers"]:
        x, _ = _dense_block(lp, x, cfg, positions=positions, plan=plan)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], x), 0.0


# -------------------------------------------------------------- decode --
def init_caches(params: Optional[Params], cfg: ArchConfig, batch: int,
                max_len: int, kv_dtype: Optional[str] = None,
                device: Any = None) -> Caches:
    """One native KV dict per layer.  The device defaults to the
    params' device (``"cuda"`` without params)."""
    _require_dense(cfg)
    if device is None:
        device = (params["embed"]["table"].device if params is not None
                  else "cuda")
    return [init_kv_cache(cfg, batch, max_len, kv_dtype=kv_dtype,
                          device=device)
            for _ in range(num_groups(cfg))]


def decode_step(params: Params, token: torch.Tensor, caches: Caches,
                index: int, cfg: ArchConfig, plan=None,
                kv_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Caches]:
    """One decode step.  token: [B, 1] int; index: host int position.
    ``plan`` (a core.plan.KernelPlan) runs each layer's FFN through the
    Hopper kernel its grant lowered to; ``kv_len`` bounds the attention
    read to the live cache prefix (index < kv_len).  Returns (logits
    [B, 1, V] fp32, the caches, updated in place)."""
    _require_dense(cfg)
    x = embed(params["embed"], token)
    positions = torch.full((1, 1), index, dtype=torch.long, device=x.device)
    for g, lp in enumerate(params["layers"]):
        x, caches[g] = _dense_block(lp, x, cfg, kv_cache=caches[g],
                                    cache_index=index, kv_len=kv_len,
                                    positions=positions, plan=plan)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], x), caches


def decode_epoch(params: Params, token: torch.Tensor, caches: Caches,
                 index: int, cfg: ArchConfig, k: int, *,
                 next_token_fn: Callable[[torch.Tensor], torch.Tensor],
                 plan=None, kv_len: Optional[int] = None
                 ) -> Tuple[torch.Tensor, Caches]:
    """K decode steps under one static plan, each output token fed back
    in (``next_token_fn(logits) -> [B]`` closes the loop).  token:
    [B, 1]; index: host int start position.  Returns (tokens [B, k],
    caches) and is bit-identical to k sequential :func:`decode_step`
    calls: it is exactly that loop, with nothing read back to the host."""
    toks = []
    tok = token
    for i in range(k):
        logits, caches = decode_step(params, tok, caches, index + i, cfg,
                                     plan=plan, kv_len=kv_len)
        nxt = next_token_fn(logits)
        toks.append(nxt)
        tok = nxt[:, None]
    return torch.stack(toks, dim=1), caches


def prefill_chunk(params: Params, tokens: torch.Tensor, caches: Caches,
                  index: int, cfg: ArchConfig, kv_len: Optional[int] = None
                  ) -> Tuple[torch.Tensor, Caches]:
    """One cache-resuming prefill chunk: forward ``tokens`` [B, S] at
    absolute positions [index, index + S), writing their KV into the
    caches in place, and return the LAST position's logits [B, 1, V]
    plus the caches.  As in the reference the chunk runs the plain path
    (no plan): the grant decides the chunk's size and NEC charge, not
    its numerics.  Requires index + S <= max_len (and <= kv_len)."""
    _require_dense(cfg)
    x = embed(params["embed"], tokens)
    S = x.shape[1]
    positions = (torch.arange(S, device=x.device)[None, :] + index)
    for g, lp in enumerate(params["layers"]):
        x, caches[g] = _dense_block(lp, x, cfg, kv_cache=caches[g],
                                    cache_index=index, kv_len=kv_len,
                                    positions=positions)
    x = rms_norm(params["final_norm"], x[:, -1:, :], cfg.norm_eps)
    return unembed(params["embed"], x), caches
