"""Decoder LM stacks: init, forward, cached decode and chunked prefill
(port of the dense-, MoE- and SSM-family paths of
src/repro/models/transformer.py).

Layers are a Python list of per-layer param dicts, and the decode caches
a list with one dict per layer: K/V for a dense layer, the recurrent
state ``{conv, ssm}`` for a Mamba2 layer.  One plain Python loop over
layers replaces both of the reference's unrolled and scanned variants.
Every cache write happens in place, into the buffers the caches held
when they were made: K/V rows by ``index_copy_`` at the position, a
Mamba2 layer's new state by ``copy_``.  ``decode_step`` /
``decode_epoch`` / ``prefill_chunk`` return the very cache list they
were given, updated.  The position is a device int64 scalar, as the
reference's traced ``index`` is: a captured CUDA graph reads it (and
every buffer) at replay, so the server replays one graph at every
position of a window.  A host int is moved to the device first.

An MoE layer is a dense layer whose FFN is :func:`~repro_torch.models.moe
.moe_apply`: decode takes its one-token fast path, a one-shot prefill
and a prompt chunk its capacity buckets (drop-free where serving needs
chunked == one-shot), and ``lm_forward`` returns the summed Switch aux
loss.  Other families (hybrid, encoder-decoder, VLM) raise
``NotImplementedError`` until their slices are ported.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch

from repro_torch.models.attention import init_attention, init_kv_cache, mha
from repro_torch.models.base import ArchConfig
from repro_torch.models.layers import (Params, embed, ffn, init_embedding,
                                       init_ffn, init_norm, rms_norm, unembed)
from repro_torch.models.moe import init_moe, moe_apply
from repro_torch.models.ssm import (init_mamba2, init_ssm_state,
                                    mamba2_forward, ssd_decode_step)

Caches = List[dict]
PORTED_FAMILIES = ("dense", "moe", "ssm")


def _require_ported(cfg: ArchConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(f"{cfg.name}: family {cfg.family!r} not "
                                  f"yet ported (have {PORTED_FAMILIES})")


# ---------------------------------------------------------------- init --
def init_dense_layer(gen: torch.Generator, cfg: ArchConfig) -> Params:
    dt, dev = cfg.torch_dtype, gen.device
    return {"ln1": init_norm(cfg.d_model, dt, dev),
            "attn": init_attention(gen, cfg),
            "ln2": init_norm(cfg.d_model, dt, dev),
            "mlp": (init_moe(gen, cfg) if cfg.is_moe
                    else init_ffn(gen, cfg.d_model, cfg.d_ff, dt))}


def init_ssm_layer(gen: torch.Generator, cfg: ArchConfig) -> Params:
    return {"ln1": init_norm(cfg.d_model, cfg.torch_dtype, gen.device),
            "mamba": init_mamba2(gen, cfg)}


def num_groups(cfg: ArchConfig) -> int:
    return cfg.num_layers


def init_lm(gen: torch.Generator, cfg: ArchConfig) -> Params:
    """Random params on ``gen``'s device, drawn in a fixed order."""
    _require_ported(cfg)
    dt = cfg.torch_dtype
    layer = init_ssm_layer if cfg.family == "ssm" else init_dense_layer
    return {"embed": init_embedding(gen, cfg.padded_vocab, cfg.d_model, dt),
            "layers": [layer(gen, cfg) for _ in range(num_groups(cfg))],
            "final_norm": init_norm(cfg.d_model, dt, gen.device)}


# ------------------------------------------------------------- blocks --
def _dense_block(p: Params, x: torch.Tensor, cfg: ArchConfig, *,
                 causal: bool = True, kv_cache=None,
                 cache_index: Optional[torch.Tensor] = None,
                 kv_len: Optional[int] = None, positions=None, plan=None,
                 moe_fast: bool = True, moe_drop_free: bool = False):
    """Attention and FFN (MoE for an MoE arch) of one layer: returns (x,
    the updated cache, the layer's MoE aux loss, 0.0 without MoE)."""
    h, new_cache = mha(p["attn"], rms_norm(p["ln1"], x, cfg.norm_eps), cfg,
                       causal=causal, kv_cache=kv_cache,
                       cache_index=cache_index, kv_len=kv_len,
                       positions=positions,
                       attn_plan=plan.attn if plan is not None else None)
    x = x + h
    y = rms_norm(p["ln2"], x, cfg.norm_eps)
    ffn_plan = plan.ffn if plan is not None else None
    aux = 0.0
    if cfg.is_moe:
        out, aux = moe_apply(p["mlp"], y, cfg, plan=ffn_plan,
                             decode_fast=moe_fast, drop_free=moe_drop_free)
    else:
        out = ffn(p["mlp"], y, plan=ffn_plan)
    return x + out, new_cache, aux


def _ssm_block(p: Params, x: torch.Tensor, cfg: ArchConfig, state=None,
               decode: bool = False, plan=None):
    """A Mamba2 layer: the O(1) recurrent step when ``decode``, else the
    chunked scan with the plan's SSD chunk (the architecture's without
    a plan).  Returns (x, new state)."""
    y = rms_norm(p["ln1"], x, cfg.norm_eps)
    if decode:
        out, new_state = ssd_decode_step(p["mamba"], y, cfg, state)
    else:
        chunk = plan.ssm_chunk if plan is not None else None
        out, new_state = mamba2_forward(p["mamba"], y, cfg, state,
                                        chunk=chunk)
    return x + out, new_state


# ------------------------------------------------------------ forward --
def lm_forward(params: Params, tokens: torch.Tensor, cfg: ArchConfig, *,
               embeds_prefix: Optional[torch.Tensor] = None,
               remat: bool = False,
               plan=None,
               serve_prefill: bool = False) -> Tuple[torch.Tensor, Any]:
    """Prefill forward without a cache.  tokens: [B, S] -> (logits
    [B, S, V] fp32, the summed MoE aux loss: an fp32 scalar for an MoE
    arch, 0.0 otherwise).  ``plan`` (a core.plan.KernelPlan) runs every
    dense layer's causal self-attention through the flash kernel with
    the plan's blocks and KV precision, and its FFN (each expert's, for
    MoE) through the kernel the grant lowered to (fused LBM or tiled
    LWM); a Mamba2 layer runs its SSD scan at the plan's chunk.  MoE
    layers run their capacity buckets even for one token;
    ``serve_prefill`` makes them drop-free, as :func:`prefill_chunk`'s,
    so the kept tokens do not depend on how a prompt is chunked.  The
    reference's flag also unrolls its shallow-stack layer scan; the port
    has one Python layer loop.  Patch/frame prefixes
    (``embeds_prefix``) and rematerialisation (``remat``) are not yet
    ported (raise)."""
    _require_ported(cfg)
    if embeds_prefix is not None:
        raise NotImplementedError("embeds_prefix (VLM / audio prefixes) "
                                  "not yet ported")
    if remat:
        raise NotImplementedError("remat (training) not yet ported")
    x = embed(params["embed"], tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux = 0.0
    for lp in params["layers"]:
        if cfg.family == "ssm":
            x, _ = _ssm_block(lp, x, cfg, plan=plan)
        else:
            x, _, a = _dense_block(lp, x, cfg, positions=positions, plan=plan,
                                   moe_fast=False,
                                   moe_drop_free=serve_prefill)
            aux = aux + a
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], x), aux


# -------------------------------------------------------------- decode --
def _as_index(index: Any, device: torch.device) -> torch.Tensor:
    """The position as a device int64 scalar (a host int is copied)."""
    if isinstance(index, torch.Tensor):
        return index
    return torch.tensor(index, dtype=torch.long, device=device)


def _write_state(cache: dict, state: dict) -> None:
    """A Mamba2 layer's new state into its cache buffers, in place (the
    same values and dtypes: the buffers keep their addresses)."""
    for name, value in state.items():
        cache[name].copy_(value)


def init_caches(params: Optional[Params], cfg: ArchConfig, batch: int,
                max_len: int, kv_dtype: Optional[str] = None,
                device: Any = None) -> Caches:
    """One cache dict per layer.  Dense: K/V at ``kv_dtype`` (None /
    "native": the compute dtype; "int8" / "fp8_e4m3": codes plus per-row
    fp32 scale leaves, see
    :func:`~repro_torch.models.attention.init_kv_cache`).  SSM: the zero
    recurrent state ``{conv, ssm}`` (the conv window in the compute
    dtype, the state in fp32), never quantized, whatever ``kv_dtype``
    says, and independent of ``max_len``.  The device defaults to the
    params' device (``"cuda"`` without params)."""
    _require_ported(cfg)
    if device is None:
        device = (params["embed"]["table"].device if params is not None
                  else "cuda")
    if cfg.family == "ssm":
        return [init_ssm_state(cfg, batch, device)
                for _ in range(num_groups(cfg))]
    return [init_kv_cache(cfg, batch, max_len, kv_dtype=kv_dtype,
                          device=device)
            for _ in range(num_groups(cfg))]


def decode_step(params: Params, token: torch.Tensor, caches: Caches,
                index: Any, cfg: ArchConfig, plan=None,
                kv_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Caches]:
    """One decode step.  token: [B, 1] int; index: the position (a device
    int64 scalar, or a host int).  ``plan`` (a core.plan.KernelPlan) runs
    each dense layer's FFN through the Hopper kernel its grant lowered to
    (a Mamba2 layer's O(1) step has no plan); ``kv_len`` bounds the
    attention read to the live cache prefix (index < kv_len).  Returns (logits [B, 1, V] fp32,
    the caches, updated in place)."""
    _require_ported(cfg)
    x = embed(params["embed"], token)
    index = _as_index(index, x.device)
    positions = index.reshape(1, 1)
    for g, lp in enumerate(params["layers"]):
        if cfg.family == "ssm":
            x, state = _ssm_block(lp, x, cfg, state=caches[g], decode=True)
            _write_state(caches[g], state)
            continue
        x, _, _ = _dense_block(lp, x, cfg, kv_cache=caches[g],
                               cache_index=index, kv_len=kv_len,
                               positions=positions, plan=plan)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], x), caches


def decode_epoch(params: Params, token: torch.Tensor, caches: Caches,
                 index: Any, cfg: ArchConfig, k: int, *,
                 next_token_fn: Callable[[torch.Tensor], torch.Tensor],
                 plan=None, kv_len: Optional[int] = None
                 ) -> Tuple[torch.Tensor, Caches]:
    """K decode steps under one static plan, each output token fed back
    in (``next_token_fn(logits) -> [B]`` closes the loop).  token:
    [B, 1]; index: the start position (a device int64 scalar, or a host
    int).  Returns (tokens [B, k], caches) and is bit-identical to k
    sequential :func:`decode_step` calls: it is exactly that loop, with
    nothing read back to the host."""
    toks = []
    tok = token
    index = _as_index(index, token.device)
    for i in range(k):
        logits, caches = decode_step(params, tok, caches, index + i, cfg,
                                     plan=plan, kv_len=kv_len)
        nxt = next_token_fn(logits)
        toks.append(nxt)
        tok = nxt[:, None]
    return torch.stack(toks, dim=1), caches


def prefill_chunk(params: Params, tokens: torch.Tensor, caches: Caches,
                  index: Any, cfg: ArchConfig, kv_len: Optional[int] = None
                  ) -> Tuple[torch.Tensor, Caches]:
    """One cache-resuming prefill chunk: forward ``tokens`` [B, S] at
    absolute positions [index, index + S), writing their KV (or carrying
    the Mamba2 state) into the caches, and return the LAST position's
    logits [B, 1, V] plus the caches.  As in the reference the chunk
    runs the plain path (no plan; an SSM layer scans at the
    architecture's chunk, whose segmentation a chunked prefill at
    chunk-aligned boundaries preserves; an MoE layer routes through
    drop-free buckets, even for a one-token chunk): the grant decides
    the chunk's size and NEC charge, not its numerics.  Requires index + S <=
    max_len (and <= kv_len)."""
    _require_ported(cfg)
    x = embed(params["embed"], tokens)
    S = x.shape[1]
    index = _as_index(index, x.device)
    positions = (torch.arange(S, device=x.device)[None, :] + index)
    for g, lp in enumerate(params["layers"]):
        if cfg.family == "ssm":
            x, state = _ssm_block(lp, x, cfg, state=caches[g])
            _write_state(caches[g], state)
            continue
        x, _, _ = _dense_block(lp, x, cfg, kv_cache=caches[g],
                               cache_index=index, kv_len=kv_len,
                               positions=positions, moe_fast=False,
                               moe_drop_free=True)
    x = rms_norm(params["final_norm"], x[:, -1:, :], cfg.norm_eps)
    return unembed(params["embed"], x), caches
