"""Decoder LM stacks: init, forward, cached decode and chunked prefill
(port of the dense-, MoE-, SSM- and hybrid-family paths of
src/repro/models/transformer.py).

Layers are a Python list of per-layer param dicts, and the decode caches
a list with one dict per layer: K/V for an attention layer, the
recurrent state ``{conv, ssm}`` for a Mamba2 layer.  One plain Python
loop over layers replaces both of the reference's unrolled and scanned
variants.

A hybrid (Zamba2-style) stack is ``num_layers / attn_every`` groups of
``attn_every - 1`` Mamba2 layers followed by one attention + FFN block
whose weights every group shares.  Its params mirror the reference's
tree: ``layers`` is a list with one ``{"ssm": [Mamba2 layer, ...]}``
dict per group, and ``shared_attn`` one dense layer, stored once.  Its
caches are the flat per-layer list in execution order: each group's
Mamba2 states, then that group's own K/V (the weights are shared, the
K/V is not).  So every loop over the caches that treats a dict by its
leaves' names (K/V leaves, :func:`is_kv_leaf`, have a time axis,
``conv`` and ``ssm`` do not) holds for every family, and the i-th cache belongs to
the i-th layer that :func:`_layers` yields.

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
loss.

A VLM (LLaVA-style) is the dense stack; ``lm_forward``'s
``embeds_prefix`` (the patch embeddings of the stub frontend) is
concatenated before the token embeddings, and the logits cover both.
An encoder-decoder (Whisper-style) stack adds ``encoder`` (a list of
dense layers run bidirectionally over the frame embeddings, and its
``final_norm``) and ``xattn``, one ``{ln, attn}`` cross-attention block
per decoder layer; :func:`_layer_pairs` yields each decoder layer with
its block.  Its decoder stream is the tokens only, and ``decode_step`` /
``decode_epoch`` / ``prefill_chunk`` take the encoder output
``enc_out`` [B, L_enc, d], which each layer's cross-attention projects
to K/V at every call (no cross-attention cache, as in the reference).
"""
from __future__ import annotations

import functools
import itertools
from typing import Any, Callable, Iterator, List, Optional, Tuple

import torch
import torch.utils.checkpoint as tcheckpoint

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models.attention import (head_shards, init_attention,
                                          init_kv_cache, mha)
from repro_torch.models.base import ArchConfig
from repro_torch.models.layers import (Params, embed, ffn, init_embedding,
                                       init_ffn, init_norm, rms_norm, unembed)
from repro_torch.models.moe import init_moe, moe_apply
from repro_torch.models.ssm import (init_mamba2, init_ssm_state,
                                    mamba2_forward, ssd_decode_step)

Caches = List[dict]
PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
# the leaves of an attention layer's cache: [B, T, Hkv, .], time on axis 1
KV_LEAVES = ("k", "v", "k_scale", "v_scale")


def is_kv_leaf(name: str) -> bool:
    """Whether a cache leaf is K/V (``KV_LEAVES``, or a head-split
    cache's shard of one, ``attention.shard_name``): time on axis 1."""
    return name.partition("@")[0] in KV_LEAVES
_REMAT_POLICY = "full"   # "full" | "dots" (save matmul outputs)


def set_remat_policy(p: str) -> None:
    global _REMAT_POLICY
    assert p in ("full", "dots"), p
    _REMAT_POLICY = p


def _save_dots(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the output of every matmul without a
    batch dim (``aten.mm`` / ``aten.addmm``, as JAX's
    ``dots_with_no_batch_dims_saveable``), recompute the rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return tcheckpoint.CheckpointPolicy.MUST_SAVE
    return tcheckpoint.CheckpointPolicy.PREFER_RECOMPUTE


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


def init_hybrid_group(gen: torch.Generator, cfg: ArchConfig) -> Params:
    """A hybrid group's own layers: ``attn_every - 1`` Mamba2 layers (the
    attention block is the shared one, stored once in ``shared_attn``)."""
    return {"ssm": [init_ssm_layer(gen, cfg)
                    for _ in range(cfg.attn_every - 1)]}


def num_groups(cfg: ArchConfig) -> int:
    """Layer groups: ``num_layers / attn_every`` for a hybrid stack, one
    layer a group otherwise."""
    if cfg.family == "hybrid":
        if cfg.num_layers % cfg.attn_every:
            raise ValueError(f"{cfg.name}: num_layers {cfg.num_layers} not "
                             f"a multiple of attn_every {cfg.attn_every}")
        return cfg.num_layers // cfg.attn_every
    return cfg.num_layers


def is_attention_layer(cfg: ArchConfig, i: int) -> bool:
    """Whether layer ``i`` (execution order) attends and caches K/V: every
    layer of a dense or MoE stack, none of an SSM stack, the last of
    each hybrid group."""
    if cfg.family == "hybrid":
        return i % cfg.attn_every == cfg.attn_every - 1
    return cfg.family != "ssm"


def init_lm(gen: torch.Generator, cfg: ArchConfig) -> Params:
    """Random params on ``gen``'s device, drawn in a fixed order."""
    _require_ported(cfg)
    dt = cfg.torch_dtype
    layer = {"ssm": init_ssm_layer,
             "hybrid": init_hybrid_group}.get(cfg.family, init_dense_layer)
    params = {"embed": init_embedding(gen, cfg.padded_vocab, cfg.d_model, dt),
              "layers": [layer(gen, cfg) for _ in range(num_groups(cfg))],
              "final_norm": init_norm(cfg.d_model, dt, gen.device)}
    if cfg.family == "hybrid":
        params["shared_attn"] = init_dense_layer(gen, cfg)
    if cfg.family == "encdec":
        params["encoder"] = {
            "layers": [init_dense_layer(gen, cfg)
                       for _ in range(cfg.enc_layers)],
            "final_norm": init_norm(cfg.d_model, dt, gen.device)}
        params["xattn"] = [{"ln": init_norm(cfg.d_model, dt, gen.device),
                            "attn": init_attention(gen, cfg)}
                           for _ in range(num_groups(cfg))]
    return params


def _layers(params: Params, cfg: ArchConfig) -> Iterator[Params]:
    """Every layer's params in execution order: a hybrid group's Mamba2
    layers, then the shared attention block, group after group."""
    if cfg.family != "hybrid":
        yield from params["layers"]
        return
    for group in params["layers"]:
        yield from group["ssm"]
        yield params["shared_attn"]


def _layer_pairs(params: Params, cfg: ArchConfig
                 ) -> Iterator[Tuple[Params, Optional[Params]]]:
    """:func:`_layers`, each with its cross-attention block
    (``params["xattn"]``: an encoder-decoder's decoder layers; None for
    every other family)."""
    return zip(_layers(params, cfg),
               params.get("xattn") or itertools.repeat(None))


# ------------------------------------------------------------- blocks --
def _dense_block(p: Params, x: torch.Tensor, cfg: ArchConfig, *,
                 causal: bool = True, kv_cache=None,
                 cache_index: Optional[torch.Tensor] = None,
                 kv_len: Optional[int] = None, positions=None,
                 xattn_kv: Optional[torch.Tensor] = None,
                 xp: Optional[Params] = None, plan=None,
                 moe_fast: bool = True, moe_drop_free: bool = False):
    """Attention, the cross-attention residual over ``xattn_kv`` where
    ``xp`` (an encoder-decoder's decoder layer) is given, and the FFN (MoE
    for an MoE arch) of one layer: returns (x, the updated cache, the
    layer's MoE aux loss, 0.0 without MoE)."""
    h, new_cache = mha(p["attn"], rms_norm(p["ln1"], x, cfg.norm_eps), cfg,
                       causal=causal, kv_cache=kv_cache,
                       cache_index=cache_index, kv_len=kv_len,
                       positions=positions,
                       attn_plan=plan.attn if plan is not None else None)
    x = x + h
    if xp is not None:
        hx, _ = mha(xp["attn"], rms_norm(xp["ln"], x, cfg.norm_eps), cfg,
                    causal=False, xattn_kv=xattn_kv)
        x = x + hx
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
    [B, S', V] fp32, the summed MoE aux loss: an fp32 scalar for an MoE
    arch, 0.0 otherwise).  ``embeds_prefix`` [B, P, d] (VLM patches) is
    concatenated before the token embeddings, so S' = P + S and the
    positions cover both; for an encoder-decoder it holds the audio
    frames, which :func:`encode` runs over (the token embeddings where
    it is None), and the decoder stream, so the logits, cover the tokens
    only (S' = S).  ``plan`` (a core.plan.KernelPlan) runs every dense
    layer's causal self-attention through the flash kernel with the
    plan's blocks and KV precision, and its FFN (each expert's, for MoE)
    through the kernel the grant lowered to (fused LBM or tiled LWM); a
    Mamba2 layer runs its SSD scan at the plan's chunk.  The encoder and
    the cross-attention run plain, as in the reference.  MoE layers run
    their capacity buckets even for one token; ``serve_prefill`` makes
    them drop-free, as :func:`prefill_chunk`'s, so the kept tokens do
    not depend on how a prompt is chunked.  The reference's flag also
    unrolls its shallow-stack layer scan; the port has one Python layer
    loop.  ``remat`` (training) recomputes each layer group's activations
    in the backward pass (``torch.utils.checkpoint``, non-reentrant)
    instead of keeping them, as the reference's ``jax.checkpoint`` around
    its group step: one layer, or a hybrid group's Mamba2 layers and the
    shared block; :func:`set_remat_policy` ``"dots"`` keeps the matmul
    outputs.  The encoder runs without remat, as in the reference."""
    _require_ported(cfg)
    x = embed(params["embed"], tokens)
    if embeds_prefix is not None:
        x = torch.cat([embeds_prefix.to(x.dtype), x], dim=1)
    enc_out = None
    if cfg.family == "encdec":
        enc_out = encode(params, embeds_prefix if embeds_prefix is not None
                         else x, cfg)
        x = embed(params["embed"], tokens)     # decoder stream: tokens only
    positions = torch.arange(x.shape[1], device=x.device)[None, :]

    def group_fn(x, members):
        aux = 0.0
        for i, lp, xp in members:
            if not is_attention_layer(cfg, i):
                x, _ = _ssm_block(lp, x, cfg, plan=plan)
            else:
                x, _, a = _dense_block(lp, x, cfg, positions=positions,
                                       xattn_kv=enc_out, xp=xp, plan=plan,
                                       moe_fast=False,
                                       moe_drop_free=serve_prefill)
                aux = aux + a
        return x, aux

    layers = [(i, lp, xp)
              for i, (lp, xp) in enumerate(_layer_pairs(params, cfg))]
    size = cfg.attn_every if cfg.family == "hybrid" else 1
    context = (functools.partial(
        tcheckpoint.create_selective_checkpoint_contexts, _save_dots)
        if _REMAT_POLICY == "dots" else tcheckpoint.noop_context_fn)
    aux = 0.0
    for g in range(0, len(layers), size):
        members = layers[g:g + size]
        if remat:
            x, a = tcheckpoint.checkpoint(group_fn, x, members,
                                          use_reentrant=False,
                                          context_fn=context)
        else:
            x, a = group_fn(x, members)
        aux = aux + a
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], x), aux


def encode(params: Params, frames: torch.Tensor,
           cfg: ArchConfig) -> torch.Tensor:
    """The encoder-decoder's bidirectional encoder over precomputed frame
    embeddings [B, L, d] (the stub frontend's): the ``encoder`` layers,
    non-causal and without a plan, then its final norm.  Returns
    [B, L, d] in the compute dtype."""
    x = frames.to(cfg.torch_dtype)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for lp in params["encoder"]["layers"]:
        x, _, _ = _dense_block(lp, x, cfg, causal=False, positions=positions)
    return rms_norm(params["encoder"]["final_norm"], x, cfg.norm_eps)


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
    """One cache dict per layer, in execution order.  An attention layer:
    K/V at ``kv_dtype`` (None / "native": the compute dtype; "int8" /
    "fp8_e4m3": codes plus per-row fp32 scale leaves, see
    :func:`~repro_torch.models.attention.init_kv_cache`).  A Mamba2
    layer: the zero recurrent state ``{conv, ssm}`` (the conv window in
    the compute dtype, the state in fp32), never quantized, whatever
    ``kv_dtype`` says, and independent of ``max_len``.  A hybrid stack
    holds both (see the module docstring).  The device defaults to the
    params' device (a tensor-parallel group's first device; ``"cuda"``
    without params).  Over a group whose attention splits by heads
    (``attention.head_shards`` of the layer's params), an attention
    layer's cache is one piece a shard, its KV heads, on the shard's
    device; every other cache is on ``device``."""
    _require_ported(cfg)
    if device is None:
        device = (tp.first_device(params["embed"]["table"])
                  if params is not None else "cuda")
    num_groups(cfg)     # a hybrid stack must divide into groups
    layers = (list(_layers(params, cfg)) if params is not None
              else [None] * cfg.num_layers)
    return [init_kv_cache(cfg, batch, max_len, kv_dtype=kv_dtype,
                          device=device,
                          shards=(None if layers[i] is None
                                  else head_shards(layers[i]["attn"], cfg)))
            if is_attention_layer(cfg, i)
            else init_ssm_state(cfg, batch, device)
            for i in range(cfg.num_layers)]


def seed_caches_in_place(cfg: ArchConfig, caches: Caches, snapshot: Caches,
                         prefix_len: int) -> Caches:
    """Seed a tenant's own cache buffers from a shared prefix, in place
    (the buffers keep their addresses, so programs that bind them stay
    valid), leaf by leaf: a K/V leaf (:func:`is_kv_leaf`: codes and fp32
    scale leaves alike, all ``[B, T, Hkv, .]``, time on axis 1) gets rows
    ``[0, prefix_len)`` and keeps the rows past the prefix as they are;
    a recurrent leaf (``conv``, ``ssm``) adopts the snapshot's state
    wholesale (only valid at the snapshot's exact length, so an SSM or
    hybrid snapshot seeds only at its full length).  ``snapshot`` is a
    cache list some tenant of the same geometry filled through at least
    ``prefix_len`` tokens; its K/V leaves may hold only those rows.
    Returns ``caches``."""
    _require_ported(cfg)
    for dst, src in zip(caches, snapshot, strict=True):
        for name, leaf in dst.items():
            if is_kv_leaf(name):
                leaf[:, :prefix_len].copy_(src[name][:, :prefix_len])
            else:
                leaf.copy_(src[name])
    return caches


def seed_caches_from_prefix(cfg: ArchConfig, batch: int, max_len: int,
                            snapshot: Caches, prefix_len: int,
                            kv_dtype: Optional[str] = None,
                            device: Any = None) -> Caches:
    """Fresh decode caches pre-seeded with a shared KV prefix
    (src/repro/models/transformer.py::seed_caches_from_prefix):
    :func:`init_caches` buffers (zero K/V, scale leaves of ones) with
    :func:`seed_caches_in_place` applied, so the result equals the cache
    a cold tenant holds after prefilling the same ``prefix_len`` tokens.
    ``kv_dtype`` must be the snapshot's precision.  The device defaults
    to the snapshot's.  Encoder-decoder and VLM archs raise
    ``ValueError``, as the reference's (its cross-attention reads the
    encoder, not a prompt prefix).  The server seeds its tenants' own
    buffers with :func:`seed_caches_in_place` (its graphs bind them);
    this fresh-cache form is the reference's API, kept for callers and
    parity tests."""
    _require_ported(cfg)
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        raise ValueError(f"prefix seeding unsupported for family "
                         f"{cfg.family}")
    if device is None:
        device = next(iter(snapshot[0].values())).device
    fresh = init_caches(None, cfg, batch, max_len, kv_dtype=kv_dtype,
                        device=device)
    return seed_caches_in_place(cfg, fresh, snapshot, prefix_len)


def decode_step(params: Params, token: torch.Tensor, caches: Caches,
                index: Any, cfg: ArchConfig,
                enc_out: Optional[torch.Tensor] = None, plan=None,
                kv_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Caches]:
    """One decode step.  token: [B, 1] int; index: the position (a device
    int64 scalar, or a host int); ``enc_out`` [B, L_enc, d], the encoder
    output an encoder-decoder's cross-attention reads.  ``plan`` (a
    core.plan.KernelPlan) runs each dense layer's FFN through the Hopper
    kernel its grant lowered to (a Mamba2 layer's O(1) step has no plan;
    a hybrid stack's shared block runs it); ``kv_len`` bounds the
    attention read to the live cache prefix (index < kv_len).  Returns
    (logits [B, 1, V] fp32, the caches, updated in place)."""
    _require_ported(cfg)
    x = embed(params["embed"], token)
    index = _as_index(index, x.device)
    positions = index.reshape(1, 1)
    for g, (lp, xp) in enumerate(_layer_pairs(params, cfg)):
        if not is_attention_layer(cfg, g):
            x, state = _ssm_block(lp, x, cfg, state=caches[g], decode=True)
            _write_state(caches[g], state)
            continue
        x, _, _ = _dense_block(lp, x, cfg, kv_cache=caches[g],
                               cache_index=index, kv_len=kv_len,
                               positions=positions, xattn_kv=enc_out, xp=xp,
                               plan=plan)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], x), caches


def decode_epoch(params: Params, token: torch.Tensor, caches: Caches,
                 index: Any, cfg: ArchConfig, k: int, *,
                 next_token_fn: Callable[[torch.Tensor], torch.Tensor],
                 enc_out: Optional[torch.Tensor] = None,
                 plan=None, kv_len: Optional[int] = None
                 ) -> Tuple[torch.Tensor, Caches]:
    """K decode steps under one static plan, each output token fed back
    in (``next_token_fn(logits) -> [B]`` closes the loop).  token:
    [B, 1]; index: the start position (a device int64 scalar, or a host
    int); ``enc_out`` as :func:`decode_step`'s.  Returns (tokens [B, k],
    caches) and is bit-identical to k sequential :func:`decode_step`
    calls: it is exactly that loop, with nothing read back to the
    host."""
    toks = []
    tok = token
    index = _as_index(index, token.device)
    for i in range(k):
        logits, caches = decode_step(params, tok, caches, index + i, cfg,
                                     enc_out=enc_out, plan=plan,
                                     kv_len=kv_len)
        nxt = next_token_fn(logits)
        toks.append(nxt)
        tok = nxt[:, None]
    return torch.stack(toks, dim=1), caches


def prefill_chunk(params: Params, tokens: torch.Tensor, caches: Caches,
                  index: Any, cfg: ArchConfig,
                  enc_out: Optional[torch.Tensor] = None,
                  kv_len: Optional[int] = None
                  ) -> Tuple[torch.Tensor, Caches]:
    """One cache-resuming prefill chunk: forward ``tokens`` [B, S] at
    absolute positions [index, index + S), writing their KV (or carrying
    the Mamba2 state) into the caches, and return the LAST position's
    logits [B, 1, V] plus the caches.  As in the reference the chunk
    runs the plain path (no plan; an SSM layer scans at the
    architecture's chunk, whose segmentation a chunked prefill at
    chunk-aligned boundaries preserves; an MoE layer routes through
    drop-free buckets, even for a one-token chunk): the grant decides
    the chunk's size and NEC charge, not its numerics.  An
    encoder-decoder's cross-attention reads ``enc_out``.  Requires
    index + S <= max_len (and <= kv_len)."""
    _require_ported(cfg)
    x = embed(params["embed"], tokens)
    S = x.shape[1]
    index = _as_index(index, x.device)
    positions = (torch.arange(S, device=x.device)[None, :] + index)
    for g, (lp, xp) in enumerate(_layer_pairs(params, cfg)):
        if not is_attention_layer(cfg, g):
            x, state = _ssm_block(lp, x, cfg, state=caches[g])
            _write_state(caches[g], state)
            continue
        x, _, _ = _dense_block(lp, x, cfg, kv_cache=caches[g],
                               cache_index=index, kv_len=kv_len,
                               positions=positions, xattn_kv=enc_out, xp=xp,
                               moe_fast=False, moe_drop_free=True)
    x = rms_norm(params["final_norm"], x[:, -1:, :], cfg.norm_eps)
    return unembed(params["embed"], x), caches
