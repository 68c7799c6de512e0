"""Public model API of the ported slices (port of the serving and
prefill entry points of src/repro/models/model.py): params, logit
masking, greedy feedback, the one-shot prefill, and the decode-step /
decode-epoch / prefill-chunk closures the server drives.  The closures
take their static arguments (plan, k, kv_len) per call and the position
as a device int64 scalar (or a host int), so the server can capture one
call as a CUDA graph and replay it at every position of its window."""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.models.base import ArchConfig
from repro_torch.models.transformer import (decode_epoch, decode_step,
                                            init_lm, lm_forward,
                                            prefill_chunk)


def init_params(cfg: ArchConfig, seed: int = 0, device: Any = "cuda"):
    """Random params from ``torch.Generator(device).manual_seed(seed)``.
    They are not the reference's (threefry) draws; tests hand the port
    the reference's params through :mod:`repro_torch.bridge`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return init_lm(gen, cfg)


def mask_padded_logits(logits: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Neutralize the vocab-padding rows (base.py padded_vocab) so they
    never win argmax."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    ids = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(ids < cfg.vocab_size, logits,
                       torch.full_like(logits, -1e30))


def _no_enc(enc_out) -> None:
    if enc_out is not None:
        raise NotImplementedError("encoder-decoder serving not yet ported")


def make_prefill(cfg: ArchConfig, serve: bool = False):
    """One-shot prefill: ``prefill(params, {"tokens": [B, S]}, plan)`` ->
    the last position's logits [B, V] (fp32).  ``plan`` (a
    core.plan.KernelPlan) runs attention and FFNs (each expert's, for
    MoE) through the kernels its grant lowered to, and Mamba2 layers at
    its SSD chunk (through the ssd_chunk kernel, as without a plan).
    ``serve=True`` selects the serving semantics: drop-free MoE buckets,
    as the chunked serving prefill routes (:func:`repro_torch.models
    .transformer.prefill_chunk`).  The default keeps the dropping
    capacity factor.  (In the reference ``serve`` also unrolls its
    shallow-stack layer scan; the port has one Python layer loop.)"""

    def prefill(params, batch, plan=None):
        logits, _ = lm_forward(params, batch["tokens"], cfg,
                               embeds_prefix=batch.get("embeds_prefix"),
                               plan=plan, serve_prefill=serve)
        return logits[:, -1, :]
    return prefill


def _greedy_next_token(cfg: ArchConfig):
    """Greedy decode feedback: logits [B, 1, V] -> next token [B]."""
    def next_token(logits: torch.Tensor) -> torch.Tensor:
        return torch.argmax(mask_padded_logits(logits, cfg)[:, -1, :], dim=-1)
    return next_token


def make_prefill_chunk(cfg: ArchConfig):
    """Cache-resuming prefill chunk for the continuous-batching server:
    writes one prompt chunk's KV into the live caches at ``index`` and
    returns (next_token [B, 1] — the greedy token of the chunk's last
    position, meaningful for the final chunk — and the caches)."""
    next_token = _greedy_next_token(cfg)

    def serve_prefill_chunk(params, caches, tokens, index,
                            enc_out=None, kv_len: Optional[int] = None):
        _no_enc(enc_out)
        logits, caches = prefill_chunk(params, tokens, caches, index, cfg,
                                       kv_len=kv_len)
        return next_token(logits)[:, None], caches
    return serve_prefill_chunk


def make_decode_epoch(cfg: ArchConfig):
    """K-token serving epoch with greedy token feedback.  Returns
    (tokens [B, k], caches); bit-identical to k sequential
    :func:`make_decode_step` calls feeding each token back in."""
    next_token = _greedy_next_token(cfg)

    def serve_decode_epoch(params, caches, token, index, enc_out=None,
                           plan=None, k: int = 1,
                           kv_len: Optional[int] = None):
        _no_enc(enc_out)
        return decode_epoch(params, token, caches, index, cfg, k,
                            next_token_fn=next_token, plan=plan,
                            kv_len=kv_len)
    return serve_decode_epoch


def make_decode_epoch_batched(cfg: ArchConfig):
    """Plan-bucketed batched epoch (port of the reference's
    ``make_decode_epoch_batched``): tenants of one arch sharing a
    KernelPlan decode as one call.  ``params`` and ``caches`` are lists
    with one entry per tenant; ``token`` [n, B, 1] and ``index`` [n]
    carry a leading tenant axis.  Returns (tokens [n, B, k], caches);
    each tenant's slice is bit-identical to its own
    :func:`make_decode_epoch` call.

    The reference stacks the params and vmaps the epoch.  Here the call
    runs each tenant's epoch in turn: at full width one yi-9b tenant's
    bf16 params are ~17 GB, and a stacked copy of a bucket would not fit
    beside the tenants on an 80 GB card.  Captured as one CUDA graph, the
    bucket still costs the host one replay.  The caches stay per tenant
    and are updated in place, so nothing is unstacked afterwards."""
    next_token = _greedy_next_token(cfg)

    def serve_decode_epoch_batched(params, caches, token, index,
                                   enc_out=None, plan=None, k: int = 1,
                                   kv_len: Optional[int] = None):
        _no_enc(enc_out)
        toks = [decode_epoch(p, token[i], c, index[i], cfg, k,
                             next_token_fn=next_token, plan=plan,
                             kv_len=kv_len)[0]
                for i, (p, c) in enumerate(zip(params, caches))]
        return torch.stack(toks), caches
    return serve_decode_epoch_batched


def make_decode_step(cfg: ArchConfig):
    """One-token serving step: (next token [B], caches).  ``plan``
    decides which Hopper kernel the step's FFNs run (an SSM step has
    none); ``kv_len`` bounds the attention read to the cache's live
    prefix."""
    next_token = _greedy_next_token(cfg)

    def serve_decode(params, caches, token, index, enc_out=None,
                     plan=None, kv_len: Optional[int] = None):
        _no_enc(enc_out)
        logits, caches = decode_step(params, token, caches, index, cfg,
                                     plan=plan, kv_len=kv_len)
        return next_token(logits), caches
    return serve_decode
