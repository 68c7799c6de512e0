"""Public model API of the serving slice (port of the serving entry
points of src/repro/models/model.py): params, logit masking, greedy
feedback, and the decode-step / decode-epoch / prefill-chunk closures
the server drives.  Eager PyTorch: the closures need no compilation and
take their static arguments (plan, k, kv_len) per call."""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.models.base import ArchConfig
from repro_torch.models.transformer import (decode_epoch, decode_step,
                                            init_lm, prefill_chunk)


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

    def serve_prefill_chunk(params, caches, tokens, index: int,
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

    def serve_decode_epoch(params, caches, token, index: int, enc_out=None,
                           plan=None, k: int = 1,
                           kv_len: Optional[int] = None):
        _no_enc(enc_out)
        return decode_epoch(params, token, caches, index, cfg, k,
                            next_token_fn=next_token, plan=plan,
                            kv_len=kv_len)
    return serve_decode_epoch


def make_decode_step(cfg: ArchConfig):
    """One-token serving step: (next token [B], caches).  ``plan``
    decides which Hopper kernel the step's FFNs run; ``kv_len`` bounds
    the attention read to the cache's live prefix."""
    next_token = _greedy_next_token(cfg)

    def serve_decode(params, caches, token, index: int, enc_out=None,
                     plan=None, kv_len: Optional[int] = None):
        _no_enc(enc_out)
        logits, caches = decode_step(params, token, caches, index, cfg,
                                     plan=plan, kv_len=kv_len)
        return next_token(logits), caches
    return serve_decode
