"""Public model API of the port (port of src/repro/models/model.py):
params, logit masking, the training loss and step, greedy feedback,
the one-shot prefill, the decode-step / decode-epoch / prefill-chunk
closures the server drives, and the dry run's input shapes and specs.
The closures take their static arguments (plan, k, kv_len) per call and
the position as a device int64 scalar (or a host int), so the server
can capture one call as a CUDA graph and replay it at every position of
its window.

``input_specs(cfg, shape)`` gives stand-ins for every input of the step
function named by the shape kind, as the reference's (:304): fake
tensors, built inside the caller's ``FakeTensorMode`` by the port's own
``init_params``, ``transformer.init_caches`` and ``adamw.init``, so
nothing is allocated.  Their layout is the port's: a list per layer,
where the reference stacks the layer dims.

  train_*    -> train_step(params, opt_state, batch)
  prefill_*  -> prefill(params, batch)
  decode_* / long_* -> serve_decode(params, caches, token, index)

The reference's ``decode_epoch_input_specs`` (:274) has no counterpart:
its one caller, the reference server's AOT precompiler, is replaced in
the port by graph capture (``launch/serve.py``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import transformer
from repro_torch.models.base import ArchConfig
from repro_torch.models.transformer import (decode_epoch, decode_step,
                                            init_lm, lm_forward,
                                            prefill_chunk)
from repro_torch.optim import adamw


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 500k ctx needs sub-quadratic attn"
    return True, ""


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


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            remat: bool = True):
    """Next-token cross-entropy plus 0.01 x the MoE aux loss, over the
    token positions only (a VLM's patch prefix is conditioning context;
    an encoder-decoder's logits cover its tokens already), padded vocab
    rows masked, under remat, as the reference's ``loss_fn`` (:64);
    ``remat=False`` keeps the activations instead (the same numbers).
    Returns (loss, {"ce", "aux"}), fp32 scalars."""
    prefix = batch.get("embeds_prefix")
    logits, aux = lm_forward(params, batch["tokens"], cfg,
                             embeds_prefix=prefix, remat=remat)
    if prefix is not None and cfg.family != "encdec":
        logits = logits[:, prefix.shape[1]:, :]
    labels = batch["labels"]
    logits = mask_padded_logits(logits[:, :-1, :].float(), cfg)
    tgt = labels[:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tgt[..., None])[..., 0]
    ce = (logz - gold).mean()
    aux = torch.as_tensor(aux, dtype=torch.float32, device=ce.device)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def _value_and_grad(params, batch, cfg: ArchConfig, remat: bool = True):
    """(loss, metrics, grads) of :func:`loss_fn`: the grads a tree like
    ``params``, each in its param's dtype (zeros for a param the loss
    does not reach)."""
    leaves = adamw.tree_leaves(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    swap = dict(zip(map(id, leaves), live))
    loss, metrics = loss_fn(adamw.tree_map(lambda p: swap[id(p)], params),
                            batch, cfg, remat=remat)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = {id(p): torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            adamw.tree_map(lambda p: grads[id(p)], params))


def make_train_step(cfg: ArchConfig,
                    opt_cfg: Optional[adamw.AdamWConfig] = None,
                    microbatches: int = 1):
    """The training step (ref :81): ``train_step(params, opt_state,
    batch)`` -> (params, opt_state, metrics ``loss``, ``ce``, ``aux``,
    ``grad_norm``, ``lr``).  ``microbatches > 1`` splits the batch on
    its leading axis and sums the micro-steps' grads in fp32, in order,
    then divides, as the reference's ``lax.scan`` of micro-steps; the
    loss and metrics are the micro-steps' means."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, metrics, grads = _value_and_grad(params, batch, cfg)
        else:
            micro = [{k: v.reshape((microbatches, v.shape[0] // microbatches)
                                   + v.shape[1:])[i]
                      for k, v in batch.items()} for i in range(microbatches)]
            gsum = adamw.tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            lsum, ms = 0.0, []
            for mb in micro:
                loss, metrics, g = _value_and_grad(params, mb, cfg)
                gsum = adamw.tree_map(lambda a, b: a + b.float(), gsum, g)
                lsum = lsum + loss
                ms.append(metrics)
            grads = adamw.tree_map(lambda g: g / microbatches, gsum)
            loss = lsum / microbatches
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        params, opt_state, opt_metrics = adamw.update(opt_cfg, grads,
                                                      opt_state, params)
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step


def make_prefill(cfg: ArchConfig, serve: bool = False):
    """One-shot prefill: ``prefill(params, {"tokens": [B, S]}, plan)`` ->
    the last position's logits [B, V] (fp32).  The batch may carry
    ``embeds_prefix`` [B, P, d]: a VLM's patch embeddings, prepended to
    the tokens (the last position is the last token's), or an
    encoder-decoder's audio frames, which the encoder runs over.
    ``plan`` (a core.plan.KernelPlan) runs attention and FFNs (each
    expert's, for MoE) through the kernels its grant lowered to, and
    Mamba2 layers at its SSD chunk (through the ssd_chunk kernel, as
    without a plan).
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
        logits, caches = prefill_chunk(params, tokens, caches, index, cfg,
                                       enc_out=enc_out, kv_len=kv_len)
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
        return decode_epoch(params, token, caches, index, cfg, k,
                            next_token_fn=next_token, enc_out=enc_out,
                            plan=plan, kv_len=kv_len)
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
    and are updated in place, so nothing is unstacked afterwards.
    ``enc_out`` (an encoder-decoder's) is indexed by tenant: a list of
    each tenant's own encoder output, or a stacked [n, B, L, d] tensor
    as the reference's."""
    next_token = _greedy_next_token(cfg)

    def serve_decode_epoch_batched(params, caches, token, index,
                                   enc_out=None, plan=None, k: int = 1,
                                   kv_len: Optional[int] = None):
        toks = [decode_epoch(p, token[i], c, index[i], cfg, k,
                             next_token_fn=next_token,
                             enc_out=enc_out[i] if enc_out is not None
                             else None, plan=plan, kv_len=kv_len)[0]
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
        logits, caches = decode_step(params, token, caches, index, cfg,
                                     enc_out=enc_out, plan=plan,
                                     kv_len=kv_len)
        return next_token(logits), caches
    return serve_decode


# ---------------------------------------------------------- input specs --
def _require_fake_mode() -> None:
    """The specs are full-width trees: built outside a ``FakeTensorMode``
    they would allocate every byte they describe."""
    from torch._guards import detect_fake_mode
    if detect_fake_mode() is None:
        raise RuntimeError("input specs are built inside a "
                           "torch._subclasses.fake_tensor.FakeTensorMode")


def _spec(shape, dtype: torch.dtype, device: Any = "cpu") -> torch.Tensor:
    _require_fake_mode()
    return torch.empty(shape, dtype=dtype, device=device)


def batch_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """The data batch of a train / prefill step (ref :231), at
    ``shape.global_batch``: int32 tokens and labels, and an fp32
    ``embeds_prefix`` for an encoder-decoder (its frames) or a VLM (its
    patches, which take ``num_patches`` of the sequence)."""
    B, S, d = shape.global_batch, shape.seq_len, cfg.d_model
    out: Dict[str, Any] = {}
    if cfg.family == "encdec":
        out["embeds_prefix"] = _spec((B, cfg.enc_len, d), torch.float32)
    elif cfg.family == "vlm":
        out["embeds_prefix"] = _spec((B, cfg.num_patches, d), torch.float32)
        S -= cfg.num_patches
    out["tokens"] = _spec((B, S), torch.int32)
    out["labels"] = _spec((B, S), torch.int32)
    return out


def cache_specs(cfg: ArchConfig, batch: int, max_len: int,
                kv_dtype: Optional[str] = None, params: Any = None):
    """Decode caches (ref :252) from ``transformer.init_caches``: whole,
    on the CPU, or, given a tensor-parallel group's ``params``, in that
    group's layout (a head-split attention's cache one piece a shard)."""
    _require_fake_mode()
    return transformer.init_caches(params, cfg, batch, max_len,
                                   kv_dtype=kv_dtype,
                                   device=None if params is not None
                                   else "cpu")


def param_specs_shapes(cfg: ArchConfig):
    """Full params (ref :258) from :func:`init_params`, on the CPU."""
    _require_fake_mode()
    return init_params(cfg, device="cpu")


def opt_specs_shapes(params_shapes):
    """AdamW state (ref :263) from ``adamw.init``."""
    _require_fake_mode()
    return adamw.init(params_shapes)


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Every step-function input, keyed by argument name (ref :304)."""
    params = param_specs_shapes(cfg)
    if shape.kind == "train":
        return {"params": params,
                "opt_state": opt_specs_shapes(params),
                "batch": batch_specs(cfg, shape)}
    if shape.kind == "prefill":
        return {"params": params, "batch": batch_specs(cfg, shape)}
    # decode: one new token against caches of length seq_len
    B = shape.global_batch
    out = {"params": params,
           "caches": cache_specs(cfg, B, shape.seq_len),
           "token": _spec((B, 1), torch.int32),
           "index": _spec((), torch.int32)}
    if cfg.family == "encdec":
        out["enc_out"] = _spec((B, cfg.enc_len, cfg.d_model),
                               cfg.torch_dtype)
    return out
