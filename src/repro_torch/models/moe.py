"""Mixture-of-Experts layer (port of src/repro/models/moe.py): top-k
routing with capacity buckets, sort-based dispatch (no one-hot matmul),
a one-token decode fast path, and, under a plan, each expert's SwiGLU
through the plan-lowered Hopper kernels.

The reference pins an expert-parallel layout with ``shard_hint`` on the
dispatch buffers, which the port drops: over a tensor-parallel group the
expert weights are split by ``distributed/sharding.py``'s MoE mode, and
the expert products run where their pieces are (:func:`_experts`,
:func:`_owned_expert_rows`); the router and the dispatch run on the
group's first device.

Two departures in how, not what, the layer computes:

* fp32 products.  Where the reference asks XLA for an fp32 result of a
  low-precision product (``preferred_element_type=jnp.float32``),
  :func:`_dot_f32` keeps it: a bf16 product on the card runs on the
  tensor cores with an fp32 output (``out_dtype``), elsewhere the
  operands are upcast.
* A fixed-order combine.  The reference adds each kept entry into its
  token's row (``y.at[tok].add``), which XLA on the CPU applies in the
  sorted entry order: per token, its K contributions in ascending expert
  id, in x's dtype, from zero.  On the card ``index_add_`` and
  ``scatter_add_`` use atomics and would not repeat bitwise, so
  :func:`moe_apply` gathers each token's K contributions in that order
  and adds them in a loop.  The dispatch needs no such care: every kept
  entry has a slot of its own, and only the drop bin (discarded) is
  written twice.

Nothing here reads the device back to the host, so a decode epoch or a
prompt chunk that runs the layer can be captured as a CUDA graph.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.models.base import ArchConfig
from repro_torch.models.layers import Params, _normal


def init_moe(gen: torch.Generator, cfg: ArchConfig) -> Params:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    dt = cfg.torch_dtype
    s = 1.0 / math.sqrt(d)
    return {"router": _normal(gen, (d, e), s, dt),
            "gate": _normal(gen, (e, d, f), s, dt),
            "up": _normal(gen, (e, d, f), s, dt),
            "down": _normal(gen, (e, f, d), 1.0 / math.sqrt(f), dt)}


def capacity(tokens_per_group: int, cfg: ArchConfig) -> int:
    c = int(tokens_per_group * cfg.experts_per_token
            * cfg.moe_capacity_factor / cfg.num_experts) + 1
    return max(4, -(-c // 4) * 4)  # pad to a multiple of 4


class _BmmF32(torch.autograd.Function):
    """bf16 ``bmm`` with an fp32 result, and its gradient: ``aten::bmm``'s
    ``out_dtype`` overload has no derivative formula, so the backward is
    written out, each product again a bf16 ``bmm`` into fp32, and each
    gradient cast to its operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = torch.bmm(g, b.transpose(1, 2), out_dtype=torch.float32)
        gb = torch.bmm(a.transpose(1, 2), g, out_dtype=torch.float32)
        return ga.to(a.dtype), gb.to(b.dtype)


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b ([n, m, k] @ [n, k, p]) with fp32 accumulation and an
    fp32 result, as the reference's ``preferred_element_type=float32``;
    bf16 on the card through :class:`_BmmF32`, which carries a
    gradient."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return _BmmF32.apply(a, b)
    return torch.bmm(a.float(), b.float())


def _expert_rows(wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
                 x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Expert ``e[i]``'s SwiGLU over row ``x[i]``: x [N, d], e [N] ids into
    ``wg`` / ``wu`` [E, d, f] and ``wd`` [E, f, d].  Returns [N, d]
    fp32."""
    xt = x[:, None, :]                                # [N, 1, d]
    h_g = _dot_f32(xt, wg[e])                         # [N, 1, f] fp32
    h_u = _dot_f32(xt, wu[e])
    h = (F.silu(h_g) * h_u).to(x.dtype)
    return _dot_f32(h, wd[e])[:, 0]


def _owned_expert_rows(wg: Any, wu: Any, wd: Any, x: torch.Tensor,
                       e: torch.Tensor) -> torch.Tensor:
    """:func:`_expert_rows` over experts split across a tensor-parallel
    group (``"fsdp"``: [E] cut into contiguous pieces): each shard runs
    the entries whose expert it holds, on its device, and each row is put
    back at its entry, on x's device.  A shard takes only its own
    entries, except inside a CUDA graph capture, where shapes may not
    depend on the routing: there it runs every entry, on an id clamped
    into its piece, and keeps its own."""
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    static = tp.capturing()
    for o, g, u, dn in zip(wg.offsets(), wg.pieces, wu.pieces, wd.pieces):
        n = g.shape[0]
        own = (e >= o) & (e < o + n)
        if static:
            y = _expert_rows(g, u, dn, x.to(g.device),
                             (e - o).clamp(0, n - 1).to(g.device))
            out = torch.where(own[:, None], y.to(x.device), out)
            continue
        idx = own.nonzero()[:, 0]
        if len(idx):
            y = _expert_rows(g, u, dn, x[idx].to(g.device),
                             (e[idx] - o).to(g.device))
            out.index_copy_(0, idx, y.to(x.device))
    return out


def _decode_moe(params: Params, x: torch.Tensor, top_p: torch.Tensor,
                top_e: torch.Tensor) -> torch.Tensor:
    """Token-granular (T == 1) expert combine: gather the top-k experts'
    weights and run their SwiGLU directly (the reference's
    ``_decode_moe``, which says why).  It ignores the KernelPlan: a
    one-token expert FFN is a GEMV with no tiling freedom, so the server
    binds no plan to MoE decode (``launch/serve.py::_dec_plan``).  The K
    contributions are summed in top-k order.  Over a tensor-parallel
    group: experts split (``"fsdp"``) -> each entry runs on the shard
    that holds its expert (:func:`_owned_expert_rows`); d_ff split
    (``"ep2d"``) -> each shard's partial outputs on its d_ff slice,
    summed in shard order in fp32."""
    G, _, d = x.shape
    K = top_e.shape[-1]
    e = top_e[:, 0].reshape(G * K)
    rows = x[:, 0][:, None, :].expand(G, K, d).reshape(G * K, d)
    wg, wu, wd = params["gate"], params["up"], params["down"]
    if not tp.is_sharded(wg):
        out = _expert_rows(wg, wu, wd, rows, e)
    elif wg.dim == 0:
        out = _owned_expert_rows(wg, wu, wd, rows, e)
    else:
        out = tp.reduce([_expert_rows(g, u, dn, rows.to(g.device),
                                      e.to(g.device))
                         for g, u, dn in zip(wg.pieces, wu.pieces,
                                             wd.pieces)], x.device)
    w = top_p[:, 0].reshape(G * K, 1).to(out.dtype)
    return (out * w).reshape(G, K, d).sum(1)[:, None, :].to(x.dtype)


def _dispatch(x: torch.Tensor, top_e: torch.Tensor, C: int, E: int
              ) -> Tuple[torch.Tensor, ...]:
    """Per group: rank each (token, expert) entry within its expert by a
    stable sort, keep the first C of each expert, and write the kept
    tokens into [E*C] slots (E*C is the drop bin).  Returns the buffer
    [G, E, C, d] and, in sorted entry order, ``order`` (entry index),
    ``slot``, ``keep`` and ``tok`` (token index), each [G, T*K]."""
    G, T, d = x.shape
    K = top_e.shape[-1]
    flat_e = top_e.reshape(G, T * K)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    # rank within expert = position - first index of that expert
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    rank = torch.arange(T * K, device=x.device) - first
    keep = rank < C
    slot = torch.where(keep, sorted_e * C + rank,
                       torch.full_like(rank, E * C))
    tok = order // K
    src = torch.gather(x, 1, tok[..., None].expand(G, T * K, d))
    buf = torch.zeros((G, E * C + 1, d), dtype=x.dtype, device=x.device)
    buf.scatter_(1, slot[..., None].expand(G, T * K, d), src)
    return buf[:, :-1].reshape(G, E, C, d), order, slot, keep, tok


def _experts_on(wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
                bufe: torch.Tensor, dtype: torch.dtype, plan: Optional[Any],
                f32: bool = False) -> torch.Tensor:
    """Experts ``[E', ...]`` over their bucket rows bufe [E', N, d]: one
    ``kops.planned_ffn`` per expert under a plan, else the batched
    products; the down product in fp32 where ``f32`` (a partial output
    that is summed before it is rounded)."""
    if plan is not None:
        from repro_torch.kernels import ops as kops
        return torch.stack([kops.planned_ffn(bufe[e], wg[e], wu[e], wd[e],
                                             plan)
                            for e in range(bufe.shape[0])])
    h_g = _dot_f32(bufe, wg)                          # [E, N, f] fp32
    h_u = _dot_f32(bufe, wu)
    h = (F.silu(h_g) * h_u).to(dtype)
    out = _dot_f32(h, wd)
    return out if f32 else out.to(dtype)


def _experts(params: Params, buf: torch.Tensor, dtype: torch.dtype,
             plan: Optional[Any]) -> torch.Tensor:
    """Every expert's SwiGLU over its bucket rows: buf [G, E, C, d] ->
    [G, E, C, d] in ``dtype``.  With a plan (a core.plan.FfnPlan), one
    ``kops.planned_ffn`` per expert on its [G*C, d] rows (fused LBM or
    tiled LWM); without, the batched products.  Over a tensor-parallel
    group each expert runs on the device that holds it (``"fsdp"``: the
    experts split), or each shard runs every expert on its d_ff slice
    and the partial outputs are summed in shard order (``"ep2d"``), the
    kernels at the shard's shapes either way."""
    G, E, C, d = buf.shape
    bufe = buf.transpose(0, 1).reshape(E, G * C, d)
    wg, wu, wd = params["gate"], params["up"], params["down"]
    if not tp.is_sharded(wg):
        oute = _experts_on(wg, wu, wd, bufe, dtype, plan)
    elif wg.dim == 0:
        oute = torch.cat([
            _experts_on(g, u, dn, bufe[o:o + g.shape[0]].to(g.device),
                        dtype, plan).to(buf.device)
            for o, g, u, dn in zip(wg.offsets(), wg.pieces, wu.pieces,
                                   wd.pieces)])
    else:
        oute = tp.reduce([
            _experts_on(g, u, dn, bufe.to(g.device), dtype, plan, f32=True)
            for g, u, dn in zip(wg.pieces, wu.pieces, wd.pieces)],
            buf.device).to(dtype)
    return oute.reshape(E, G, C, d).transpose(0, 1)


def moe_apply(params: Params, x: torch.Tensor, cfg: ArchConfig,
              plan: Optional[Any] = None, decode_fast: bool = True,
              drop_free: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [G, T, d] -> (y: [G, T, d], aux_loss fp32 scalar).

    Per group: route, rank tokens within each expert by sort, drop
    overflow beyond capacity C, scatter to [E*C, d], run the experts,
    combine with the router weights.  With ``plan`` (a
    core.plan.FfnPlan) each expert's SwiGLU runs through the
    plan-lowered kernels.  T == 1 takes :func:`_decode_moe` unless
    ``decode_fast=False`` (a prefill caller's one-token tail chunk keeps
    the bucket path).  ``drop_free=True`` sizes the buckets so that no
    token can overflow (C = T rounded up to 4), as chunked prefill needs:
    the dropping capacity depends on T, so a chunk could keep other
    tokens than the one-shot prefill."""
    G, T, d = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    C = max(4, -(-T // 4) * 4) if drop_free else capacity(T, cfg)

    logits = _dot_f32(x.reshape(1, G * T, d),
                      params["router"][None]).reshape(G, T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, K, dim=-1)                # [G, T, K]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    # load-balance auxiliary loss (Switch-style); the expert counts by a
    # fixed-size comparison, which never reads back to the host
    me = probs.mean(dim=(0, 1))                                # [E]
    hits = (top_e.reshape(-1, 1)
            == torch.arange(E, device=x.device)).sum(0)
    ce = hits.float() * (1.0 / (G * T * K))
    aux = E * torch.sum(me * ce)

    if T == 1 and decode_fast:
        return _decode_moe(params, x, top_p, top_e), aux

    buf, order, slot, keep, tok = _dispatch(x, top_e, C, E)
    out = _experts(params, buf, x.dtype, plan)                 # [G, E, C, d]

    # combine, in sorted entry order per token (ascending expert id)
    flat = out.reshape(G, E * C, d)
    idx = torch.minimum(slot, torch.full_like(slot, E * C - 1))
    vals = torch.gather(flat, 1, idx[..., None].expand(G, T * K, d))
    vals = torch.where(keep[..., None], vals, torch.zeros_like(vals))
    w = torch.gather(top_p.reshape(G, T * K), 1, order).to(vals.dtype)
    contrib = vals * w[..., None]                              # [G, T*K, d]
    # sorted position of each entry, grouped by token: a token's K
    # positions ascending is its entries in ascending expert id
    pos = torch.empty_like(order)
    pos.scatter_(1, order, torch.arange(T * K, device=x.device).expand(G, -1))
    pos = torch.sort(pos.reshape(G, T, K), dim=-1).values.reshape(G, T * K)
    contrib = torch.gather(contrib, 1, pos[..., None].expand(G, T * K, d))
    contrib = contrib.reshape(G, T, K, d)
    y = torch.zeros((G, T, d), dtype=vals.dtype, device=x.device)
    for k in range(K):
        y = y + contrib[:, :, k]
    return y.to(x.dtype), aux
