"""Primitive layers (port of src/repro/models/layers.py).

Parameters are plain nested dicts of tensors; ``init_*`` builds them from
an explicit ``torch.Generator`` with the reference's scales, and the
apply functions keep the reference's fp32 upcast and cast points.  With
a plan, the FFN runs through the port's Hopper kernels
(``kernels/ops.py``); every other matmul is a plain ``torch.matmul``,
as the reference leaves them to XLA.  A weight split over a
tensor-parallel group (``distributed/tensor_parallel.py::Sharded``)
takes the group's ops: :func:`linear`, :func:`embed` and :func:`unembed`
by the split's kind, and :func:`ffn` shard by shard on its d_ff slice.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed import tensor_parallel as tp

Params = Dict[str, Any]
DotFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def default_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with fp32 accumulation, in x's dtype (cuBLAS and the CPU
    BLAS accumulate bf16 products in fp32)."""
    return torch.matmul(x, w)


# ---------------------------------------------------------------- init --
def _normal(gen: torch.Generator, shape, scale: float,
            dtype: torch.dtype) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return x.mul_(scale).to(dtype)


def init_linear(gen: torch.Generator, d_in: int, d_out: int,
                dtype: torch.dtype) -> Params:
    return {"w": _normal(gen, (d_in, d_out), 1.0 / math.sqrt(d_in), dtype)}


def init_norm(d: int, dtype: torch.dtype,
              device: torch.device) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def init_embedding(gen: torch.Generator, vocab: int, d: int,
                   dtype: torch.dtype) -> Params:
    return {"table": _normal(gen, (vocab, d), 1.0, dtype)}


def init_ffn(gen: torch.Generator, d_model: int, d_ff: int,
             dtype: torch.dtype) -> Params:
    return {"gate": init_linear(gen, d_model, d_ff, dtype),
            "up": init_linear(gen, d_model, d_ff, dtype),
            "down": init_linear(gen, d_ff, d_model, dtype)}


# --------------------------------------------------------------- apply --
def rms_norm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def linear(params: Params, x: torch.Tensor, dot: DotFn = default_dot) -> torch.Tensor:
    if tp.is_sharded(params["w"]):
        return tp.linear(params["w"], x, dot)
    return dot(x, params["w"])


def embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    if tp.is_sharded(params["table"]):
        return tp.embed(params["table"], tokens)
    return params["table"][tokens]


def unembed(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Logits in fp32, as the reference's fp32-accumulating einsum."""
    if tp.is_sharded(params["table"]):
        return tp.unembed(params["table"], x)
    return torch.matmul(x.float(), params["table"].float().t())


def swiglu(wi_gate: Params, wi_up: Params, wo: Params, x: torch.Tensor,
           dot: DotFn = default_dot) -> torch.Tensor:
    g = linear(wi_gate, x, dot)
    u = linear(wi_up, x, dot)
    return linear(wo, F.silu(g.float()).to(x.dtype) * u, dot)


def ffn(params: Params, x: torch.Tensor, dot: DotFn = default_dot,
        plan: Optional[Any] = None) -> torch.Tensor:
    """SwiGLU FFN.  With ``plan`` (a core.plan.FfnPlan) the block runs
    through the Hopper kernels the granted candidate lowered to — fused
    LBM or tiled LWM — instead of plain matmuls.  Split over a
    tensor-parallel group (gate / up by columns, down by rows), each
    shard runs the block on its d_ff slice, the kernels at the shard's
    shapes, and the partial outputs are summed in shard order."""
    if tp.is_sharded(params["down"]["w"]):
        return _ffn_tp(params, x, dot, plan)
    if plan is None:
        return swiglu(params["gate"], params["up"], params["down"], x, dot)
    from repro_torch.kernels import ops as kops
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    y = kops.planned_ffn(x2, params["gate"]["w"], params["up"]["w"],
                         params["down"]["w"], plan)
    return y.reshape(lead + (y.shape[-1],))


def _ffn_tp(params: Params, x: torch.Tensor, dot: DotFn,
            plan: Optional[Any]) -> torch.Tensor:
    wg, wu, wd = (params[n]["w"] for n in ("gate", "up", "down"))
    parts = []
    for xr, g, u, dn in zip(tp.broadcast(x, wg.devices), wg.pieces,
                            wu.pieces, wd.pieces):
        if plan is None:
            parts.append(swiglu({"w": g}, {"w": u}, {"w": dn}, xr, dot))
            continue
        from repro_torch.kernels import ops as kops
        x2 = xr.reshape(-1, x.shape[-1])
        y = kops.planned_ffn(x2, g, u, dn, plan)
        parts.append(y.reshape(x.shape[:-1] + (y.shape[-1],)))
    return tp.reduce(parts, x.device)


# ---------------------------------------------------------------- RoPE --
def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq]."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                   # [hd/2]
    angles = positions[..., :, None].float() * freqs          # [..., seq, hd/2]
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
