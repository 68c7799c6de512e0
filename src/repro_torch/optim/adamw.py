"""AdamW with global-norm clipping and a cosine schedule (port of
src/repro/optim/adamw.py: ``AdamWState`` :16, ``AdamWConfig`` :23,
``cosine_schedule`` :38, ``init`` :47, ``global_norm`` :55,
``clip_by_global_norm`` :61, ``update`` :68).

Functional, as the reference: ``update`` returns new param and state
trees and changes nothing in place, under ``torch.no_grad``.  Trees are
the port's nested dicts, lists and tuples of tensors; leaves are visited
with dict keys sorted, the reference's ``jax.tree_util`` order.  The cast
points are the reference's: grads to fp32, m and v stored in
``state_dtype``, weight decay only on leaves of two or more dims, each
new param cast back to its own dtype.  ``step`` is a 0-d int32 tensor on
the params' device.  ``torch.optim`` is not used: its AdamW is a
different update (decay applied before the step, no global clipping).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Tuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    # "float32" | "bfloat16": m and v in bf16 halve the optimizer's memory
    state_dtype: str = "float32"


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the trees of the same
    structure in ``rest``; dicts, lists and tuples are nodes."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves in the reference's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init(params: Any, state_dtype: str = "float32") -> AdamWState:
    dt = getattr(torch, state_dtype)
    device = tree_leaves(params)[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), gn


@torch.no_grad()
def update(cfg: AdamWConfig, grads: Any, state: AdamWState, params: Any
           ) -> Tuple[Any, AdamWState, dict]:
    grads = tree_map(lambda g: g.float(), grads)
    grads, gn = clip_by_global_norm(grads, cfg.clip_norm)
    step = state.step + 1
    lr = cosine_schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()

    sdt = getattr(torch, cfg.state_dtype)
    new_m = tree_map(lambda m, g: (cfg.b1 * m.float() + (1 - cfg.b1) * g)
                     .to(sdt), state.m, grads)
    new_v = tree_map(lambda v, g: (cfg.b2 * v.float()
                                   + (1 - cfg.b2) * torch.square(g)).to(sdt),
                     state.v, grads)

    def upd(p, m, v):
        mhat = m.float() / b1c
        vhat = v.float() / b2c
        step_ = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.dim() >= 2:
            step_ = step_ + cfg.weight_decay * p.float()
        return (p.float() - lr * step_).to(p.dtype)

    new_params = tree_map(upd, params, new_m, new_v)
    return new_params, AdamWState(step, new_m, new_v), {
        "grad_norm": gn, "lr": lr}
