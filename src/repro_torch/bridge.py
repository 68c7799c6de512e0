"""Hand the JAX package's params and decode caches to the port.

The reference's params are a nested dict whose leaves the caller has
turned into numpy arrays (``np.asarray`` on each JAX leaf); per-layer
leaves are stacked on axis 0 (``transformer.py::_stack_init``; a hybrid
stack's Mamba2 leaves on axes 0 and 1, groups and layers).  The port
keeps one dict per layer, so the stack is split.  bf16 and fp8
leaves arrive as ``ml_dtypes`` arrays, which ``torch.from_numpy``
rejects: they are viewed as same-width unsigned integers and then
reinterpreted.  This module imports neither JAX nor the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.models.base import ArchConfig
from repro_torch.models.transformer import _require_ported, num_groups
from repro_torch.optim.adamw import AdamWState

# ml_dtypes name -> (numpy carrier of the same width, torch dtype)
_BIT_VIEWS = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
    "float8_e5m2": (np.uint8, torch.float8_e5m2),
}


def tensor_from_numpy(a: Any, device: Any) -> torch.Tensor:
    """One leaf, bit-exact, as a tensor on ``device``."""
    a = np.array(a, copy=True)     # writable and contiguous
    view = _BIT_VIEWS.get(a.dtype.name)
    if view is None:
        return torch.from_numpy(a).to(device)
    carrier, dtype = view
    return torch.from_numpy(a.view(carrier)).view(dtype).to(device)


def _tree(x: Any, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    return fn(x)


def params_from_numpy(tree: Dict[str, Any], cfg: ArchConfig,
                      device: Any = "cuda") -> Dict[str, Any]:
    """The port's params from the reference's numpy tree: the stacked
    ``layers`` (``ln1``/``attn``/``ln2``/``mlp``, an MoE ``mlp`` being
    ``{router [L, d, E], gate / up [L, E, d, f], down [L, E, f, d]}``, or
    ``ln1`` and ``mamba.{in_proj.w, conv_w, A_log, D, dt_bias,
    out_proj.w}``) become a list of per-layer dicts.  A hybrid stack's
    ``layers.ssm`` leaves are ``[G, attn_every - 1, ...]``: they become
    one ``{"ssm": [layer, ...]}`` dict per group, and its unstacked
    ``shared_attn`` one dense layer dict.  An encoder-decoder's
    ``encoder.layers`` (stacked over ``enc_layers``) and ``xattn``
    (``{ln, attn}`` stacked over the decoder layers) become lists of
    per-layer dicts too, beside ``encoder.final_norm``."""
    _require_ported(cfg)
    leaf = lambda a: tensor_from_numpy(a, device)  # noqa: E731
    out = {"embed": _tree(tree["embed"], leaf),
           "final_norm": _tree(tree["final_norm"], leaf)}
    G = num_groups(cfg)
    if cfg.family == "hybrid":
        n_ssm = cfg.attn_every - 1
        out["layers"] = [
            {"ssm": [_tree(tree["layers"]["ssm"],
                           lambda a, g=g, j=j: leaf(np.asarray(a)[g, j]))
                     for j in range(n_ssm)]}
            for g in range(G)]
        out["shared_attn"] = _tree(tree["shared_attn"], leaf)
    else:
        out["layers"] = _unstack(tree["layers"], G, leaf)
    if cfg.family == "encdec":
        out["encoder"] = {
            "layers": _unstack(tree["encoder"]["layers"], cfg.enc_layers,
                               leaf),
            "final_norm": _tree(tree["encoder"]["final_norm"], leaf)}
        out["xattn"] = _unstack(tree["xattn"], G, leaf)
    return out


def opt_state_from_numpy(step: Any, m: Dict[str, Any], v: Dict[str, Any],
                         cfg: ArchConfig, device: Any = "cuda") -> AdamWState:
    """The port's ``AdamWState`` from the reference's: its ``step`` (an
    int32 scalar) and its ``m`` / ``v`` trees, leaves turned into numpy
    arrays; the moments have the params' tree, so each goes through
    :func:`params_from_numpy` (bf16 moments by bit view).  Gradients,
    which also have the params' tree, come across through
    :func:`params_from_numpy` alone."""
    return AdamWState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                          device=device),
        m=params_from_numpy(m, cfg, device), v=params_from_numpy(v, cfg, device))


def _unstack(tree: Dict[str, Any], n: int, leaf) -> List[Dict[str, Any]]:
    """A tree whose leaves stack ``n`` layers on axis 0 as a list of
    ``n`` per-layer trees."""
    return [_tree(tree, lambda a, g=g: leaf(np.asarray(a)[g]))
            for g in range(n)]


def _group_layers(group: Dict[str, Any], cfg: ArchConfig) -> List[dict]:
    """One reference hybrid group's caches, ``{"ssm": {conv, ssm}`` stacked
    over its Mamba2 layers, ``"attn": K/V}``, as the port's per-layer
    dicts in execution order."""
    n_ssm = cfg.attn_every - 1
    states = [{k: np.asarray(v)[j] for k, v in group["ssm"].items()}
              for j in range(n_ssm)]
    return states + [dict(group["attn"])]


def caches_from_numpy(tree: Any, cfg: ArchConfig,
                      device: Any = "cuda") -> List[Dict[str, torch.Tensor]]:
    """The port's decode caches (one dict per layer, in execution order:
    K/V for an attention layer, the recurrent state ``{conv, ssm}`` for a
    Mamba2 layer) from the reference's, leaves turned into numpy arrays:
    a tuple of per-group dicts (stacks of at most
    ``_DECODE_UNROLL_MAX_GROUPS`` groups) or one dict whose leaves stack
    the groups on axis 0 (deeper stacks).  A hybrid group is ``{"ssm":
    states stacked over its Mamba2 layers, "attn": K/V}`` in either form.
    Native K/V, int8 and fp8 codes (by bit view), fp32 scale leaves and
    SSM states all carry over bit-exactly.  An encoder-decoder's caches
    are its decoder layers' self-attention K/V, as a dense stack's (the
    cross-attention keeps no cache)."""
    _require_ported(cfg)
    n = num_groups(cfg)
    if isinstance(tree, dict):
        tree = [_tree(tree, lambda a, g=g: np.asarray(a)[g])
                for g in range(n)]
    if len(tree) != n:
        raise ValueError(f"bridge: {len(tree)} cache groups, {cfg.name} "
                         f"has {n}")
    if cfg.family == "hybrid":
        tree = [layer for group in tree
                for layer in _group_layers(group, cfg)]
    return [{k: tensor_from_numpy(v, device) for k, v in layer.items()}
            for layer in tree]
