"""Hand the JAX package's params and decode caches to the port.

The reference's params are a nested dict whose leaves the caller has
turned into numpy arrays (``np.asarray`` on each JAX leaf); per-layer
leaves are stacked on axis 0 (``transformer.py::_stack_init``).  The
port keeps one dict per layer, so the stack is split.  bf16 and fp8
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
    """The port's params (dense, MoE and SSM families) from the
    reference's numpy tree: the stacked ``layers``
    (``ln1``/``attn``/``ln2``/``mlp``, an MoE ``mlp`` being
    ``{router [L, d, E], gate / up [L, E, d, f], down [L, E, f, d]}``, or
    ``ln1`` and ``mamba.{in_proj.w, conv_w, A_log, D, dt_bias,
    out_proj.w}``) become a list of per-layer dicts."""
    _require_ported(cfg)
    n = cfg.num_layers
    leaf = lambda a: tensor_from_numpy(a, device)  # noqa: E731
    return {
        "embed": _tree(tree["embed"], leaf),
        "final_norm": _tree(tree["final_norm"], leaf),
        "layers": [_tree(tree["layers"], lambda a, g=g: leaf(np.asarray(a)[g]))
                   for g in range(n)],
    }


def caches_from_numpy(tree: Any, cfg: ArchConfig,
                      device: Any = "cuda") -> List[Dict[str, torch.Tensor]]:
    """The port's decode caches (one dict per layer: K/V for the dense
    and MoE families, the recurrent state ``{conv, ssm}`` for the SSM family) from
    the reference's, leaves turned into numpy arrays: a tuple of
    per-layer dicts (stacks of at most ``_DECODE_UNROLL_MAX_GROUPS``
    groups) or one dict whose leaves stack the layers on axis 0 (deeper
    stacks).  Native K/V, int8 and fp8 codes (by bit view), fp32 scale
    leaves and SSM states all carry over bit-exactly."""
    _require_ported(cfg)
    n = num_groups(cfg)
    if isinstance(tree, dict):
        tree = [{k: np.asarray(v)[g] for k, v in tree.items()}
                for g in range(n)]
    if len(tree) != n:
        raise ValueError(f"bridge: {len(tree)} cache groups, {cfg.name} "
                         f"has {n}")
    return [{k: tensor_from_numpy(v, device) for k, v in layer.items()}
            for layer in tree]
