"""Weight sets made on the device from the run's seed, in the program's
parameter layout (a dict per layer, one tensor per leaf), handed both to
the server (``params_fn``) and to the reference.

Each kind of leaf is drawn for every layer at once from one
``torch.Generator`` on the device, in the served dtype, and each layer's
leaf is a contiguous view of that block: a few large calls per weight
set, nothing made on the host.  Scales follow the usual initialisation:
1/sqrt(fan_in) for projections, RMSNorm scales uniform in [0.5, 1.5]
so that the norm's multiply is not a no-op, and 2/sqrt(d_model) for the
(tied) embedding, so that the logits spread over a few units, as a
trained model's do, and near-ties between the top tokens occur: with a
unit-scale table the logits spread over ~sqrt(d_model) and no rounding
of either side could change a greedy token.
"""
from __future__ import annotations

import hashlib
from typing import Any, Dict

import torch


def instance_seed(seed: int, instance: int) -> int:
    """A generator seed for one weight set of one run (64 bits)."""
    h = hashlib.sha256(f"weights:{seed}:{instance}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def _normal(gen: torch.Generator, shape, scale: float,
            dtype: torch.dtype) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=dtype, device=gen.device)
    return x.mul_(scale)


def make(arch: Dict[str, Any], seed: int, instance: int,
         device: Any) -> Dict[str, Any]:
    """One weight set: ``{"embed": {"table"}, "layers": [{"ln1", "attn":
    {"wq", "wk", "wv", "wo"}, "ln2", "mlp"}], "final_norm"}``; ``mlp`` is
    ``{"gate", "up", "down"}`` ({"w"} each) for a dense arch and
    ``{"router", "gate", "up", "down"}`` ([E, ...] tensors) for an MoE
    one."""
    dt = getattr(torch, arch["dtype"])
    gen = torch.Generator(device=device)
    gen.manual_seed(instance_seed(seed, instance))
    L, d = arch["num_layers"], arch["d_model"]
    H, Hkv = arch["num_heads"], arch["num_kv_heads"]
    hd = arch.get("head_dim") or d // H
    f, E = arch["d_ff"], arch["num_experts"]
    vocab = -(-arch["vocab_size"] // 256) * 256
    table = _normal(gen, (vocab, d), 2.0 * d ** -0.5, dt)
    norms = torch.rand((2 * L + 1, d), generator=gen, dtype=dt,
                       device=gen.device).add_(0.5)
    wq = _normal(gen, (L, d, H * hd), d ** -0.5, dt)
    wk = _normal(gen, (L, d, Hkv * hd), d ** -0.5, dt)
    wv = _normal(gen, (L, d, Hkv * hd), d ** -0.5, dt)
    wo = _normal(gen, (L, H * hd, d), (H * hd) ** -0.5, dt)
    if E:
        router = _normal(gen, (L, d, E), d ** -0.5, dt)
        gate = _normal(gen, (L, E, d, f), d ** -0.5, dt)
        up = _normal(gen, (L, E, d, f), d ** -0.5, dt)
        down = _normal(gen, (L, E, f, d), f ** -0.5, dt)
    else:
        gate = _normal(gen, (L, d, f), d ** -0.5, dt)
        up = _normal(gen, (L, d, f), d ** -0.5, dt)
        down = _normal(gen, (L, f, d), f ** -0.5, dt)
    layers = []
    for i in range(L):
        mlp = ({"router": router[i], "gate": gate[i], "up": up[i],
                "down": down[i]} if E else
               {"gate": {"w": gate[i]}, "up": {"w": up[i]},
                "down": {"w": down[i]}})
        layers.append({"ln1": {"scale": norms[2 * i]},
                       "attn": {"wq": {"w": wq[i]}, "wk": {"w": wk[i]},
                                "wv": {"w": wv[i]}, "wo": {"w": wo[i]}},
                       "ln2": {"scale": norms[2 * i + 1]},
                       "mlp": mlp})
    return {"embed": {"table": table}, "layers": layers,
            "final_norm": {"scale": norms[2 * L]}}
