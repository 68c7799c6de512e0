"""The dense GQA decoder with SwiGLU FFNs (Granite-3.0-8B's block) and
its mixture-of-experts form (OLMoE's: the same block with a top-k softmax
router over SwiGLU experts, every expert on the chip): weights, plain
reference and FLOP count.  The contract is ``families/__init__.py``'s.

Weights (``make``): each kind of leaf is drawn for every layer at once
from one ``torch.Generator`` on the device, in the served dtype, and each
layer's leaf is a contiguous view of that block: a few large calls per
weight set, nothing made on the host.  Scales follow the usual
initialisation: 1/sqrt(fan_in) for projections, RMSNorm scales uniform in
[0.5, 1.5] so that the norm's multiply is not a no-op, and 2/sqrt(d_model)
for the (tied) embedding, so that the logits spread over a few units, as a
trained model's do, and near-ties between the top tokens occur: with a
unit-scale table the logits spread over ~sqrt(d_model) and no rounding of
either side could change a greedy token.

Reference (``hidden``, ``logits``): whole token rows, no cache, no
batching across lengths, float32 one layer at a time.  Departures from the
published models, kept because the program under test does not model them
either (each config file lists them):

* Granite: the embedding, residual, attention and logit multipliers are
  1 (plain pre-norm residuals, 1/sqrt(head_dim) attention scale,
  unscaled logits).
* OLMoE: no QK-norm; the LM head is the embedding table (tied); the
  top-k router weights are renormalized to sum to 1; RoPE theta 1e6.
* Both: the vocabulary is padded to a multiple of 256 and the padding
  logits are masked.

``quant="fp8"`` is the control: every linear layer's weight (per output
column) and input (per row) are rounded to float8 e4m3 before an fp32
product, the precision a later change might be tempted to serve in.

FLOP count (``span_flops``): the q, k, v and o projections, the FFN or
the routed experts and the router, and the logits of every token, and
attention's scores and context over each token's causal context.
"""
from __future__ import annotations

import hashlib
import math
from typing import Any, Dict, Optional

import torch

NEG = -1e30


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
    hd = head_dim(arch)
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


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``
    (the slice's largest magnitude maps to 448), returned in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def _linear(x: torch.Tensor, w: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    w = w.float()
    if quant == "fp8":
        return _fp8(x, -1) @ _fp8(w, 0)
    return x @ w


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale.float()


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on [r, T, h, hd], the two halves of each head
    rotated together (GPT-NeoX style), positions 0..T-1."""
    T, hd = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, hd, 2, device=x.device,
                                  dtype=torch.float32) / hd)
    ang = torch.arange(T, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(p: Dict[str, Any], h: torch.Tensor, arch: Dict[str, Any],
               quant: Optional[str]) -> torch.Tensor:
    r, T, _ = h.shape
    H, Hkv = arch["num_heads"], arch["num_kv_heads"]
    hd = head_dim(arch)
    q = _linear(h, p["wq"]["w"], quant).reshape(r, T, H, hd)
    k = _linear(h, p["wk"]["w"], quant).reshape(r, T, Hkv, hd)
    v = _linear(h, p["wv"]["w"], quant).reshape(r, T, Hkv, hd)
    q, k = _rope(q, arch["rope_theta"]), _rope(k, arch["rope_theta"])
    rep = H // Hkv
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    causal = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
    ctx = torch.empty(r, T, H, hd, device=h.device)
    for i in range(r):          # one row at a time: scores are [H, T, T]
        s = torch.einsum("qhd,khd->hqk", q[i], k[i]) / math.sqrt(hd)
        s = s.masked_fill(~causal, NEG).softmax(-1)
        ctx[i] = torch.einsum("hqk,khd->qhd", s, v[i])
    return _linear(ctx.reshape(r, T, H * hd), p["wo"]["w"], quant)


def _swiglu(h: torch.Tensor, wg, wu, wd, quant: Optional[str]) -> torch.Tensor:
    g = _linear(h, wg, quant)
    return _linear(torch.nn.functional.silu(g) * _linear(h, wu, quant), wd, quant)


def _moe(p: Dict[str, Any], h: torch.Tensor, arch: Dict[str, Any],
         quant: Optional[str]) -> torch.Tensor:
    """Top-k of E experts per token, weights renormalized over the k,
    every routed token computed (no capacity, nothing dropped)."""
    shape = h.shape
    x = h.reshape(-1, shape[-1])
    probs = _linear(x, p["router"], None).softmax(-1)
    top_p, top_e = probs.topk(arch["experts_per_token"], dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(arch["num_experts"]):
        tok, slot = (top_e == e).nonzero(as_tuple=True)
        if len(tok) == 0:
            continue
        y = _swiglu(x[tok], p["gate"][e], p["up"][e], p["down"][e], quant)
        out.index_add_(0, tok, y * top_p[tok, slot, None])
    return out.reshape(shape)


def hidden(weights: Dict[str, Any], arch: Dict[str, Any],
           tokens: torch.Tensor, quant: Optional[str] = None) -> torch.Tensor:
    """Final normed hidden states [r, T, d] (float32) of token rows
    ``tokens`` [r, T], each row from position 0, causal."""
    eps = arch["norm_eps"]
    x = weights["embed"]["table"][tokens].float()
    for p in weights["layers"]:
        x = x + _attention(p["attn"], _rms(x, p["ln1"]["scale"], eps), arch,
                           quant)
        h = _rms(x, p["ln2"]["scale"], eps)
        m = p["mlp"]
        if arch["num_experts"]:
            x = x + _moe(m, h, arch, quant)
        else:
            x = x + _swiglu(h, m["gate"]["w"], m["up"]["w"], m["down"]["w"],
                            quant)
    return _rms(x, weights["final_norm"]["scale"], eps)


def logits(weights: Dict[str, Any], arch: Dict[str, Any], h: torch.Tensor,
           quant: Optional[str] = None) -> torch.Tensor:
    """Logits [..., padded vocab] of hidden states ``h`` against the tied
    embedding table, the padding columns masked."""
    table = weights["embed"]["table"]
    out = _linear(h, table.t(), quant)
    out[..., arch["vocab_size"]:] = NEG
    return out


def head_dim(arch: Dict[str, Any]) -> int:
    return arch.get("head_dim") or arch["d_model"] // arch["num_heads"]


def matmul_flops_per_token(arch: Dict[str, Any]) -> int:
    """Multiply-add operations (x2) of one token's projections, FFN or
    routed experts and router, in every layer, and its logits."""
    d, L = arch["d_model"], arch["num_layers"]
    hd = head_dim(arch)
    q, kv = arch["num_heads"] * hd, arch["num_kv_heads"] * hd
    attn = d * q + 2 * d * kv + q * d
    f = arch["d_ff"]
    if arch.get("num_experts"):
        ffn = arch["experts_per_token"] * 3 * d * f + d * arch["num_experts"]
    else:
        ffn = 3 * d * f
    return 2 * (L * (attn + ffn) + d * arch["vocab_size"])


def span_flops(arch: Dict[str, Any], start: int, stop: int) -> int:
    """One row's model operations for the tokens at positions
    [start, stop), each attending causally over itself and every earlier
    position."""
    if stop <= start:
        return 0
    n = stop - start
    ctx_sum = (start + 1 + stop) * n // 2          # sum of p + 1 over the span
    return (n * matmul_flops_per_token(arch)
            + 4 * arch["num_layers"] * arch["num_heads"] * head_dim(arch)
            * ctx_sum)
