"""Plain PyTorch forwards of the benchmark's two model families, in
float32 with TF32 off, one layer at a time.

``hidden`` runs a dense GQA decoder (Granite-3.0-8B's block) or an
OLMoE decoder (the same block with a top-k mixture of SwiGLU experts)
over whole token rows, with no cache, no batching across lengths and no
kernel of the program.  It reads the weights the benchmark made
(``perfbench/weights.py``, the program's parameter layout) and upcasts
one layer's weights at a time, so it fits beside the bf16 weight sets.

Departures from the published models, kept because the program under
test does not model them either (each config file lists them):

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
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

NEG = -1e30


def no_tf32() -> None:
    """float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


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
    hd = arch.get("head_dim") or arch["d_model"] // H
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
