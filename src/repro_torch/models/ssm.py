"""Mamba2 / SSD (state-space duality) blocks (port of
src/repro/models/ssm.py).

The chunked SSD algorithm (arXiv:2405.21060): an intra-chunk part that
is quadratic within a chunk, and an inter-chunk state recurrence.  Here
the intra-chunk part (y_diag and the chunk states) runs through
``kernels/ops.py::ssd_intra_chunk``, the ssd_chunk kernel on the card
and its plain version on the CPU; the reference's ``ssd`` computes the
same quantities with ``einsum`` and keeps its Pallas kernel for tests.
The inter-chunk recurrence is a loop over chunks, as the reference's
``lax.scan``, and the inter-chunk output ``y_off`` keeps the reference's
cast points.  ``ssd_decode_step`` is the O(1) recurrent step of the
serving path (state cache instead of a KV cache), plain torch as in the
reference.

Precision: the reference casts the intra-chunk weights and
``decay_out * dt`` to x's dtype before its contractions; the kernel
keeps them in fp32, like the reference's TPU kernel.  In fp32 the two
differ only in the order of summation; in bf16 the port is the more
precise.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.base import ArchConfig
from repro_torch.models.layers import Params, _normal, init_linear, linear

CONV_K = 4  # causal depthwise conv kernel width


def init_mamba2(gen: torch.Generator, cfg: ArchConfig) -> Params:
    d, di, n, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * n
    dt, dev = cfg.torch_dtype, gen.device
    return {
        # in_proj -> [z (di), x (di), B (n), C (n), dt (nh)]
        "in_proj": init_linear(gen, d, 2 * di + 2 * n + nh, dt),
        "conv_w": _normal(gen, (CONV_K, conv_dim), 1.0 / math.sqrt(CONV_K),
                          dt),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, device=dev)),
        "D": torch.ones((nh,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "out_proj": init_linear(gen, di, d, dt),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d.  x: [b, s, c]; w: [k, c].
    Returns (y, new_state [b, k-1, c])."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    return y, xp[:, -(k - 1):, :]


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, D: torch.Tensor, chunk: int,
        h0: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked state-space dual scan.

    x: [b, s, h, p]  dt: [b, s, h]  A: [h] (positive; decay = exp(-dt*A))
    B, C: [b, s, n]  D: [h].  Returns (y [b,s,h,p], final state [b,h,n,p]
    fp32)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"seq {s} not divisible by chunk {chunk}")
    c = s // chunk

    # ---- intra-chunk: y_diag and the chunk states, one kernel ---------
    # heads ride the batch axis of the kernel (bh = b * h + head); B and C
    # stay [b, s, n], shared by the heads of a batch row
    y_diag, S = ops.ssd_intra_chunk(
        x.permute(0, 2, 1, 3).reshape(b * h, s, p),
        dt.permute(0, 2, 1).reshape(b * h, s), A.repeat(b), B, C, chunk)
    y_diag = y_diag.reshape(b, h, c, chunk, p).permute(0, 2, 3, 1, 4)
    S = S.reshape(b, h, c, n, p).transpose(1, 2)                # [b,c,h,n,p]

    # ---- inter-chunk recurrence ----------------------------------------
    dA = -dt.reshape(b, c, chunk, h) * A                        # [b,c,q,h]
    cum = torch.cumsum(dA, dim=2)
    chunk_decay = torch.exp(cum[:, :, -1, :])                   # [b,c,h]
    hprev = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
             if h0 is None else h0)
    hstarts = []
    for i in range(c):
        hstarts.append(hprev)
        hprev = hprev * chunk_decay[:, i, :, None, None] + S[:, i]
    hstarts = torch.stack(hstarts, dim=1)                       # [b,c,h,n,p]

    # ---- inter-chunk contribution ---------------------------------------
    # the reference's operands, cast to x's dtype, contracted in fp32
    decay_in = torch.exp(cum).to(x.dtype).float()               # [b,c,q,h]
    Cr = C.reshape(b, c, chunk, n).float()
    y_off = torch.einsum("bcqn,bchnp->bcqhp", Cr,
                         hstarts.to(x.dtype).float()) * decay_in[..., None]

    y = (y_diag + y_off).reshape(b, s, h, p) + D[None, None, :, None] * x.float()
    return y.to(x.dtype), hprev


def mamba2_forward(params: Params, x: torch.Tensor, cfg: ArchConfig,
                   state: Optional[Dict[str, torch.Tensor]] = None,
                   chunk: Optional[int] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full Mamba2 block over a sequence.  x: [b, s, d].

    ``chunk`` overrides the architecture's SSD chunk (the KernelPlan
    path); it applies only when it divides the sequence length.  A
    sequence that is not a multiple of the SSD chunk runs the aligned
    prefix through the chunked scan and the remainder as one final chunk
    of its own length, carrying the state across the split: the
    segmentation is ``[chunk]*n + [tail]``, the one a chunked prefill at
    chunk-aligned boundaries produces."""
    b, s, d = x.shape
    ssd_chunk_len = cfg.ssm_chunk
    if chunk and chunk > 0 and s % chunk == 0:
        ssd_chunk_len = chunk
    di, n, nh, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    zxbcdt = linear(params["in_proj"], x)
    z, xs, B, C, dt = torch.split(zxbcdt, [di, di, n, n, nh], dim=-1)
    conv_in = torch.cat([xs, B, C], dim=-1)
    conv_state = state["conv"] if state else None
    conv_out, new_conv = _causal_conv(conv_in, params["conv_w"], conv_state)
    conv_out = F.silu(conv_out.float()).to(x.dtype)
    xs, B, C = torch.split(conv_out, [di, n, n], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = torch.exp(params["A_log"])
    xh = xs.reshape(b, s, nh, p)
    h0 = state["ssm"] if state else None
    s_main = (s // ssd_chunk_len) * ssd_chunk_len
    if s_main == s:
        y, hfin = ssd(xh, dt, A, B, C, params["D"], ssd_chunk_len, h0)
    else:
        parts, hfin = [], h0
        if s_main:
            y1, hfin = ssd(xh[:, :s_main], dt[:, :s_main], A, B[:, :s_main],
                           C[:, :s_main], params["D"], ssd_chunk_len, hfin)
            parts.append(y1)
        y2, hfin = ssd(xh[:, s_main:], dt[:, s_main:], A, B[:, s_main:],
                       C[:, s_main:], params["D"], s - s_main, hfin)
        parts.append(y2)
        y = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    y = y.reshape(b, s, di)
    y = y * F.silu(z.float()).to(x.dtype)
    out = linear(params["out_proj"], y)
    return out, {"conv": new_conv, "ssm": hfin}


def ssd_decode_step(params: Params, x: torch.Tensor, cfg: ArchConfig,
                    state: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """O(1) recurrent step.  x: [b, 1, d]; state {conv, ssm}.  The
    returned state keeps the input state's dtypes."""
    b = x.shape[0]
    di, n, nh, p = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    zxbcdt = linear(params["in_proj"], x)
    z, xs, B, C, dt = torch.split(zxbcdt, [di, di, n, n, nh], dim=-1)
    conv_in = torch.cat([xs, B, C], dim=-1)
    conv_out, new_conv = _causal_conv(conv_in, params["conv_w"],
                                      state["conv"])
    conv_out = F.silu(conv_out.float()).to(x.dtype)
    xs, B, C = torch.split(conv_out, [di, n, n], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"])[:, 0]      # [b,nh]
    A = torch.exp(params["A_log"])
    dA = torch.exp(-dt * A)                                     # [b,nh]
    xh = xs.reshape(b, nh, p).float()
    Bf = B[:, 0].float()                                        # [b,n]
    Cf = C[:, 0].float()
    h = state["ssm"] * dA[:, :, None, None] + (
        dt[:, :, None, None] * Bf[:, None, :, None] * xh[:, :, None, :])
    y = torch.einsum("bn,bhnp->bhp", Cf, h) + params["D"][None, :, None] * xh
    y = y.reshape(b, 1, di).to(x.dtype)
    y = y * F.silu(z.float()).to(x.dtype)
    return linear(params["out_proj"], y), {
        "conv": new_conv.to(state["conv"].dtype),
        "ssm": h.to(state["ssm"].dtype)}


def init_ssm_state(cfg: ArchConfig, batch: int,
                   device: Any = "cuda") -> Dict[str, torch.Tensor]:
    """A zero decode state: the conv window in the compute dtype, the SSM
    state in fp32."""
    di, n = cfg.d_inner, cfg.ssm_state
    return {
        "conv": torch.zeros((batch, CONV_K - 1, di + 2 * n),
                            dtype=cfg.torch_dtype, device=device),
        "ssm": torch.zeros((batch, cfg.ssm_heads, n, cfg.ssm_head_dim),
                           dtype=torch.float32, device=device),
    }
