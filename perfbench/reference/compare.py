"""The comparison that decides ``correct``: every sampled served token
held against the plain float32 reference, teacher-forced on the row's
prompt and the tokens the program served before it.

For one served token the reading is the gap by which its reference
logit lies below the reference's best logit at that position: 0 where
the program picked the reference's argmax, small where it picked a
near-tie, large where it served a token the model would not have.  A
run's numbers are the widest gap over every compared token and the
share of compared tokens that are not the reference's argmax.

The control (``control=True``) reads the same for the token that the
fp8 reference (``family.hidden(..., quant="fp8")``) puts first at each of
the same positions.

The reference is the cell's family module (``perfbench/families/``): its
``hidden`` and ``logits``, in float32 with TF32 off.
"""
from __future__ import annotations

from types import ModuleType
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

BLOCK = 256     # positions whose logits are held at once


def no_tf32() -> None:
    """float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _row_tokens(prompt: np.ndarray, served: np.ndarray) -> np.ndarray:
    """The teacher-forced input row: the prompt, then every served token
    but the last (which nothing reads)."""
    return np.concatenate([prompt, served[:-1]]).astype(np.int64)


@torch.inference_mode()
def gaps(family: ModuleType, weights: Dict[str, Any], arch: Dict[str, Any],
         rows: Sequence[Tuple[np.ndarray, np.ndarray]], device: Any,
         control: bool = False) -> Dict[str, Any]:
    """``rows``: (prompt [P], served [n]) pairs of one weight set, every
    row of one length, held to ``family``'s reference.  Returns the widest
    gap of the served tokens (``gap``), with ``control_gap`` (the fp8
    reference's first choice) when asked, the number of tokens compared
    and where the widest gap lies."""
    no_tf32()
    prompt_len = {len(p) for p, _ in rows}
    served_len = {len(s) for _, s in rows}
    if len(prompt_len) != 1 or len(served_len) != 1:
        raise ValueError("rows of one call share their lengths")
    P, n = prompt_len.pop(), served_len.pop()
    toks = torch.as_tensor(np.stack([_row_tokens(p, s) for p, s in rows]),
                           device=device)
    served = torch.as_tensor(np.stack([s for _, s in rows]).astype(np.int64),
                             device=device)
    h = family.hidden(weights, arch, toks)[:, P - 1:]           # [r, n, d]
    h8 = family.hidden(weights, arch, toks, quant="fp8")[:, P - 1:] \
        if control else None
    widest, ctrl, where = 0.0, 0.0, None
    missed, ctrl_missed = 0, 0
    for b in range(0, n, BLOCK):
        lg = family.logits(weights, arch, h[:, b:b + BLOCK])
        best = lg.max(-1).values
        got = lg.gather(-1, served[:, b:b + BLOCK, None])[..., 0]
        gap = best - got
        missed += int((gap > 0).sum())
        g = float(gap.max())
        if g > widest:
            widest = g
            i = int(gap.argmax())
            where = {"row": i // gap.shape[1], "served_index": b + i % gap.shape[1]}
        if control:
            first = family.logits(weights, arch, h8[:, b:b + BLOCK],
                                  quant="fp8").argmax(-1)
            cgap = best - lg.gather(-1, first[..., None])[..., 0]
            ctrl = max(ctrl, float(cgap.max()))
            ctrl_missed += int((cgap > 0).sum())
        del lg
    out = {"gap": widest, "missed": missed, "tokens": int(served.numel()),
           "where": where}
    if control:
        out.update(control_gap=ctrl, control_missed=ctrl_missed)
    return out


def readings(results: List[Dict[str, Any]], prefix: str = "") -> Dict[str, float]:
    """A run's compared numbers over every request's results:
    ``max_logit_gap`` (the widest gap) and ``mismatch_share`` (% of the
    compared tokens not the reference's argmax); ``prefix="control_"``
    reads the control's."""
    tokens = sum(r["tokens"] for r in results)
    return {"max_logit_gap": max((r[prefix + "gap"] for r in results),
                                 default=0.0),
            "mismatch_share": 100.0 * sum(r[prefix + "missed"]
                                          for r in results) / max(1, tokens)}
