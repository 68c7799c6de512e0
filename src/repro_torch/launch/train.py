"""Training driver (port of src/repro/launch/train.py: ``build`` :32,
``main`` :59).

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \
      --steps 10 --seq-len 1024 --global-batch 8          # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu

Without ``--smoke`` it builds the architecture's full-width config; with
``--smoke`` the reduced one.  The loop is the supervisor's
(``distributed/fault_tolerance.py::TrainSupervisor``): checkpoints every
``--ckpt-every`` steps and at the end, restart from the last checkpoint
on a failed step, ``--resume`` from the latest checkpoint.  The data are
the synthetic token stream (``data/pipeline.py``), a pure function of
the step.  The step runs eagerly on ``--device`` (the card unless told):
a Mamba2 layer's SSD scan goes through the ssd_chunk kernel and its
backward kernel there.  The reference shards over a production mesh;
the port trains on one device.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.distributed.fault_tolerance import (StragglerPolicy,
                                                     SupervisorConfig,
                                                     TrainSupervisor)
from repro_torch.models import model as M
from repro_torch.models.base import get_arch
from repro_torch.optim import adamw


def build(arch: str, smoke: bool, seq_len: int, global_batch: int,
          opt_cfg: adamw.AdamWConfig, device: Any = "cuda"):
    """(cfg, params, opt_state, step_fn, batch_at) for ``arch`` (its
    reduced config under ``smoke``), params from seed 0 on ``device``.
    ``batch_at(step)`` is the synthetic batch of that step on ``device``
    (tokens and labels int64), with zero ``embeds_prefix`` frames or
    patches for an encoder-decoder or a VLM, as the reference's."""
    cfg = get_arch(arch)
    if smoke:
        cfg = cfg.reduced()
    params = M.init_params(cfg, seed=0, device=device)
    opt_state = adamw.init(params)
    step_fn = M.make_train_step(cfg, opt_cfg)
    data = SyntheticTokens(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq_len,
        global_batch=global_batch))

    def batch_at(step: int) -> Dict[str, torch.Tensor]:
        b = data.batch_at(step)
        out = {k: torch.from_numpy(v).long().to(device) for k, v in b.items()}
        if cfg.family == "encdec":
            out["embeds_prefix"] = torch.zeros(
                (global_batch, cfg.enc_len, cfg.d_model), dtype=torch.float32,
                device=device)
        elif cfg.family == "vlm":
            out["embeds_prefix"] = torch.zeros(
                (global_batch, cfg.num_patches, cfg.d_model),
                dtype=torch.float32, device=device)
        return out

    return cfg, params, opt_state, step_fn, batch_at


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """The reference's CLI, plus ``--device``.  Returns the run's record:
    ``losses`` (one a step), ``step_seconds`` (host time of each step,
    from the end of the one before to its loss on the host), ``start``
    and ``step`` (first and last step), ``restarts`` (the supervisor's)
    and ``cfg``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                                total_steps=args.steps)
    cfg, params, opt_state, step_fn, batch_at = build(
        args.arch, args.smoke, args.seq_len, args.global_batch, opt_cfg,
        device=args.device)

    sup = TrainSupervisor(
        SupervisorConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every),
        StragglerPolicy())
    start = 0
    if args.resume:
        try:
            params, opt_state, start = sup.restore((params, opt_state))
            print(f"[train] resumed at step {start}")
        except FileNotFoundError:
            print("[train] no checkpoint; starting fresh")

    losses, step_seconds = [], []
    t0 = last = time.time()

    def on_metrics(step: int, m: Dict[str, Any]):
        nonlocal last
        loss = float(m["loss"])
        now = time.time()
        losses.append(loss)
        step_seconds.append(now - last)
        last = now
        if step % 10 == 0 or step == start + 1:
            print(f"[train] step {step} loss {loss:.4f} "
                  f"gnorm {float(m['grad_norm']):.3f} "
                  f"lr {float(m['lr']):.2e} ({now - t0:.1f}s)", flush=True)

    params, opt_state, step = sup.run(
        step_fn, (params, opt_state), batch_at, num_steps=args.steps,
        start_step=start, on_metrics=on_metrics)
    print(f"[train] done at step {step}; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({time.time() - t0:.1f}s)")
    assert losses[-1] < losses[0], "loss did not improve"
    return {"losses": losses, "step_seconds": step_seconds, "start": start,
            "step": step, "restarts": sup.restarts, "cfg": cfg}


if __name__ == "__main__":
    main()
