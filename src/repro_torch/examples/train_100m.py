"""Training driver example (port of examples/train_100m.py: ``lm_100m``
:26, ``lm_10m`` :34, ``main`` :41): a ~100M-parameter LM trained end to
end through the production code path (synthetic pipeline, AdamW,
checkpoint/restart supervisor, straggler policy), with a simulated
preemption halfway and a resume from its checkpoint.

Default: a ~10M reduced model for 120 steps.  ``--full`` trains the
~100M config (12 layers, d 768, fp32) for 300 steps, sized for one card.

  PYTHONPATH=src python -m repro_torch.examples.train_100m [--full] \
      [--steps N] [--device cpu]

``main`` returns the run's record (losses, each step's host seconds, the
step of the preemption and the step the resume restored) for callers
that check it.
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
import time
from typing import Any, Dict, Optional, Sequence

from repro_torch.distributed.fault_tolerance import (StragglerPolicy,
                                                     SupervisorConfig,
                                                     TrainSupervisor)
from repro_torch.launch.train import build
from repro_torch.models.base import ArchConfig, register
from repro_torch.optim import adamw


def lm_100m() -> ArchConfig:
    # ~103M params: 12L, d=768, 12H, ff=2048, vocab=32k (GPT2-small-class)
    return register(ArchConfig(
        name="lm-100m", family="dense", num_layers=12, d_model=768,
        num_heads=12, num_kv_heads=12, d_ff=2048, vocab_size=32000,
        dtype="float32"))


def lm_10m() -> ArchConfig:
    return register(ArchConfig(
        name="lm-10m", family="dense", num_layers=4, d_model=256,
        num_heads=8, num_kv_heads=8, d_ff=1024, vocab_size=8000,
        dtype="float32"))


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = lm_100m() if args.full else lm_10m()
    steps = args.steps or (300 if args.full else 120)
    print(f"training {cfg.name}: ~{cfg.param_count() / 1e6:.0f}M params, "
          f"{steps} steps")

    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=steps)
    _, params, opt_state, step_fn, batch_at = build(
        cfg.name, smoke=False, seq_len=128, global_batch=8, opt_cfg=opt_cfg,
        device=args.device)

    ckpt_dir = tempfile.mkdtemp(prefix="train100m_")
    sup = TrainSupervisor(SupervisorConfig(ckpt_dir=ckpt_dir, ckpt_every=40),
                          StragglerPolicy())
    losses, step_seconds = [], []
    last = time.time()

    def on_metrics(step, m):
        nonlocal last
        losses.append(float(m["loss"]))
        step_seconds.append(time.time() - last)
        last = time.time()
        if step % 20 == 0:
            print(f"  step {step:4d}  loss {losses[-1]:.4f}  "
                  f"gnorm {float(m['grad_norm']):.2f}")

    try:
        half = steps // 2
        params, opt_state, _ = sup.run(step_fn, (params, opt_state), batch_at,
                                       num_steps=half, on_metrics=on_metrics)
        # simulate a node failure + elastic restart from the checkpoint
        print(f"  -- simulated preemption at step {half}; resuming from "
              f"{ckpt_dir} --")
        params2, opt2, resumed = sup.restore((params, opt_state))
        params, opt_state, _ = sup.run(step_fn, (params2, opt2), batch_at,
                                       num_steps=steps, start_step=resumed,
                                       on_metrics=on_metrics)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"done: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({'improved' if losses[-1] < losses[0] else 'NOT improved'})")
    assert losses[-1] < losses[0]
    return {"cfg": cfg, "losses": losses, "step_seconds": step_seconds,
            "preempted_at": half, "resumed_at": resumed,
            "restarts": sup.restarts}


if __name__ == "__main__":
    main()
