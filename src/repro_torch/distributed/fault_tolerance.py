"""Fault tolerance of the port: straggler detection, and the supervised
train loop with checkpoint / restart (port of
src/repro/distributed/fault_tolerance.py: ``StragglerPolicy`` :33,
``SupervisorConfig`` :61, ``TrainSupervisor`` :68).

Per-step (or per-epoch) durations feed an EWMA; a step slower than
``threshold x`` the EWMA is a strike, and ``max_strikes`` strikes in a
row ask for mitigation.  The server arms the policy only under an
installed fault plan and feeds it a logical duration, so trips are
deterministic on any host.  ``TrainSupervisor`` runs a train step in a
loop: it checkpoints every ``ckpt_every`` steps, at a straggler's
mitigation and at the end (on a background thread when ``async_save``),
and contains a crash in a step by restoring the last checkpoint, up to
``max_restarts`` times.  The data pipeline is a pure function of the
step, so a restart replays nothing and misses nothing.  Checkpoints are
the port's (``checkpoint/checkpoint.py``); a restore puts the leaves on
the device of the tree it is given.  The classes are the reference's,
line for line where the framework allows: that module imports the JAX
checkpoint, so it is ported rather than copied.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.optim.adamw import tree_leaves


@dataclasses.dataclass
class StragglerPolicy:
    ewma_alpha: float = 0.2
    threshold: float = 2.5      # x EWMA -> suspect
    max_strikes: int = 3

    def __post_init__(self):
        self.ewma: Optional[float] = None
        self.strikes = 0
        self.events: list = []

    def observe(self, step: int, dt: float) -> bool:
        """Returns True when mitigation should trigger."""
        if self.ewma is None:
            self.ewma = dt
            return False
        slow = dt > self.threshold * self.ewma
        if slow:
            self.strikes += 1
            self.events.append((step, dt, self.ewma))
        else:
            self.strikes = 0
        # slow steps should not poison the baseline
        self.ewma = (1 - self.ewma_alpha) * self.ewma + self.ewma_alpha * \
            min(dt, self.ewma * self.threshold if self.ewma else dt)
        return self.strikes >= self.max_strikes


@dataclasses.dataclass
class SupervisorConfig:
    ckpt_dir: str = "checkpoints"
    ckpt_every: int = 50
    max_restarts: int = 3
    async_save: bool = True


class TrainSupervisor:
    """Wraps a train loop with checkpoint/restart + straggler handling."""

    def __init__(self, cfg: SupervisorConfig,
                 straggler: Optional[StragglerPolicy] = None):
        self.cfg = cfg
        self.straggler = straggler or StragglerPolicy()
        self.restarts = 0
        self._pending_save = None

    def run(self,
            step_fn: Callable[[Any, Any, Dict], Tuple[Any, Any, Dict]],
            state: Tuple[Any, Any],
            batch_at: Callable[[int], Dict],
            num_steps: int,
            start_step: int = 0,
            on_metrics: Optional[Callable[[int, Dict], None]] = None,
            ) -> Tuple[Any, Any, int]:
        params, opt_state = state
        step = start_step
        while step < num_steps:
            t0 = time.time()
            try:
                params, opt_state, metrics = step_fn(
                    params, opt_state, batch_at(step))
            except Exception:
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise
                params, opt_state, step = self.restore((params, opt_state))
                continue
            dt = time.time() - t0
            if self.straggler.observe(step, dt):
                # mitigation: in production, swap the slow host; here we
                # checkpoint immediately so a kill/restart loses nothing
                self.save(step, params, opt_state)
                self.straggler.strikes = 0
            step += 1
            if on_metrics:
                on_metrics(step, metrics)
            if step % self.cfg.ckpt_every == 0:
                self.save(step, params, opt_state)
        self.save(step, params, opt_state)
        self.join()
        return params, opt_state, step

    # ------------------------------------------------------------------
    def save(self, step: int, params, opt_state) -> None:
        tree = {"params": params, "opt": opt_state}
        if self.cfg.async_save:
            self.join()
            self._pending_save = ckpt.save_async(
                self.cfg.ckpt_dir, step, tree, extra={"step": step})
        else:
            ckpt.save(self.cfg.ckpt_dir, step, tree, extra={"step": step})

    def join(self) -> None:
        if self._pending_save is not None:
            self._pending_save.join()
            self._pending_save = None

    def restore(self, tree_like) -> Tuple[Any, Any, int]:
        """(params, opt_state, step) of the latest checkpoint, in
        ``tree_like``'s structure (the optimizer's ``AdamWState`` comes
        back as one) and on its leaves' device."""
        self.join()
        tree, extra = ckpt.restore(
            self.cfg.ckpt_dir,
            {"params": tree_like[0], "opt": tree_like[1]},
            device=tree_leaves(tree_like)[0].device)
        return tree["params"], tree["opt"], int(extra["step"])
