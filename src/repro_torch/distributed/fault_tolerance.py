"""Straggler detection for the serving port (port of
src/repro/distributed/fault_tolerance.py::StragglerPolicy, lines 33-59).

Per-epoch durations feed an EWMA; an epoch slower than ``threshold x``
the EWMA is a strike, and ``max_strikes`` strikes in a row ask for
mitigation.  The server arms it only under an installed fault plan and
feeds it a logical duration, so trips are deterministic on any host.

The reference module also holds ``SupervisorConfig`` and
``TrainSupervisor`` (checkpoint/restart of a train loop); they wait for
the port's training slice.  The class below is the reference's, line
for line: that module imports the JAX checkpoint, so it is ported
rather than copied.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


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
