# Copy of TenantSpec and PoissonArrivals from src/repro/sim/driver.py
# (lines 53-114): the arrival vocabulary the serving port accepts.  Only
# these two stdlib dataclasses are taken from that module.
"""Arrival vocabulary shared by the simulator and the serving path."""
from __future__ import annotations

import dataclasses
import random
from typing import List, Optional, Union

from repro_torch.core.types import ModelGraph


@dataclasses.dataclass
class TenantSpec:
    """One tenant of a dynamic-tenancy scenario.

    ``model`` is the tenant's layer graph in the analytic simulator; the
    real serving path (:class:`repro.launch.serve.MultiTenantServer`)
    accepts the same spec with an *arch id string* instead, plus a
    ``prompt_len``: the tenant then arrives mid-run with a real prompt
    that is prefilled (chunked, cache-aware) before it decodes
    ``n_inferences`` tokens and departs — one arrival vocabulary shared
    by the simulator and the server."""
    model: Union[ModelGraph, str]
    arrive_at: float = 0.0           # seconds into the run
    n_inferences: Optional[int] = None   # depart after this many (None = horizon)
    qos_ms: Optional[float] = None   # per-tenant latency target override
    group_size: int = 1
    prompt_len: int = 0              # serving: prompt tokens to prefill
    # serving: tenant identity/PRNG seed.  None -> the server stamps its
    # admission counter.  The fleet router pins the GLOBAL admission
    # index here when it routes a spec to a replica, so replaying one
    # replica's scenario on a fresh single-device server reproduces the
    # exact params/prompt (and tenant id) — the bit-identical contract.
    seed: Optional[int] = None
    # serving, session replay: decoupled content identities.  When
    # ``param_seed`` is set, the tenant's parameters come from
    # PRNGKey(param_seed) rather than the admission seed, so several
    # arrivals can SHARE a model instance — the precondition for
    # cross-tenant KV dedup, which the server only attempts when this
    # field is set.  ``prefix_len`` tokens of the prompt are drawn from
    # the shared PRNGKey(104729 + prefix_seed) stream (the "system
    # prompt"), the remainder from PRNGKey(7919 + prompt_seed); both are
    # sliced from fixed-cap streams so a longer prompt with the same
    # seeds *extends* a shorter one bit-exactly (multi-turn re-arrivals).
    param_seed: Optional[int] = None
    prompt_seed: Optional[int] = None
    prefix_len: int = 0
    prefix_seed: int = 0


@dataclasses.dataclass
class PoissonArrivals:
    """Open-loop arrival process: ``n_arrivals`` tenants drawn from
    ``models`` join at exponential inter-arrival gaps and depart after
    ``n_inferences`` inferences (pages reclaimed on departure).
    ``prompt_len`` rides along to the serving path (ignored by the
    analytic simulator, whose inferences carry no token prompts)."""
    rate_per_s: float
    models: List[Union[ModelGraph, str]]
    n_arrivals: int = 8
    n_inferences: Optional[int] = 4
    seed: int = 0
    prompt_len: int = 0

    def specs(self) -> List[TenantSpec]:
        rng = random.Random(self.seed)
        t, out = 0.0, []
        for _ in range(self.n_arrivals):
            t += rng.expovariate(self.rate_per_s)
            out.append(TenantSpec(rng.choice(self.models), arrive_at=t,
                                  n_inferences=self.n_inferences,
                                  prompt_len=self.prompt_len))
        return out
