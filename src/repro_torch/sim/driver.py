# Copy of TenantSpec, PoissonArrivals, BackoffPolicy, SessionArrivals and
# FleetScenario from src/repro/sim/driver.py (lines 53-114, 117-182 and
# 185-198): the arrival, backoff and fleet-routing vocabulary the serving
# port accepts.  Only these five stdlib dataclasses are taken from that
# module.
"""Arrival vocabulary shared by the simulator and the serving path."""
from __future__ import annotations

import dataclasses
import random
from typing import List, Optional, Tuple, Union

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


@dataclasses.dataclass
class BackoffPolicy:
    """Deterministic jittered exponential backoff for deferred
    admissions.  When the serving layer's overload control *defers* an
    arrival (bounded queue, pool can't back even the cheapest KV
    reservation), the retry delay is ``base_s * factor**attempt`` capped
    at ``max_s``, scaled down by up to ``jitter`` — the jitter draw is a
    pure function of ``(seed, attempt, key)``, so replays are
    bit-identical while co-arriving retries still de-synchronize."""
    base_s: float = 1.0
    factor: float = 2.0
    max_s: float = 8.0
    jitter: float = 0.5
    seed: int = 0

    def delay_s(self, attempt: int, key: int = 0) -> float:
        d = min(self.base_s * self.factor ** max(0, attempt), self.max_s)
        rng = random.Random(self.seed * 1_000_003 + attempt * 8191 + key)
        return d * (1.0 - self.jitter * rng.random())


@dataclasses.dataclass
class SessionArrivals:
    """Session-replay workload: ``n_sessions`` chat sessions share
    ``n_prompts`` system prompts (session s uses prompt ``s % n_prompts``
    as its first ``prefix_len`` tokens) and re-arrive for ``turns``
    turns.  Turn t's prompt is the *whole* turn-(t-1) prompt extended by
    ``turn_tokens`` fresh tokens — exactly the traffic shape prefix-hash
    KV dedup targets: the first arrival per system prompt prefills it
    cold, every later arrival (same prompt, or a later turn of any
    session on it) attaches to resident pages and prefills only its
    private suffix.  All sessions of one system prompt share
    ``param_seed`` (same model instance — dedup's precondition)."""
    models: List[str]
    n_sessions: int = 4
    turns: int = 2
    n_prompts: int = 2
    prefix_len: int = 256
    turn_tokens: int = 128
    gap_s: float = 2.0               # inter-arrival gap
    n_inferences: Optional[int] = 8
    param_seed: int = 11
    seed: int = 0

    def specs(self) -> List[TenantSpec]:
        rng = random.Random(self.seed)
        out: List[TenantSpec] = []
        t = 0.0
        # arrivals interleave turns round-robin so warm re-arrivals land
        # while earlier sessions' prefixes are still resident
        for turn in range(self.turns):
            for s in range(self.n_sessions):
                prompt_id = s % self.n_prompts
                t += self.gap_s * (0.5 + rng.random())
                out.append(TenantSpec(
                    # arch follows the system prompt: dedup needs every
                    # session on one prompt to share arch AND params
                    self.models[prompt_id % len(self.models)],
                    arrive_at=t,
                    n_inferences=self.n_inferences,
                    prompt_len=self.prefix_len + (turn + 1) * self.turn_tokens,
                    param_seed=self.param_seed + prompt_id,
                    prompt_seed=1000 * self.seed + s,
                    prefix_len=self.prefix_len,
                    prefix_seed=prompt_id))
        return out


@dataclasses.dataclass
class FleetScenario:
    """A fleet run reduced to its routing decisions: per-replica lists of
    routed TenantSpecs (``seed`` pinned to the global admission index,
    ``arrive_at`` rebased to the admitting replica's logical clock) plus
    the route log.  Replaying ``per_replica[r]`` on a fresh single-device
    :class:`~repro_torch.launch.serve.MultiTenantServer` must reproduce replica
    ``r``'s decode token streams bit-identically — the fleet's
    correctness contract, asserted by tests and the fleet benchmark."""
    n_replicas: int
    per_replica: List[List[TenantSpec]] = dataclasses.field(
        default_factory=list)
    routes: List[Tuple[str, int]] = dataclasses.field(default_factory=list)

