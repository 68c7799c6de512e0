"""The one traffic generator: reads a mix file (``traffic/<mix>.json``)
and the run's seed, and gives the requests of one run.

Two kinds of request, both rows of ``batch`` prompts served as one
tenant of the server:

* sessions (``"sessions"``): a closed loop per model instance.  Each
  instance serves ``per_instance`` sessions at once; a session has a
  prompt of ``prompt_len`` tokens and produces ``output_len`` tokens,
  and when it finishes the next session on the same instance starts.
  The first sessions are prefilled during set-up.
* arrivals (``"arrivals"``): an open loop on the wall clock.  Sends
  follow exponential gaps at ``rate_per_s`` from the moment the
  measured window opens, whatever the server does.  Each arrival goes
  to one instance, with one prompt length drawn log-uniformly from
  [min, max] on a grid of ``grid`` tokens, and produces ``output_len``
  tokens.

A mix may also hold ``"server"``: settings that replace the config's
(``max_len``, ``total_pages``) where its requests need more room.

Every seed gets the same set of gaps, prompt lengths and instances, in
another order: the gaps are the exponential distribution's quantiles
at (i + 1/2) / n, the lengths the log-uniform's, the instances a
round-robin, each shuffled by the seed.  So two seeds differ in order
and in prompt tokens, not in the amount of work.  Prompt tokens are
uniform over the vocabulary, drawn from the seed and the request's
index alone.

This replaces the program's own generators (``sim/driver.py``'s
``PoissonArrivals`` and ``SessionArrivals``), which step the server's
logical clock: a faster program would receive its arrivals faster.
"""
from __future__ import annotations

import dataclasses
import json
import math
import random
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
SESSION, ARRIVAL, WARMUP = "session", "arrival", "warmup"
_KIND_ID = {SESSION: 1, ARRIVAL: 2, WARMUP: 3}


@dataclasses.dataclass
class Request:
    kind: str                  # session | arrival | warmup
    index: int                 # unique within the run (the tenant's seed)
    instance: int              # the model instance (its weight set)
    prompt_len: int
    output_len: int
    send_s: Optional[float] = None   # arrivals: seconds after the window opens


def load(name: str) -> Dict[str, Any]:
    """The mix file ``traffic/<name>.json``."""
    path = HERE / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} at {path}")
    return json.loads(path.read_text())


def _rng(seed: int, salt: int) -> random.Random:
    """A stream of the seed alone (a string seed hashes the same in every
    process)."""
    return random.Random(f"perfbench:{seed}:{salt}")


def arrival_schedule(mix: Dict[str, Any], instances: int, seed: int,
                     seconds: float, first_index: int) -> List[Request]:
    """The open-loop arrivals of one run, in send order: n = rate x
    ``seconds`` of them, their gaps scaled to end half a mean gap before
    the window closes, so every arrival is sent inside it."""
    a = mix.get("arrivals")
    if not a:
        return []
    n = max(1, round(float(a["rate_per_s"]) * seconds))
    q = [(i + 0.5) / n for i in range(n)]
    gaps = [-math.log(1.0 - u) for u in q]
    span = seconds * (n - 0.5) / n
    gaps = [g * span / sum(gaps) for g in gaps]
    lo, hi, grid = a["prompt_len"]["min"], a["prompt_len"]["max"], \
        a["prompt_len"]["grid"]
    lens = [min(hi, max(lo, int(round(lo * (hi / lo) ** u / grid)) * grid))
            for u in q]
    inst = [i % instances for i in range(n)]
    for xs, salt in ((gaps, 1), (lens, 2), (inst, 3)):
        _rng(seed, salt).shuffle(xs)
    out, t = [], 0.0
    for i in range(n):
        t += gaps[i]
        out.append(Request(ARRIVAL, first_index + i, inst[i], lens[i],
                           int(a["output_len"]), send_s=t))
    return out


class Traffic:
    """The requests of one run of one cell: the initial sessions, their
    closed-loop successors, the warm-up requests and the arrivals."""

    def __init__(self, mix: Dict[str, Any], instances: int, vocab: int,
                 seed: int, seconds: float):
        self.mix, self.instances, self.vocab, self.seed = \
            mix, instances, vocab, seed
        self.batch = int(mix["batch"])
        self._next = 0
        s = mix["sessions"]
        self.sessions = [self._new(SESSION, inst, s["prompt_len"],
                                   s["output_len"])
                         for inst in range(instances)
                         for _ in range(s.get("per_instance", 1))]
        a = mix.get("arrivals")
        # one arrival of the longest prompt, served in set-up, so that the
        # window's prompt chunks find their shapes warm
        self.warmups = ([self._new(WARMUP, 0, a["prompt_len"]["max"], 4)]
                        if a else [])
        self.arrivals = arrival_schedule(
            mix, instances, seed, seconds, first_index=1_000_000)

    def _new(self, kind: str, instance: int, prompt_len: int,
             output_len: int) -> Request:
        r = Request(kind, self._next, instance, int(prompt_len),
                    int(output_len))
        self._next += 1
        return r

    def next_session(self, instance: int) -> Request:
        """The session that follows a finished one on ``instance``."""
        s = self.mix["sessions"]
        return self._new(SESSION, instance, s["prompt_len"], s["output_len"])

    def prompt(self, r: Request) -> np.ndarray:
        """[batch, prompt_len] int32 tokens of request ``r``."""
        rng = np.random.default_rng([self.seed % 2 ** 63, _KIND_ID[r.kind],
                                     r.index])
        return rng.integers(0, self.vocab, (self.batch, r.prompt_len),
                            dtype=np.int32)
