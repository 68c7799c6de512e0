# Copy of src/repro/data/pipeline.py (the whole module: numpy only, no JAX),
# verbatim: the synthetic token stream the training port reads.
"""Deterministic synthetic token pipeline.

Generates reproducible pseudo-text token streams (Zipfian unigram mix
with short-range repetition structure so models have learnable signal),
sharded by host, with background-free double buffering (prefetch=2) —
the same interface a real tokenized-shard loader would expose, so
launch/train.py is loader-agnostic.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    num_hosts: int = 1
    host_id: int = 0
    zipf_a: float = 1.2
    repeat_prob: float = 0.3   # induces learnable bigram structure


class SyntheticTokens:
    """Infinite deterministic stream; step -> batch is a pure function of
    (seed, step, host), so restarts resume exactly (fault tolerance)."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.num_hosts:
            raise ValueError("global_batch must divide among hosts")
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.num_hosts
        # fixed Zipf-ish unigram distribution over the vocab
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = 1.0 / np.power(ranks, cfg.zipf_a)
        self._p = (p / p.sum()).astype(np.float64)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.host_id]))
        B, S = self.local_batch, cfg.seq_len
        toks = rng.choice(cfg.vocab_size, size=(B, S + 1), p=self._p)
        # short-range repetition: with prob repeat_prob, copy t-2
        rep = rng.random((B, S + 1)) < cfg.repeat_prob
        toks[:, 2:] = np.where(rep[:, 2:], toks[:, :-2], toks[:, 2:])
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, :-1]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_pipeline(vocab_size: int, seq_len: int, global_batch: int,
                  seed: int = 1234, start_step: int = 0,
                  ) -> Iterator[Dict[str, np.ndarray]]:
    ds = SyntheticTokens(DataConfig(vocab_size, seq_len, global_batch, seed))
    step = start_step
    while True:
        yield ds.batch_at(step)
        step += 1
