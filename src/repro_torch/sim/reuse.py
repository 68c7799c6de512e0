# Verbatim copy of src/repro/sim/reuse.py (lines 1-183: reuse-count and
# reuse-distance statistics (Fig. 3); ReuseStats :31, model_reuse_stats :51,
# aggregate_reuse_stats :82, shared_prefix_reuse :118); only the package
# name in its imports differs. It imports no framework.
"""Reuse-count / reuse-distance statistics (paper Fig. 3).

Classifies every byte the benchmark DNNs move through the shared cache:

* reuse count — how many *repeated* cache accesses a piece of data
  receives after its first touch.  Weights stream through once per
  inference (scratchpad-internal reuse is invisible to the LLC), so
  they and single-consumer streams land in the 0-reuse bucket; an
  intermediate written then read back has reuse count 1, residual /
  multi-consumer tensors more.
* reuse distance — bytes of *other* data accessed between producing an
  intermediate and consuming it.  For layer-sequential execution this is
  the remainder of the producer's output plus everything the consumer
  touches before that input (its weights under multi-tenant interleaving
  also the co-runners' traffic, which is why the paper measures it on
  shared cache).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.types import LayerKind, ModelGraph

DIST_BINS = ((0, 512 * 2**10), (512 * 2**10, 2**20), (2**20, 2 * 2**20),
             (2 * 2**20, 1 << 62))
DIST_LABELS = ("<0.5MB", "0.5-1MB", "1-2MB", ">2MB")


@dataclasses.dataclass
class ReuseStats:
    reuse_count_bytes: Dict[str, int]     # "0", "1", "2+" -> bytes
    distance_bytes: Dict[str, int]        # DIST_LABELS -> intermediate bytes

    @property
    def pct_no_reuse(self) -> float:
        tot = sum(self.reuse_count_bytes.values())
        return 100.0 * self.reuse_count_bytes["0"] / tot if tot else 0.0

    def pct_distance_over(self, nbytes: int) -> float:
        tot = sum(self.distance_bytes.values())
        if not tot:
            return 0.0
        acc = 0
        for (lo, hi), lab in zip(DIST_BINS, DIST_LABELS):
            if lo >= nbytes:
                acc += self.distance_bytes[lab]
        return 100.0 * acc / tot


def model_reuse_stats(graph: ModelGraph, co_runners: int = 1) -> ReuseStats:
    counts = {"0": 0, "1": 0, "2+": 0}
    dists = {lab: 0 for lab in DIST_LABELS}
    layers = graph.layers
    for i, l in enumerate(layers):
        # weights: one pass per inference -> no cache-level reuse
        counts["0"] += l.weight_bytes
        # attention score tensors etc. (kind==ATTN zero-weight): produced
        # and consumed inside the layer -> reuse 1, short distance
        if l.kind == LayerKind.ATTN and l.weight_bytes == 0:
            counts["1"] += min(l.input_bytes, l.output_bytes)
        # inter-layer intermediate (this layer's output)
        if i < len(layers) - 1:
            nxt = layers[i + 1]
            counts["1"] += l.output_bytes
            # distance: consumer's weights + residual of own output,
            # interleaved with co-runners' concurrent streams
            own = l.output_bytes + nxt.weight_bytes
            dist = own * max(1, co_runners)
            for (lo, hi), lab in zip(DIST_BINS, DIST_LABELS):
                if lo <= dist < hi:
                    dists[lab] += l.output_bytes
                    break
        else:
            counts["0"] += l.output_bytes  # final output leaves the chip
        # model input
        if i == 0:
            counts["0"] += l.input_bytes
    return ReuseStats(counts, dists)


def aggregate_reuse_stats(graphs: List[ModelGraph], co_runners: int = 1
                          ) -> ReuseStats:
    counts = {"0": 0, "1": 0, "2+": 0}
    dists = {lab: 0 for lab in DIST_LABELS}
    for g in graphs:
        s = model_reuse_stats(g, co_runners)
        for k, v in s.reuse_count_bytes.items():
            counts[k] += v
        for k, v in s.distance_bytes.items():
            dists[k] += v
    return ReuseStats(counts, dists)


# ---------------------------------------------------------------------
# Cross-tenant shared-prefix reuse (the Fig. 3 analysis extended to the
# serving workload prefix-hash KV dedup targets).
# ---------------------------------------------------------------------
def _arch_of(spec) -> str:
    return spec.model if isinstance(spec.model, str) else spec.model.name


def _prefix_identity(spec, l: int) -> Tuple:
    """Pure-python content identity of a spec's first ``l`` prompt
    tokens, mirroring the serving side's fixed-cap stream composition
    (launch/serve.py ``_prompt_tokens``): positions below ``prefix_len``
    come from the shared prefix stream, the rest from the per-session
    suffix stream — two specs produce bit-identical length-``l``
    prefixes iff these tuples are equal."""
    pre = min(l, spec.prefix_len)
    # a zero-length stream contributes no tokens, so its seed must not
    # split the identity (the serving side hashes the actual bytes)
    return (spec.param_seed,
            ("pre", spec.prefix_seed if pre else None, pre),
            ("suf", spec.prompt_seed if l > pre else None, l - pre))


def shared_prefix_reuse(specs: List[Any], align: int = 128,
                        bytes_per_token: Optional[Dict[str, int]] = None
                        ) -> Dict[str, Any]:
    """How much of a session-replay workload's prefill traffic is
    re-reads of prompt prefixes some earlier tenant already produced —
    the headroom prefix-hash KV dedup claims, computed analytically so
    the BENCH numbers have an independent cross-check.

    Per aligned prefix length ``l``: how many tenants' prompts reach
    ``l`` and how many of those are duplicates of a co-tenant's prefix
    (``dup_tokens = duplicates * l``, ``dup_bytes`` when a per-arch
    ``bytes_per_token`` map is given).  The ``dedup_tokens`` total
    replays arrivals in order and credits each with its longest prefix
    (grid-aligned, or the exact full prompt) already seen — exactly the
    longest-match rule the serving admission applies, so
    ``dedup_frac`` predicts the benchmark's prefill-token savings."""
    bpt = bytes_per_token or {}
    eligible = [s for s in specs
                if s.param_seed is not None and s.prompt_seed is not None
                and s.prompt_len > 0]
    per_len: List[Dict[str, Any]] = []
    max_len = max((s.prompt_len for s in eligible), default=0)
    for l in range(align, max_len + 1, align):
        groups: Dict[Tuple, int] = {}
        for s in eligible:
            if s.prompt_len >= l:
                key = (_arch_of(s),) + _prefix_identity(s, l)
                groups[key] = groups.get(key, 0) + 1
        dup = sum(n - 1 for n in groups.values())
        per_len.append({
            "prefix_len": l,
            "tenants": sum(groups.values()),
            "dup_tenants": dup,
            "dup_tokens": dup * l,
            "dup_bytes": sum((n - 1) * l * bpt.get(k[0], 0)
                             for k, n in groups.items()),
        })

    def probe_lens(s) -> List[int]:
        return ([s.prompt_len]
                + list(range((s.prompt_len - 1) // align * align, 0,
                             -align)))

    seen: set = set()
    saved = total = saved_bytes = 0
    for s in sorted(specs, key=lambda s: s.arrive_at):
        if s.prompt_len <= 0:
            continue
        total += s.prompt_len
        if s.param_seed is None or s.prompt_seed is None:
            continue
        for l in probe_lens(s):
            if (_arch_of(s),) + _prefix_identity(s, l) in seen:
                saved += l
                saved_bytes += l * bpt.get(_arch_of(s), 0)
                break
        for l in probe_lens(s):
            seen.add((_arch_of(s),) + _prefix_identity(s, l))
    return {
        "align": align,
        "per_prefix_len": per_len,
        "prompt_tokens": total,
        "dedup_tokens": saved,
        "dedup_bytes": saved_bytes,
        "dedup_frac": saved / total if total else 0.0,
    }
