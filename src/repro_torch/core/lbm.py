# Verbatim copy of src/repro/core/lbm.py (the JAX package's framework-free
# scheduling code); only the package name in imports differs.
"""Layer-block mapping (LBM), paper Section III-C(2).

LBM stores the intermediate tensors *between* layers of a block fully in
the tenant's cache region and allocates them **zero DRAM space**: the
block's DRAM traffic shrinks to (block input + weights + block output).
To keep one model from monopolizing the cache for too long, models are
segmented into layer blocks and LBM applies only inside a block.

Segmentation policy (greedy, paper-faithful in its two constraints):
extend the current block while
  (1) the block's LBM page footprint stays under ``page_cap``      and
  (2) the block's estimated execution time stays under ``time_cap``.
A block must contain at least one layer; single-layer blocks get no LBM
candidate (there is no inter-layer intermediate to retain).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.core.mapping import MapperConfig, build_mct, map_layer_lwm, _pages
from repro_torch.core.mct import MCT, CacheMapEntry, MappingCandidate, ModelMapping
from repro_torch.core.types import LayerSpec, ModelGraph, ceil_div


@dataclasses.dataclass(frozen=True)
class LbmConfig:
    page_cap: int = 256          # max pages a block may pin (of 384 total)
    time_cap_s: float = 2e-3     # max wall time a block may hold its pages
    min_layers: int = 2


def _peak_intermediate(layers: List[LayerSpec]) -> int:
    peak = 0
    for i, l in enumerate(layers):
        inter = (l.input_bytes if i > 0 else 0) + (l.output_bytes if i < len(layers) - 1 else 0)
        peak = max(peak, inter)
    return peak


def _block_lbm_plan(layers: List[LayerSpec], cfg: MapperConfig,
                    page_cap: int) -> Tuple[int, int]:
    """(pages, dram_bytes) to run the block with LBM.

    The block pins the peak inter-layer intermediate footprint; the
    remaining budget (up to ``page_cap``) serves each layer's intra-layer
    working set through the normal LWM mapper, so LBM composes with —
    never degrades — per-layer residency.  DRAM shrinks to (block input
    + per-layer traffic minus intermediates + block output)."""
    peak_inter = _peak_intermediate(layers)
    inter_pages = _pages(peak_inter, cfg.page_bytes)
    layer_budget = max(0, (page_cap - inter_pages)) * cfg.page_bytes
    total = layers[0].input_bytes + layers[-1].output_bytes
    max_resident = 0
    for i, l in enumerate(layers):
        base = map_layer_lwm(l, layer_budget, cfg)
        max_resident = max(max_resident, base.p_need)
        # strip the inter-layer input/output traffic the LWM plan pays;
        # keep in-layer (weight stream / reload) traffic
        inter = (l.input_bytes if i > 0 else 0) + \
                (l.output_bytes if i < len(layers) - 1 else 0)
        total += max(0, base.dram_bytes - inter -
                     (l.input_bytes if i == 0 else 0) -
                     (l.output_bytes if i == len(layers) - 1 else 0))
    return inter_pages + max_resident, total


def _block_lbm_footprint(layers: List[LayerSpec], cfg: MapperConfig,
                         page_cap: int = 256) -> int:
    return _block_lbm_plan(layers, cfg, page_cap)[0]


def segment_blocks(graph: ModelGraph, mcfg: MapperConfig,
                   lcfg: LbmConfig) -> List[Tuple[int, int]]:
    blocks: List[Tuple[int, int]] = []
    i, n = 0, len(graph.layers)
    while i < n:
        j = i + 1
        while j < n:
            cand = graph.layers[i:j + 1]
            pages = _block_lbm_footprint(cand, mcfg, lcfg.page_cap)
            t_est = sum(
                map_layer_lwm(l, mcfg.usage_limits[-1], mcfg)
                .t_est(mcfg.compute_flops, mcfg.dram_bps) for l in cand)
            if pages > lcfg.page_cap or t_est > lcfg.time_cap_s:
                break
            j += 1
        blocks.append((i, j))
        i = j
    return blocks


def make_lbm_candidate(layers: List[LayerSpec], block_pages: int,
                       block_dram: int, cfg: MapperConfig,
                       layer_idx_in_block: int) -> MappingCandidate:
    """Per-layer LBM candidate.  The block's page bill is charged at the
    head layer (Algorithm 1 checks it there); subsequent layers inherit
    the allocation (p_need repeats the same pinned footprint).  The
    block's DRAM bytes are attributed to layers proportionally to their
    weight traffic so per-layer accounting sums to the block total."""
    l = layers[layer_idx_in_block]
    wsum = sum(x.weight_bytes for x in layers) or 1
    inner = max(0, block_dram - layers[0].input_bytes - layers[-1].output_bytes)
    share = inner * l.weight_bytes // wsum
    if layer_idx_in_block == 0:
        share += layers[0].input_bytes
    if layer_idx_in_block == len(layers) - 1:
        share += layers[-1].output_bytes
    return MappingCandidate(
        kind="LBM", p_need=block_pages, dram_bytes=share, flops=l.flops,
        loops=(), cache_map=(
            CacheMapEntry("intermediates", 0, block_pages, bypass=False),
            CacheMapEntry("weights", 0, 0, bypass=True)),
        usage_limit_bytes=block_pages * cfg.page_bytes)


def build_model_mapping(graph: ModelGraph, mcfg: Optional[MapperConfig] = None,
                        lcfg: Optional[LbmConfig] = None) -> ModelMapping:
    """Offline mapping phase (paper Fig. 6 left): per-layer MCTs with LWM
    candidates at every usage limit + LBM candidates per block."""
    mcfg = mcfg or MapperConfig()
    lcfg = lcfg or LbmConfig()
    blocks = segment_blocks(graph, mcfg, lcfg)
    mcts: List[MCT] = []
    for (s, e) in blocks:
        layers = graph.layers[s:e]
        use_lbm = (e - s) >= lcfg.min_layers
        if use_lbm:
            pages, dram = _block_lbm_plan(layers, mcfg, lcfg.page_cap)
        for k, layer in enumerate(layers):
            lbm = make_lbm_candidate(layers, pages, dram, mcfg, k) if use_lbm else None
            mcts.append(build_mct(layer, mcfg, lbm=lbm))
    return ModelMapping(model_name=graph.name, mcts=mcts, blocks=blocks)
