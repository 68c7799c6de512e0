"""The port's NEC program generation (src/repro_torch/core/codegen.py)
against the JAX package's (src/repro/core/codegen.py) on the CPU: for
each mapping candidate of ``tests/test_codegen.py``'s cases, the
``NecOp`` lists and ``run_candidate``'s line-accurate counters are
equal, the executed DRAM bytes hold the mapper's analytic model as the
reference's tests hold it, and the program charges the per-line oracle's
(``tests/reference_nec.py``) exact counters."""
import dataclasses

import numpy as np
import pytest

from repro.core import codegen as RG
from repro.core.cache import CacheConfig as RCacheConfig
from repro.core.cache import SharedCache as RSharedCache
from repro.core.cpt import CachePageTable as RCpt
from repro.core.mapping import MapperConfig as RMapperConfig
from repro.core.mapping import map_layer_lwm as ref_map
from repro.core.nec import Nec as RNec
from repro.core.types import GemmDims as RGemm
from repro.core.types import LayerKind as RKind
from repro.core.types import LayerSpec as RLayer
from repro_torch.core import codegen as PG
from repro_torch.core import generate_gemm_program, run_candidate
from repro_torch.core.cache import CacheConfig, SharedCache
from repro_torch.core.cpt import CachePageTable
from repro_torch.core.mapping import MapperConfig, map_layer_lwm
from repro_torch.core.nec import Nec
from repro_torch.core.types import GemmDims, LayerKind, LayerSpec, ceil_div
from reference_nec import RefCachePageTable, RefNec
from torch_sim_pairs import plain

CFG, RCFG = MapperConfig(), RMapperConfig()
SUB = CFG.npu_subspace_bytes


def _fc(G, K, L, m, k, n, eb=1):
    return L("l", K.GEMM, (G(m, n, k),), input_bytes=m * k * eb,
             output_bytes=m * n * eb, weight_bytes=k * n * eb, elem_bytes=eb)


def _lstm(G, K, L):
    return L("lstm", K.LSTM, (G(M=1, N=2048, K=1024, reps=8, b_reused=True),),
             input_bytes=8 * 1024, output_bytes=8 * 1024,
             weight_bytes=1024 * 2048)


def _pair(shape):
    if shape == "lstm":
        return _lstm(GemmDims, LayerKind, LayerSpec), _lstm(RGemm, RKind,
                                                           RLayer)
    return (_fc(GemmDims, LayerKind, LayerSpec, *shape),
            _fc(RGemm, RKind, RLayer, *shape))


# tests/test_codegen.py's cases (stream, panel, mid budget, LSTM weight
# reuse, the deterministic subset) and twelve drawn from a seed over the
# property test's ranges
_rng = np.random.default_rng(0)
CASES = [((512, 1024, 2048), 0), ((512, 1024, 2048), SUB),
         ((1024, 512, 4096), 2 * 2**20), ("lstm", SUB),
         ((512, 1024, 2048), 12 * 2**20), ((100, 70, 3000), 2**20),
         ((333, 129, 777), 2**20)] + [
    ((int(_rng.integers(64, 1025)), int(_rng.integers(64, 1025)),
      int(_rng.integers(64, 2049))),
     int(_rng.choice([0, 2**20, 4 * 2**20, 12 * 2**20])))
    for _ in range(12)]


def _run(layer, cand, C, Cache, N, run):
    cache = Cache(C())
    nec = N(cache)
    measured = run(layer, cand, cache, nec, "t")
    return (measured, plain(nec.per_tenant["t"]), cache.free_pages,
            nec.resident_lines("t"))


@pytest.mark.parametrize("shape, budget", CASES,
                         ids=[f"{s}-{b}" for s, b in CASES])
def test_program_and_counters_equal_reference(shape, budget):
    layer, rlayer = _pair(shape)
    cand = map_layer_lwm(layer, budget, CFG)
    rcand = ref_map(rlayer, budget, RCFG)
    assert plain(cand) == plain(rcand)
    for g, loop, rg, rloop in zip(layer.gemms, cand.loops, rlayer.gemms,
                                  rcand.loops):
        for base in (0, CacheConfig().page_bytes):
            got = list(generate_gemm_program(g, loop, layer.elem_bytes, base))
            want = list(RG.generate_gemm_program(rg, rloop, rlayer.elem_bytes,
                                                 base))
            assert plain(got) == plain(want)
    got = _run(layer, cand, CacheConfig, SharedCache, Nec, run_candidate)
    want = _run(rlayer, rcand, RCacheConfig, RSharedCache, RNec,
                RG.run_candidate)
    assert got == want
    # executed == analytic within 2% (ref tests/test_codegen.py:29)
    assert got[0] == pytest.approx(cand.dram_bytes, rel=0.02)
    # pages released, no residency left (ref :113)
    assert got[2] == CacheConfig().num_pages and got[3] == 0


def test_program_is_aggregated_over_n_tiles():
    """ref tests/test_codegen.py:87: O(reps * m-tiles) ops, repeats on."""
    layer, rlayer = _pair((256, 128, 65536))
    cand = map_layer_lwm(layer, 0, CFG)
    g, loop = layer.gemms[0], cand.loops[0]
    ops = list(generate_gemm_program(g, loop, layer.elem_bytes))
    rcand = ref_map(rlayer, 0, RCFG)
    assert plain(ops) == plain(list(RG.generate_gemm_program(
        rlayer.gemms[0], rcand.loops[0], rlayer.elem_bytes)))
    assert ceil_div(g.N, loop.tn) >= 8
    assert len(ops) <= 6 * g.reps * ceil_div(g.M, loop.tm)
    assert any(o.repeat > 1 for o in ops)


def test_aggregated_stream_counters_match_unrolled():
    """ref tests/test_codegen.py:103, in both packages."""
    def run(G, K, L, M, C, Cache, Cpt, N, gen, ex, expand):
        layer = _fc(G, K, L, 333, 129, 777)
        cand = M(layer, SUB, MapperConfig() if M is map_layer_lwm
                 else RMapperConfig())
        cache = Cache(C())
        nec = N(cache)
        cpt = Cpt(cache.config)
        cpt.map_pages(cache.alloc("t", cand.p_need) or [])
        ops = list(gen(layer.gemms[0], cand.loops[0], layer.elem_bytes))
        if expand:
            ops = [dataclasses.replace(o, repeat=1)
                   for o in ops for _ in range(o.repeat)]
        ex(iter(ops), nec, cpt, "t")
        return plain(nec.per_tenant["t"])

    port = (GemmDims, LayerKind, LayerSpec, map_layer_lwm, CacheConfig,
            SharedCache, CachePageTable, Nec, generate_gemm_program,
            PG.execute)
    ref = (RGemm, RKind, RLayer, ref_map, RCacheConfig, RSharedCache, RCpt,
           RNec, RG.generate_gemm_program, RG.execute)
    got = run(*port, expand=False)
    assert got == run(*port, expand=True)
    assert got == run(*ref, expand=False)


def test_resident_reads_hit():
    """ref tests/test_codegen.py:123: panel reads hit, in both packages."""
    layer, rlayer = _pair((512, 1024, 2048))
    got = _run(layer, map_layer_lwm(layer, SUB, CFG), CacheConfig,
               SharedCache, Nec, run_candidate)
    assert got == _run(rlayer, ref_map(rlayer, SUB, RCFG), RCacheConfig,
                       RSharedCache, RNec, RG.run_candidate)
    hits, accesses = got[1][1][5], got[1][1][6]
    assert hits > 0 and accesses >= hits


@pytest.mark.parametrize("shape, budget", CASES[:7],
                         ids=[f"{s}-{b}" for s, b in CASES[:7]])
def test_program_matches_per_line_oracle(shape, budget):
    """ref tests/test_nec_diff.py:157: the port's program, run on the
    port's NEC and on the per-line oracle over the same page grants,
    charges identical counters."""
    layer, _ = _pair(shape)
    cand = map_layer_lwm(layer, budget, CFG)
    cache = SharedCache(CacheConfig())
    nec, ref = Nec(cache), RefNec(cache)
    pages = cache.alloc("a", max(cand.p_need, 4)) or []
    cpt, ref_cpt = CachePageTable(cache.config), RefCachePageTable(
        cache.config)
    cpt.map_pages(pages)
    ref_cpt.map_pages(pages)
    for g, loop in zip(layer.gemms, cand.loops):
        PG.execute(generate_gemm_program(g, loop, layer.elem_bytes), nec,
                   cpt, "a")
        PG.execute(generate_gemm_program(g, loop, layer.elem_bytes), ref,
                   ref_cpt, "a")
    assert dataclasses.astuple(nec.per_tenant["a"]) == \
        dataclasses.astuple(ref.per_tenant["a"])
