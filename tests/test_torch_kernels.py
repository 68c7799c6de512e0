"""The port's kernel wrappers against the JAX package's Pallas kernels.

Inputs are made with numpy from a seed and handed to both sides.  The
reference kernels run in Pallas interpret mode, as tests/test_kernels.py
runs them; the port's wrappers take their plain PyTorch versions because
the tensors lie on the CPU.  Tolerances are tests/test_kernels.py::tol.
The CUDA kernels themselves run only on the card (tests/test_torch_gpu.py
and ``chip_smoke.py``).
"""
import dataclasses
import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as rplan
from repro.core import vmem as rvmem
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.kernels.block_fused_ffn import block_fused_ffn as ref_block_fused_ffn
from repro.kernels.cache_matmul import cache_matmul as ref_cache_matmul
from repro_torch.core import plan as pplan
from repro_torch.core import vmem as pvmem
from repro_torch.kernels import block_fused_ffn as kffn
from repro_torch.kernels import build
from repro_torch.kernels import cache_matmul as kmm
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as pref

H100_SMEM_OPTIN = 232448   # shared_memory_per_block_optin of an H100


def tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=2e-3, atol=2e-3)


def _pair(rng, shape, dtype="float32", scale=1.0):
    """The same values as a JAX array and a torch tensor (bf16 rounds the
    same fp32 values to nearest even on both sides)."""
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------- matmul --
@pytest.mark.parametrize("m,n,k", [(128, 128, 128), (256, 512, 384),
                                   (512, 128, 1024), (64, 64, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_matmul_matches_reference(m, n, k, dtype):
    rng = np.random.default_rng(0)
    a_j, a_t = _pair(rng, (m, k), dtype)
    b_j, b_t = _pair(rng, (k, n), dtype)
    bm, bn, bk = min(128, m), min(128, n), min(128, k)
    eb = 4 if dtype == "float32" else 2
    want = ref_cache_matmul(a_j, b_j, rvmem.TileConfig(
        bm, bn, bk, rvmem.tile_vmem_bytes(bm, bn, bk, eb)))
    before = kmm.launches
    got = ops.planned_matmul(a_t, b_t, pvmem.TileConfig(
        bm, bn, bk, pvmem.tile_vmem_bytes(bm, bn, bk, eb)))
    assert got.dtype == a_t.dtype and got.shape == (m, n)
    assert kmm.launches == before     # the CPU takes the plain version
    np.testing.assert_allclose(_np(got), _np(want), **tol(dtype))


@pytest.mark.parametrize("pages", [2, 16, 256])
def test_budgeted_matmul_matches_reference(pages):
    rng = np.random.default_rng(1)
    a_j, a_t = _pair(rng, (100, 200))
    b_j, b_t = _pair(rng, (200, 60))
    np.testing.assert_allclose(
        _np(ops.budgeted_matmul(a_t, b_t, pages=pages)),
        _np(rops.budgeted_matmul(a_j, b_j, pages=pages)), **tol("float32"))


def test_planned_matmul_matches_reference():
    rng = np.random.default_rng(2)
    a_j, a_t = _pair(rng, (100, 200))
    b_j, b_t = _pair(rng, (200, 60))
    rtile = rvmem.lower_matmul_tile(100, 60, 200, 4, pages=16)
    ptile = pvmem.lower_matmul_tile(100, 60, 200, 4, pages=16)
    assert dataclasses.astuple(rtile) == dataclasses.astuple(ptile)
    np.testing.assert_allclose(_np(ops.planned_matmul(a_t, b_t, ptile)),
                               _np(rops.planned_matmul(a_j, b_j, rtile)),
                               **tol("float32"))


# ---------------------------------------------------------- fused ffn --
def _ffn_inputs(rng, s, d, f, dtype="float32"):
    x = _pair(rng, (s, d), dtype)
    wg = _pair(rng, (d, f), dtype, 0.2)
    wu = _pair(rng, (d, f), dtype, 0.2)
    wd = _pair(rng, (f, d), dtype, 0.2)
    return [t[0] for t in (x, wg, wu, wd)], [t[1] for t in (x, wg, wu, wd)]


@pytest.mark.parametrize("S,d,f,bs,bf", [(64, 32, 128, 32, 64),
                                         (256, 64, 256, 64, 128),
                                         (128, 128, 512, 128, 512)])
def test_block_fused_ffn_matches_reference(S, d, f, bs, bf):
    (xj, gj, uj, dj), (xt, gt, ut, dt) = _ffn_inputs(
        np.random.default_rng(3), S, d, f)
    want = ref_block_fused_ffn(xj, gj, uj, dj, block_s=bs, block_f=bf)
    before = kffn.launches
    got = ops.fused_ffn(xt, gt, ut, dt, block_s=bs, block_f=bf)
    assert kffn.launches == before
    np.testing.assert_allclose(_np(got), _np(want), **tol("float32"))


def test_block_fused_ffn_bf16_rounds_hidden_like_reference():
    """bf16: the hidden tile is rounded to x's dtype before the down
    product, as the reference kernel rounds it."""
    (xj, gj, uj, dj), (xt, gt, ut, dt) = _ffn_inputs(
        np.random.default_rng(4), 64, 64, 256, "bfloat16")
    want = ref_block_fused_ffn(xj, gj, uj, dj, block_s=64, block_f=128)
    got = ops.fused_ffn(xt, gt, ut, dt, block_s=64, block_f=128)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **tol("bfloat16"))


@pytest.mark.parametrize("S,d,f", [(100, 128, 384), (7, 128, 256)])
@pytest.mark.parametrize("fused", [True, False])
def test_planned_ffn_matches_reference(S, d, f, fused):
    """Both lowered variants (LBM fused, LWM tiled) on shapes that the
    reference pads to tile boundaries; the port's plan equals the
    reference's."""
    pages = 4096 if fused else 2
    rp = rplan.lower_ffn(S, d, f, 4, pages=pages, want_fused=fused)
    pp = pplan.lower_ffn(S, d, f, 4, pages=pages, want_fused=fused)
    assert rp.fused == pp.fused == fused
    assert repr(rp) == repr(pp)
    (xj, gj, uj, dj), (xt, gt, ut, dt) = _ffn_inputs(
        np.random.default_rng(5), S, d, f)
    np.testing.assert_allclose(_np(ops.planned_ffn(xt, gt, ut, dt, pp)),
                               _np(rops.planned_ffn(xj, gj, uj, dj, rp)),
                               **tol("float32"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_oracles_match_reference(dtype):
    """matmul_ref / ffn_ref keep the reference's cast points: fp32 sums,
    the hidden activation rounded to x's dtype before the down product."""
    rng = np.random.default_rng(6)
    a_j, a_t = _pair(rng, (48, 96), dtype)
    b_j, b_t = _pair(rng, (96, 40), dtype)
    np.testing.assert_allclose(_np(pref.matmul_ref(a_t, b_t)),
                               _np(rref.matmul_ref(a_j, b_j)), **tol(dtype))
    (xj, gj, uj, dj), (xt, gt, ut, dt) = _ffn_inputs(rng, 24, 64, 160, dtype)
    got = pref.ffn_ref(xt, gt, ut, dt)
    assert got.dtype == xt.dtype
    np.testing.assert_allclose(_np(got), _np(rref.ffn_ref(xj, gj, uj, dj)),
                               **tol(dtype))


# ---------------------------------------------------- the wrappers ----
def test_wrappers_reject_malformed_operands():
    a = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        kmm.cache_matmul(a, torch.zeros(7, 3), kmm.TILES[0])
    with pytest.raises(TypeError):
        kmm.cache_matmul(a, torch.zeros(8, 3, dtype=torch.float64),
                         kmm.TILES[0])
    with pytest.raises(ValueError):
        kffn.block_fused_ffn(a, torch.zeros(8, 16), torch.zeros(8, 16),
                             torch.zeros(16, 4), kffn.TILES[0])
    with pytest.raises(TypeError):
        kffn.block_fused_ffn(a.half(), torch.zeros(8, 16).half(),
                             torch.zeros(8, 16).half(),
                             torch.zeros(16, 8).half(), kffn.TILES[0])


def test_compiled_tiles_fit_hopper_shared_memory():
    for t in kmm.TILES:
        assert t.smem_bytes <= H100_SMEM_OPTIN
        assert t.kind in kmm.KINDS and set(t.dtypes) <= set(kmm.DTYPES)
        if t.kind == "wgmma":          # warpgroups of 64 rows, one wgmma wide
            assert t.bm % 64 == 0 and t.tm == 64 and t.tn == t.bn <= 256
            assert t.bn % 64 == 0 and t.bk % 16 == 0
        else:
            assert t.bm % t.tm == 0 and t.bn % t.tn == 0
            assert (t.bm // t.tm) * (t.bn // t.tn) <= 1024
    for t in kffn.TILES:
        assert t.smem_bytes <= H100_SMEM_OPTIN
        assert (t.bs // t.tm) * (t.bf // t.tn) <= 1024
        assert t.kind in kmm.KINDS and set(t.dtypes) <= set(kmm.DTYPES)
        if t.kind == "wgmma":          # warpgroups of 64 rows, 128-wide d_ff
            assert t.bs % 64 == 0 and t.tm == 64 and t.tn == t.bf == 128
            assert t.dtypes == (torch.bfloat16,) and t.bk == 64
        if t.kind == "gemv":           # decode rows, 8 d_ff columns a thread
            assert (t.bs, t.bf, t.tm, t.tn) == (8, 64, 8, 8)
            assert t.dtypes == (torch.bfloat16,)


@pytest.mark.parametrize("menu", ["cache_matmul", "cache_matmul_quant",
                                  "block_fused_ffn", "flash_attention"])
def test_every_menu_entry_fits_the_shared_memory_limit(menu):
    """Each menu entry's Python shared-memory formula (the bytes its
    kernel asks for, held against the library's at load) fits an H100
    block's 232,448 bytes, and the entries are distinct."""
    tiles = {"cache_matmul": kmm.TILES, "cache_matmul_quant": kmm.QUANT_TILES,
             "block_fused_ffn": kffn.TILES,
             "flash_attention": kfa.TILES}[menu]
    assert len(set(tiles)) == len(tiles)
    for t in tiles:
        assert 0 < t.smem_bytes <= H100_SMEM_OPTIN, t
        assert build.menu_fields(t)[-1] == t.smem_bytes


SIMT = [t for t in kmm.TILES if t.kind == "simt"]
# the tiles the simt-only legalization chose for the path's shapes
PATH_SIMT = {2: kmm.HopperTile(8, 32, 256, 1, 1),
             2048: kmm.HopperTile(128, 128, 32, 8, 8)}


@pytest.mark.parametrize("pages", [32, 64, 300, 1200])
@pytest.mark.parametrize("m", [2, 256, 2048])
def test_legalized_matmul_tile_stays_under_the_plan(pages, m):
    """fp32: full-width yi-9b LWM plans (sized for TPU VMEM) legalize to
    a compiled simt tile no larger than the plan's in any dimension,
    within shared memory, with the fewest wasted rows: the simt-only
    rule, unchanged by the bf16 kinds."""
    plan = pplan.lower_ffn(128, 4096, 11008, 2, pages, want_fused=False)
    for tile in (plan.up_tile, plan.down_tile):
        hop = ops.legalize_matmul_tile(tile, m, H100_SMEM_OPTIN,
                                       torch.float32, 4096, 11008)
        assert hop in SIMT
        assert hop.bm <= tile.bm and hop.bn <= tile.bn and hop.bk <= tile.bk
        assert hop.smem_bytes <= H100_SMEM_OPTIN
        fits = [t.bm for t in SIMT if t.bm <= tile.bm and t.bn <= tile.bn
                and t.bk <= tile.bk]
        assert hop.bm == min([b for b in fits if b >= m] or [max(fits)])
        if m in PATH_SIMT:
            assert hop == PATH_SIMT[m]


@functools.lru_cache(maxsize=None)
def _full_width_lwm_tiles():
    """Every distinct (up, down) plan tile of a full-width yi-9b LWM grant
    of 4 to 1800 pages, at the decode (128) and prefill (1024) seq blocks."""
    tiles = set()
    for seq in (128, 1024):
        for pages in range(4, 1801):
            plan = pplan.lower_ffn(seq, 4096, 11008, 2, pages,
                                   want_fused=False)
            tiles |= {(plan.up_tile, 4096, 11008),
                      (plan.down_tile, 11008, 4096)}
    return sorted(tiles, key=repr)


@pytest.mark.parametrize("m", [1, 2, 8, 9, 64, 65, 256, 300, 2048])
def test_bf16_full_width_plans_legalize_to_the_new_kinds(m):
    """bf16 at full width: every LWM plan of 4-1800 pages gives the gemv
    tile at up to 8 rows and a wgmma tile above (the 64-row one at 9-64
    rows, the 128-row one above), under the plan's tile and within
    shared memory."""
    tiles = _full_width_lwm_tiles()
    assert min(t.bm * t.bn * t.bk for t, _, _ in tiles) == 128 * 256 * 256
    for tile, k, n in tiles:
        hop = ops.legalize_matmul_tile(tile, m, H100_SMEM_OPTIN,
                                       torch.bfloat16, k, n)
        assert hop.kind == ("gemv" if m <= 8 else "wgmma"), tile
        assert torch.bfloat16 in hop.dtypes
        assert hop.bm <= tile.bm and hop.bn <= tile.bn and hop.bk <= tile.bk
        assert hop.smem_bytes <= H100_SMEM_OPTIN
        if hop.kind == "wgmma":
            assert hop.bm == (64 if m <= 64 else 128)
        assert ops.matmul_kind(m, torch.bfloat16, k, n) == hop.kind


@pytest.mark.parametrize("m,k,n,kind", [
    (37, 333, 1000, "simt"),      # K rows not 16-byte aligned: no TMA
    (37, 520, 1002, "simt"),      # N rows not 16-byte aligned
    (37, 520, 1000, "wgmma"),
    (7, 333, 1000, "gemv"),       # gemv masks ragged K and N itself
    (1, 4096, 97, "gemv"),
    (2048, 4096, 11008, "wgmma")])
def test_misaligned_bf16_rows_route_to_simt(m, k, n, kind):
    """The route is the legalization's: bf16 wgmma needs K and N to be
    multiples of 8; a shape it cannot take gets the simt tile the fp32
    rule picks; fp32 is simt at every shape."""
    tile = pvmem.TileConfig(128, 256, 256, 0)
    hop = ops.legalize_matmul_tile(tile, m, H100_SMEM_OPTIN, torch.bfloat16,
                                   k, n)
    assert hop.kind == kind
    if kind == "simt":
        assert hop == ops.legalize_matmul_tile(tile, m, H100_SMEM_OPTIN,
                                               torch.float32, k, n)
    assert ops.legalize_matmul_tile(tile, m, H100_SMEM_OPTIN, torch.float32,
                                    k, n).kind == "simt"


@pytest.mark.parametrize("n,k", [(11008, 4096), (4096, 11008), (1000, 333),
                                 (97, 64), (300, 0)])
def test_gemv_split_covers_k_and_fills_the_card(n, k):
    """K ranges of a multiple of 32 rows that cover K once, about four
    blocks per SM of an H100 (132 SMs) where K allows."""
    kchunk, ranges = kmm.gemv_split(n, k, 132)
    assert kchunk % 32 == 0 and kchunk >= 32 and ranges >= 1
    assert ranges * kchunk >= k and (ranges - 1) * kchunk < max(k, 1)
    cols = -(-n // 256)
    if k >= 32 * 4 * 132 // cols:
        assert 2 * 132 <= cols * ranges <= 8 * 132
    assert {(11008, 4096): (320, 13),
            (4096, 11008): (352, 32)}.get((n, k), (kchunk, ranges)) == \
        (kchunk, ranges)


def test_menus_mirror_the_cuda_sources():
    """Each tile menu against the `using` lines of its CUDA source (the
    library checks the same at load, on the card)."""
    src = (Path(pvmem.__file__).parents[1] / "csrc" / "cache_matmul.cu").read_text()
    menu = re.findall(r"using T(\d+) = (Tile<([\d, ]+)>|Gemv|Wgmma<(\d+), (\d+)>);", src)
    assert [int(i) for i, *_ in menu] == list(range(len(kmm.TILES)))
    for (i, _, simt, wbm, wbn), t in zip(menu, kmm.TILES):
        if simt:
            assert (t.kind, t.bm, t.bn, t.bk, t.tm, t.tn) == \
                ("simt", *map(int, simt.split(",")))
        elif wbm:
            assert (t.kind, t.bm, t.bn) == ("wgmma", int(wbm), int(wbn))
        else:
            assert t.kind == "gemv"
    src = (Path(pvmem.__file__).parents[1] / "csrc" /
           "block_fused_ffn.cu").read_text()
    menu = re.findall(r"using F(\d+) = (FfnTile<([\d, ]+)>|FfnWgmma<(\d+)>"
                      r"|FfnGemv);", src)
    assert [int(i) for i, *_ in menu] == list(range(len(kffn.TILES)))
    for (_, name, simt, wbs), t in zip(menu, kffn.TILES):
        if simt:
            assert (t.kind, t.bs, t.bf, t.bk, t.tm, t.tn) == \
                ("simt", *map(int, simt.split(",")))
        elif wbs:
            assert (t.kind, t.bs, t.bf) == ("wgmma", int(wbs), 128)
        else:
            assert name == "FfnGemv" and t.kind == "gemv"
        assert build.menu_fields(t) == t.menu_fields()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pages", [324, 600, 1200])
@pytest.mark.parametrize("s", [2, 256])
def test_legalized_ffn_tile_keeps_the_hidden_tile_under_the_plan(pages, s,
                                                                 dtype):
    plan = pplan.lower_ffn(128, 4096, 11008, 2, pages, want_fused=True)
    assert plan.fused
    hop = ops.legalize_ffn_tile(plan.block_s, plan.block_f, s,
                                H100_SMEM_OPTIN, dtype, 4096, 11008)
    assert hop in kffn.TILES and dtype in hop.dtypes
    assert hop.bs <= plan.block_s and hop.bf <= plan.block_f
    assert hop.smem_bytes <= H100_SMEM_OPTIN
    assert hop.bs >= min(s, max(t.bs for t in kffn.TILES
                                if t.kind == hop.kind))
    assert hop.kind == ("simt" if dtype != torch.bfloat16
                        else "wgmma" if s > 8 else "gemv")


@pytest.mark.parametrize("seq,pages", [(1024, None), (1024, 600), (128, 324),
                                       (128, 1200)])
def test_full_width_lbm_plans_legalize_ffn_to_wgmma(seq, pages):
    """bf16 prefill rows under full-width yi-9b LBM plans (the smallest
    fused grant at seq 1024 gives [256, 128]) take the 128-row wgmma tile,
    never above the plan's [block_s, block_f]; decode rows take the gemv
    tile F6 (8 x 64; the simt tile F0 before it)."""
    d, f = 4096, 11008
    pages = pages or pvmem.fused_ffn_pages(seq, d, f, 2)
    plan = pplan.lower_ffn(seq, d, f, 2, pages, want_fused=True)
    assert plan.fused
    if seq == 1024 and pages == pvmem.fused_ffn_pages(seq, d, f, 2):
        assert (plan.block_s, plan.block_f) == (256, 128)
    for s, want in ((2048, (128, "wgmma")), (300, (128, "wgmma")),
                    (37, (64, "wgmma")), (2, (8, "gemv"))):
        hop = ops.legalize_ffn_tile(plan.block_s, plan.block_f, s,
                                    H100_SMEM_OPTIN, torch.bfloat16, d, f)
        assert (hop.bs, hop.kind) == want, s
        assert hop.bs <= plan.block_s and hop.bf <= plan.block_f
        assert hop.smem_bytes <= H100_SMEM_OPTIN


@pytest.mark.parametrize("s,d,f,kind", [
    (2048, 4096, 11008, "wgmma"), (37, 520, 1000, "wgmma"),
    (8, 520, 1000, "gemv"),        # decode rows: the gemv tile
    (2, 4096, 11008, "gemv"), (1, 384, 1536, "gemv"),
    (9, 520, 1000, "wgmma"),
    (37, 333, 1000, "simt"),       # d_model % 8: x rows unaligned for TMA
    (37, 520, 1002, "simt"),       # d_ff % 8
    (2, 333, 1000, "simt"),        # ... and for the gemv tile's vectors
    (2, 520, 1002, "simt")])
def test_ffn_legalization_routes_by_dtype_rows_and_alignment(s, d, f, kind):
    hop = ops.legalize_ffn_tile(256, 128, s, H100_SMEM_OPTIN, torch.bfloat16,
                                d, f)
    assert hop.kind == kind == ops.ffn_kind(s, torch.bfloat16, d, f)
    assert ops.legalize_ffn_tile(256, 128, s, H100_SMEM_OPTIN, torch.float32,
                                 d, f).kind == "simt"


def test_partial_bytes_of_the_cluster_reduced_tile():
    """At the prefill shape (2048 x 4096, d_ff 11008) the simt tile's 172
    slabs are 5.77 GB of fp32 partials; the wgmma tile's clusters of 8
    128-wide d_ff tiles leave ceil(86 / 8) = 11 slabs, 0.37 GB."""
    s, d, f = 2048, 4096, 11008
    simt = kffn.TILES[3]
    wgmma = ops.legalize_ffn_tile(256, 128, s, H100_SMEM_OPTIN,
                                  torch.bfloat16, d, f)
    assert kffn.partial_bytes(simt, s, d, f) == 4 * 172 * s * d == 5771362304
    assert kffn.partial_bytes(wgmma, s, d, f) == 4 * 11 * s * d == 369098752
    assert kffn.partial_bytes(wgmma, s, d, f) <= 0.4e9
    assert kffn.partial_bytes(wgmma, 37, 520, 1000) == 4 * 1 * 37 * 520


def test_legalization_floor_when_no_tile_fits():
    tiny = pvmem.TileConfig(4, 4, 4, 0)
    floor = min(SIMT, key=lambda t: (t.bm * t.bn, t.smem_bytes))
    for dtype in (torch.float32, torch.bfloat16):   # no gemv / wgmma fits
        for m in (2, 256):
            assert ops.legalize_matmul_tile(tiny, m, H100_SMEM_OPTIN, dtype,
                                            4096, 11008) == floor
    for dtype in (torch.float32, torch.bfloat16):
        for s in (2, 256):
            assert ops.legalize_ffn_tile(4, 4, s, H100_SMEM_OPTIN, dtype,
                                         4096, 11008) == \
                min(kffn.TILES, key=lambda t: (t.bs * t.bf, t.smem_bytes))


# ------------------------------------------- block_fused_ffn's gemv kind --
def _cu_ints(src: str, names, env=None):
    """The values of ``constexpr int name = expr;`` declarations in a CUDA
    source, evaluated in order (C++ integer division)."""
    env = dict(env or {})
    for name in names:
        expr = re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)
        env[name] = eval(re.sub(r"(?<!/)/(?!/)", "//", expr), {}, env)
    return env


def test_ffn_gemv_menu_entry_mirrors_the_cuda_struct():
    """The gemv menu entry (kind, dtypes, block, shared memory at its 8
    rows) is csrc/block_fused_ffn.cu's FfnGemv, whose shared memory is
    ffn_gemv_floats(8) floats, within 232,448 bytes."""
    src = (Path(pvmem.__file__).parents[1] / "csrc" /
           "block_fused_ffn.cu").read_text()
    env = _cu_ints(src, ("FG_BF", "FG_BK", "FG_THREADS", "FG_MAX_S"))
    body = src.split("constexpr int ffn_gemv_floats(int mt) {", 1)[1]
    floats = re.search(r"return ([^;]+);", body).group(1)
    smem = 4 * eval(floats.replace("mt", "FG_MAX_S"), {}, env)
    tile = next(t for t in kffn.TILES if t.kind == "gemv")
    assert tile.menu_fields() == (
        kmm.KINDS.index("gemv"), 2, env["FG_MAX_S"], env["FG_BF"],
        env["FG_BK"], env["FG_MAX_S"], 8, smem)
    assert kffn.GEMV_THREADS == env["FG_THREADS"]
    assert tile.smem_bytes == smem <= H100_SMEM_OPTIN
    assert "struct FfnGemv" in src and "using F6 = FfnGemv;" in src


@pytest.mark.parametrize("d,f,want", [(4096, 11008, 2), (384, 1536, 4),
                                      (2560, 10240, 2), (4096, 5504, 4),
                                      (520, 1000, 8), (64, 256, 1),
                                      (128, 20000, 1), (4104, 5512, 4)])
def test_gemv_cluster_fills_the_card(d, f, want):
    """The gemv kind's cluster on an H100 (132 SMs): the fewest blocks a
    64-wide d_ff tile that give two blocks an SM, at least 64 d_model
    rows a block, at most 8; every block keeps a 16-byte vector of Wd's
    columns (the source refuses a cluster above d / 8)."""
    c = kffn.gemv_cluster(d, f, 132)
    assert c == want and c in (1, 2, 4, 8) and c <= d // 8
    tiles = -(-f // 64)
    assert tiles * c >= 2 * 132 or c == 8 or 2 * c > d // 64
    assert c == 1 or tiles * (c // 2) < 2 * 132


def test_partial_bytes_of_the_gemv_tile():
    """One fp32 [S, d] slab a 64-wide d_ff tile (its cluster writes it
    once): yi-9b's decode, 2 x 4096 at d_ff 11008, 172 slabs, 5.6 MB
    against 270 MB of weights; whisper-tiny's 24."""
    gemv = ops.legalize_ffn_tile(128, 128, 2, H100_SMEM_OPTIN,
                                 torch.bfloat16, 4096, 11008)
    assert gemv.kind == "gemv"
    assert kffn.partial_bytes(gemv, 2, 4096, 11008) == 4 * 172 * 2 * 4096
    assert kffn.partial_bytes(gemv, 2, 384, 1536) == 4 * 24 * 2 * 384


def _gemv_emulation(x, wg, wu, wd, cluster):
    """The gemv kind's sum order and cast points in torch fp32: d_model
    cut into ``cluster`` ranges [r d / C, (r + 1) d / C), the ranges' g
    and u partials added in rank order, h = silu(g) * u rounded to x's
    dtype, one fp32 [S, d] slab a 64-wide d_ff tile, the slabs added in
    tile order and cast to x's dtype."""
    s, d = x.shape
    f = wg.shape[1]
    xf, gf, uf, df = (t.float() for t in (x, wg, wu, wd))
    g = u = torch.zeros(s, f)
    for r in range(cluster):
        kb, ke = r * d // cluster, (r + 1) * d // cluster
        g = g + xf[:, kb:ke] @ gf[kb:ke]
        u = u + xf[:, kb:ke] @ uf[kb:ke]
    h = (g / (1 + torch.exp(-g)) * u).to(x.dtype).float()
    y = torch.zeros(s, d)
    for f0 in range(0, f, 64):
        y = y + h[:, f0:f0 + 64] @ df[f0:f0 + 64]
    return y.to(x.dtype)


@pytest.mark.parametrize("s,d,f", [(2, 384, 1536), (1, 520, 1000),
                                   (8, 64, 256), (5, 256, 200)])
def test_gemv_emulation_matches_reference(s, d, f):
    """The gemv kind, emulated at its own cluster (132 SMs) and at every
    other size, against the reference's Pallas kernel (interpret mode)
    and the plain version at the bf16 tolerance, on bf16 inputs; the
    legalization gives these shapes the gemv tile."""
    (xj, gj, uj, dj), (xt, gt, ut, dt) = _ffn_inputs(
        np.random.default_rng(9), s, d, f, "bfloat16")
    assert ops.legalize_ffn_tile(128, 128, s, H100_SMEM_OPTIN, torch.bfloat16,
                                 d, f).kind == "gemv"
    want = _np(ref_block_fused_ffn(xj, gj, uj, dj, block_s=s, block_f=f))
    plain = _np(kffn.block_fused_ffn_plain(xt, gt, ut, dt))
    clusters = {kffn.gemv_cluster(d, f, 132)} | {
        c for c in (1, 2, 4, 8) if c <= d // 8}
    for c in sorted(clusters):
        got = _gemv_emulation(xt, gt, ut, dt, c)
        assert got.dtype == torch.bfloat16 and got.shape == (s, d)
        np.testing.assert_allclose(_np(got), want, **tol("bfloat16"))
        np.testing.assert_allclose(_np(got), plain, **tol("bfloat16"))
