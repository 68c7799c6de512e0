"""The port's dequant-fused matmul against the JAX package's.

``cache_matmul_quant_plain`` and the entry points ``planned_matmul_quant``
/ ``planned_ffn_quant`` (kernels/ops.py) against the reference's Pallas
kernel (interpret mode, as tests/test_quant.py runs it) and its jitted
entry points.  Inputs are made with numpy from a seed.  Weights reach the
port two ways: quantized by the port's ``quantize_cols`` from the same
numpy array, and as the reference's own codes and scales carried across
by ``bridge.tensor_from_numpy``.  Tolerances are tests/test_kernels.py::
tol (2e-3 fp32, 2e-2 bf16).  The CUDA kernel itself runs only on the card
(tests/test_torch_gpu.py and ``chip_smoke.py``); here the wrapper takes
its plain version because the tensors lie on the CPU.
"""
import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as rplan
from repro.core import vmem as rvmem
from repro.kernels import ops as rops
from repro.kernels import quant as rquant
from repro.kernels.cache_matmul import cache_matmul_quant as ref_cmq
from repro_torch.bridge import tensor_from_numpy
from repro_torch.core import plan as pplan
from repro_torch.core import vmem as pvmem
from repro_torch.kernels import build
from repro_torch.kernels import cache_matmul as kmm
from repro_torch.kernels import ops
from repro_torch.kernels import quant as pquant
from repro_torch.kernels import ref as pref

H100_SMEM_OPTIN = 232448   # shared_memory_per_block_optin of an H100
KV = ["int8", "fp8_e4m3"]


def tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else \
        dict(rtol=2e-3, atol=2e-3)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _act(rng, shape, dtype="float32"):
    x = rng.standard_normal(shape).astype(np.float32)
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _weight(rng, shape, kv, via):
    """(reference codes, scales), (port codes, scales) of one numpy
    weight: the port's quantize_cols on the same array, or the
    reference's codes carried across bit-exactly."""
    w = (rng.standard_normal(shape) * shape[0] ** -0.5).astype(np.float32)
    rq, rs = rquant.quantize_cols(jnp.asarray(w), kv)
    if via == "port":
        pq, ps = pquant.quantize_cols(torch.from_numpy(w), kv)
    else:
        pq = tensor_from_numpy(np.asarray(rq), "cpu")
        ps = tensor_from_numpy(np.asarray(rs), "cpu")
    return (rq, rs), (pq, ps)


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("via", ["port", "bridge"])
def test_cache_matmul_quant_plain_matches_reference(kv, dtype, via):
    rng = np.random.default_rng(1)
    a_j, a_t = _act(rng, (64, 96), dtype)
    (rq, rs), (pq, ps) = _weight(rng, (96, 128), kv, via)
    want = ref_cmq(a_j, rq, rs, rvmem.TileConfig(32, 64, 32, 0))
    before = kmm.launches_quant
    got = kmm.cache_matmul_quant(a_t, pq, ps, kmm.QUANT_TILES[0])
    assert kmm.launches_quant == before     # the CPU takes the plain version
    assert got.dtype == a_t.dtype and got.shape == (64, 128)
    np.testing.assert_allclose(_np(got), _np(want), **tol(dtype))


def test_matmul_quant_ref_is_the_plain_version():
    """``ref.matmul_quant_ref`` computes the reference's matmul_ref on
    the fp32 dequantized B (the oracle tests/test_quant.py uses)."""
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.standard_normal((16, 40)).astype(np.float32))
    q, s = pquant.quantize_cols(
        torch.from_numpy(rng.standard_normal((40, 24)).astype(np.float32)))
    assert pref.matmul_quant_ref is kmm.cache_matmul_quant_plain
    assert torch.equal(pref.matmul_quant_ref(a, q, s),
                       pref.matmul_ref(a, q.float() * s))


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("via", ["port", "bridge"])
def test_planned_matmul_quant_ragged_matches_reference(kv, via):
    """33 x 70 @ 70 x 50: the reference pads to the tile, the port masks."""
    rng = np.random.default_rng(3)
    a_j, a_t = _act(rng, (33, 70))
    (rq, rs), (pq, ps) = _weight(rng, (70, 50), kv, via)
    rtile = rvmem.TileConfig(32, 64, 32, 0)
    ptile = pvmem.TileConfig(32, 64, 32, 0)
    want = rops.planned_matmul_quant(a_j, rq, rs, rtile)
    got = ops.planned_matmul_quant(a_t, pq, ps, ptile)
    assert got.shape == (33, 50)
    np.testing.assert_allclose(_np(got), _np(want), **tol("float32"))


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("via", ["port", "bridge"])
def test_planned_ffn_quant_matches_reference(kv, fused, via):
    """An LWM plan runs its own tiles; a fused (LBM) plan has none and
    takes the fallback tile lowered from its pages at one byte an
    element, for the down GEMM too."""
    S, d, f = 24, 64, 160
    pages = 4096 if fused else 2
    rp = rplan.lower_ffn(S, d, f, 4, pages=pages, want_fused=fused)
    pp = pplan.lower_ffn(S, d, f, 4, pages=pages, want_fused=fused)
    assert rp.fused == pp.fused == fused
    assert repr(rp) == repr(pp)
    assert (pp.up_tile is None) == fused
    rng = np.random.default_rng(4)
    x_j, x_t = _act(rng, (S, d))
    (gq, gs), (pgq, pgs) = _weight(rng, (d, f), kv, via)
    (uq, us), (puq, pus) = _weight(rng, (d, f), kv, via)
    (dq, ds), (pdq, pds) = _weight(rng, (f, d), kv, via)
    want = rops.planned_ffn_quant(x_j, gq, gs, uq, us, dq, ds, rp)
    got = ops.planned_ffn_quant(x_t, pgq, pgs, puq, pus, pdq, pds, pp)
    np.testing.assert_allclose(_np(got), _np(want), **tol("float32"))


# ------------------------------------------------------ legalization --
QUANT_SHAPES = [(8, 32, 256, 1, 1), (16, 64, 64, 2, 2), (32, 64, 64, 2, 4),
                (64, 64, 32, 4, 4), (128, 128, 32, 8, 8), (8, 32, 32, 1, 1)]
# the bf16 tiles after them: the gemv decode tile and the wgmma tiles
QUANT_NEW = [("gemv", (8, 256, 256, 8, 16)),
             ("wgmma", (64, 256, 64, 64, 256)),
             ("wgmma", (128, 256, 64, 64, 256))]


def test_quant_menu_mirrors_the_matmul_menu_and_fits():
    """The quant kernel's menu is its own, written out: the six simt tile
    shapes cache_matmul's simt kernel had (fp32 and bf16), then the bf16
    gemv and wgmma tiles, pinned here and to the `using` lines of
    csrc/cache_matmul_quant.cu, whatever cache_matmul's menu holds.  A
    simt tile's shared memory adds the fp32 scale stripe to the
    fp32-staged A and dequantized B tiles; the wgmma tiles' holds the
    TMA ring of A and code tiles and three converted bf16 B tiles.  Its
    library describes each entry's kind, dtypes, shape and bytes."""
    simt = [t for t in kmm.QUANT_TILES if t.kind == "simt"]
    assert [(t.bm, t.bn, t.bk, t.tm, t.tn) for t in simt] == QUANT_SHAPES
    assert kmm.QUANT_TILES[:len(simt)] == tuple(simt)
    assert [(t.kind, (t.bm, t.bn, t.bk, t.tm, t.tn))
            for t in kmm.QUANT_TILES[len(simt):]] == QUANT_NEW
    src = (Path(pvmem.__file__).parents[1] / "csrc" /
           "cache_matmul_quant.cu").read_text()
    menu = re.findall(r"using Q(\d+) = (QTile<([\d, ]+)>|QGemv|QWgmma<(\d+), "
                      r"(\d+)>);", src)
    assert [int(i) for i, *_ in menu] == list(range(len(kmm.QUANT_TILES)))
    assert [tuple(map(int, v.split(","))) for _, _, v, _, _ in menu
            if v] == QUANT_SHAPES
    for (_, _, shape, wbm, wbn), t in zip(menu, kmm.QUANT_TILES):
        if wbm:
            assert (t.kind, t.bm, t.bn) == ("wgmma", int(wbm), int(wbn))
        elif not shape:
            assert t.kind == "gemv"
    for q in kmm.QUANT_TILES:
        assert not isinstance(q, kmm.HopperTile)   # a menu of its own
        bm, bn, bk = q.bm, q.bn, q.bk
        assert q.smem_bytes <= H100_SMEM_OPTIN
        if q.kind == "simt":
            assert set(q.dtypes) == {torch.float32, torch.bfloat16}
            assert q.smem_bytes == 4 * (bk * (bm + 1) + bk * bn) + 4 * bn
            assert (q.bm // q.tm) * (q.bn // q.tn) <= 1024
        else:
            assert q.dtypes == (torch.bfloat16,)
        if q.kind == "wgmma":
            assert q.smem_bytes == (1024 + 4 * (2 * bm * bk + bk * bn)
                                    + 3 * 2 * bk * bn + 2 * 4 * 8)
            assert bm % 64 == 0 and q.tn == bn == 256 and bk % 16 == 0
        assert build.menu_fields(q) == (kmm.KINDS.index(q.kind),
                                        kmm.dtype_mask(q.dtypes), bm, bn, bk,
                                        q.tm, q.tn, q.smem_bytes)


def _full_width_plan_tiles():
    """(label, plan tile) for every tile a full-width yi-9b FFN plan hands
    the quant kernel: LWM grants (decode and prefill seq blocks) and the
    fallback of fused grants at one byte an element."""
    d, f = 4096, 11008
    out = []
    for pages in (0, 16, 32, 64, 300, 1200, 1800):     # serve: 0, 32, 64
        for seq in (128, 1024):
            plan = pplan.lower_ffn(seq, d, f, 2, pages, want_fused=False)
            out += [(f"lwm@{pages}p/{seq} up", plan.up_tile),
                    (f"lwm@{pages}p/{seq} down", plan.down_tile)]
    for seq in (128, 1024):
        for extra in (0, 300):
            pages = pvmem.fused_ffn_pages(seq, d, f, 2) + extra
            plan = pplan.lower_ffn(seq, d, f, 2, pages, want_fused=True)
            assert plan.fused and plan.up_tile is None
            for m in (2, 2048):
                up, down = ops.ffn_quant_tiles(plan, m, d, f)
                assert up == down == pvmem.lower_matmul_tile(
                    m, f, d, 1, plan.vmem_pages)
                out.append((f"lbm@{pages}p m{m}", up))
    return out


SIMT_Q = [t for t in kmm.QUANT_TILES if t.kind == "simt"]


@pytest.mark.parametrize("m", [2, 256, 2048])
def test_full_width_plan_tiles_legalize_to_the_quant_menu(m):
    """fp32 A: every full-width plan tile legalizes by the simt rule over
    the quant menu's simt tiles; bf16 A: to the gemv tile at 2 rows and a
    wgmma tile (the 128-row one) at 256 and 2048, under the plan's tile
    and within shared memory."""
    for label, tile in _full_width_plan_tiles():
        hop = ops.legalize_matmul_quant_tile(tile, m, H100_SMEM_OPTIN,
                                             torch.float32, 4096, 11008)
        assert hop in SIMT_Q, label
        assert hop.smem_bytes <= H100_SMEM_OPTIN, label
        fits = [t for t in SIMT_Q if t.bm <= tile.bm
                and t.bn <= tile.bn and t.bk <= tile.bk]
        if fits:
            assert hop in fits, label
            assert hop.bm == min([t.bm for t in fits if t.bm >= m]
                                 or [max(t.bm for t in fits)]), label
        else:
            assert hop == kmm.QUANT_TILES[5], label
        for k, n in ((4096, 11008), (11008, 4096)):
            bf = ops.legalize_matmul_quant_tile(tile, m, H100_SMEM_OPTIN,
                                                torch.bfloat16, k, n)
            assert bf.kind == ("gemv" if m <= 8 else "wgmma"), label
            assert bf.bm == (8 if m <= 8 else 128), label
            assert bf.bm <= tile.bm and bf.bn <= tile.bn \
                and bf.bk <= tile.bk, label
            assert bf.smem_bytes <= H100_SMEM_OPTIN, label


@pytest.mark.parametrize("m,k,n,dtype,kind", [
    (2048, 4096, 11008, torch.float32, "simt"),    # fp32 never leaves simt
    (2, 4096, 11008, torch.float32, "simt"),
    (2, 4096, 11008, torch.bfloat16, "gemv"),
    (8, 333, 1000, torch.bfloat16, "gemv"),        # gemv masks K and N
    (9, 4096, 11008, torch.bfloat16, "wgmma"),
    (2048, 4096, 11008, torch.bfloat16, "wgmma"),
    (2048, 11008, 4096, torch.bfloat16, "wgmma"),
    (37, 520, 1000, torch.bfloat16, "simt"),       # N % 16: code rows unaligned
    (37, 333, 1008, torch.bfloat16, "simt"),       # K % 8: A rows unaligned
    (37, 520, 1008, torch.bfloat16, "wgmma")])
def test_quant_legalization_routes_by_dtype_rows_and_alignment(m, k, n,
                                                               dtype, kind):
    """The route is :func:`ops.matmul_quant_kind`'s: fp32 -> simt, bf16
    at most 8 rows -> gemv, more -> wgmma unless TMA's 16-byte row strides
    fail (K % 8 for A, N % 16 for the codes), where the fp32 rule's simt
    tile runs."""
    tile = pvmem.TileConfig(128, 256, 256, 0)
    hop = ops.legalize_matmul_quant_tile(tile, m, H100_SMEM_OPTIN, dtype, k, n)
    assert hop.kind == kind == ops.matmul_quant_kind(m, dtype, k, n)
    assert dtype in hop.dtypes
    if kind == "simt":
        assert hop == ops.legalize_matmul_quant_tile(tile, m, H100_SMEM_OPTIN,
                                                     torch.float32, k, n)
    if kind == "wgmma":
        assert hop.bm == (64 if m <= 64 else 128)


def test_quant_legalization_floor_when_no_tile_fits():
    tiny = pvmem.TileConfig(4, 4, 4, 0)
    for dtype in (torch.float32, torch.bfloat16):   # no gemv / wgmma fits
        for m in (2, 2048):
            assert ops.legalize_matmul_quant_tile(
                tiny, m, H100_SMEM_OPTIN, dtype, 4096, 11008) == \
                min(SIMT_Q, key=lambda t: (t.bm * t.bn, t.smem_bytes))


def test_quant_wrapper_rejects_malformed_operands():
    a = torch.zeros(4, 8)
    q, s = pquant.quantize_cols(torch.randn(8, 3))
    with pytest.raises(ValueError):
        kmm.cache_matmul_quant(a, q[:7], s, kmm.QUANT_TILES[0])
    with pytest.raises(ValueError):
        kmm.cache_matmul_quant(a, q, s[:, :2], kmm.QUANT_TILES[0])
    with pytest.raises(TypeError):
        kmm.cache_matmul_quant(a, q.float(), s, kmm.QUANT_TILES[0])
    with pytest.raises(TypeError):
        kmm.cache_matmul_quant(a, q, s.double(), kmm.QUANT_TILES[0])
    with pytest.raises(TypeError):
        kmm.cache_matmul_quant(a.double(), q, s, kmm.QUANT_TILES[0])
