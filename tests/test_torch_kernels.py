"""The port's kernel wrappers against the JAX package's Pallas kernels.

Inputs are made with numpy from a seed and handed to both sides.  The
reference kernels run in Pallas interpret mode, as tests/test_kernels.py
runs them; the port's wrappers take their plain PyTorch versions because
the tensors lie on the CPU.  Tolerances are tests/test_kernels.py::tol.
The CUDA kernels themselves run only on the card (the ``gpu`` test below,
and ``chip_smoke.py``).
"""
import dataclasses

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
from repro_torch.kernels import cache_matmul as kmm
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
        assert t.bm % t.tm == 0 and t.bn % t.tn == 0
        assert (t.bm // t.tm) * (t.bn // t.tn) <= 1024
    for t in kffn.TILES:
        assert t.smem_bytes <= H100_SMEM_OPTIN
        assert (t.bs // t.tm) * (t.bf // t.tn) <= 1024


@pytest.mark.parametrize("pages", [32, 64, 300, 1200])
@pytest.mark.parametrize("m", [2, 256])
def test_legalized_matmul_tile_stays_under_the_plan(pages, m):
    """Full-width yi-9b LWM plans (sized for TPU VMEM) legalize to a
    compiled Hopper tile no larger than the plan's in any dimension,
    within shared memory, with the fewest wasted rows."""
    plan = pplan.lower_ffn(128, 4096, 11008, 2, pages, want_fused=False)
    for tile in (plan.up_tile, plan.down_tile):
        hop = ops.legalize_matmul_tile(tile, m, H100_SMEM_OPTIN)
        assert hop in kmm.TILES
        assert hop.bm <= tile.bm and hop.bn <= tile.bn and hop.bk <= tile.bk
        assert hop.smem_bytes <= H100_SMEM_OPTIN
        fits = [t.bm for t in kmm.TILES if t.bm <= tile.bm and t.bn <= tile.bn
                and t.bk <= tile.bk]
        assert hop.bm == min([b for b in fits if b >= m] or [max(fits)])


@pytest.mark.parametrize("pages", [324, 600, 1200])
@pytest.mark.parametrize("s", [2, 256])
def test_legalized_ffn_tile_keeps_the_hidden_tile_under_the_plan(pages, s):
    plan = pplan.lower_ffn(128, 4096, 11008, 2, pages, want_fused=True)
    assert plan.fused
    hop = ops.legalize_ffn_tile(plan.block_s, plan.block_f, s,
                                H100_SMEM_OPTIN)
    assert hop in kffn.TILES
    assert hop.bs <= plan.block_s and hop.bf <= plan.block_f
    assert hop.smem_bytes <= H100_SMEM_OPTIN
    assert hop.bs >= min(s, max(t.bs for t in kffn.TILES))


def test_legalization_floor_when_no_tile_fits():
    tiny = pvmem.TileConfig(4, 4, 4, 0)
    assert ops.legalize_matmul_tile(tiny, 2, H100_SMEM_OPTIN) == \
        min(kmm.TILES, key=lambda t: (t.bm * t.bn, t.smem_bytes))
    assert ops.legalize_ffn_tile(4, 4, 2, H100_SMEM_OPTIN) == \
        min(kffn.TILES, key=lambda t: (t.bs * t.bf, t.smem_bytes))


# ------------------------------------------------------- on the card --
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain_versions(dtype):
    """Each CUDA kernel against its plain version on the card, ragged
    shapes, every compiled tile.  Count one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dt)

    a, b = rand(37, 333), rand(333, 1000, scale=333 ** -0.5)
    for tile in kmm.TILES:
        before = kmm.launches
        got = kmm.cache_matmul(a, b, tile)
        assert kmm.launches == before + 1
        torch.testing.assert_close(got.float(),
                                   kmm.cache_matmul_plain(a, b).float(),
                                   **tol(dtype))
    x = rand(37, 333)
    wg, wu = rand(333, 1000, scale=333 ** -0.5), rand(333, 1000,
                                                     scale=333 ** -0.5)
    wd = rand(1000, 333, scale=1000 ** -0.5)
    for tile in kffn.TILES:
        before = kffn.launches
        got = kffn.block_fused_ffn(x, wg, wu, wd, tile)
        assert kffn.launches == before + 1
        torch.testing.assert_close(
            got.float(), kffn.block_fused_ffn_plain(x, wg, wu, wd).float(),
            **tol(dtype))
