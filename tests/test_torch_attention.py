"""The port's flash attention and quantization helpers against the JAX
package's.

Inputs are made with numpy from a seed and handed to both sides.  The
reference's Pallas kernels run in interpret mode, as
tests/test_kernels.py runs them; the port's wrappers take their plain
PyTorch versions because the tensors lie on the CPU.  float8 arrays
cross by bit view (``repro_torch.bridge``).

Tolerances: 2e-3 (rtol and atol) for fp32 at kernel level and 3e-2 for
bf16, those of tests/test_kernels.py; the port's own contracts (the
quantized kernel against the native one on dequantized K/V, int8
quantization) are exact.  The CUDA kernel itself runs only on the card
(tests/test_torch_gpu.py and ``chip_smoke.py``).
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as rplan
from repro.kernels import ops as rops
from repro.kernels import quant as rquant
from repro.kernels import ref as rref
from repro.kernels.flash_attention import flash_attention as ref_flash
from repro.kernels.flash_attention import \
    flash_attention_quantized as ref_flash_quantized
from repro_torch.bridge import tensor_from_numpy
from repro_torch.core import plan as pplan
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ops
from repro_torch.kernels import quant as pquant
from repro_torch.kernels import ref as pref

TOL = {"float32": dict(rtol=2e-3, atol=2e-3),
       "bfloat16": dict(rtol=3e-2, atol=3e-2)}
H100_SMEM_OPTIN = 232448   # shared_memory_per_block_optin of an H100


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jt(x, dtype="float32"):
    """One numpy array as a JAX array and a torch tensor of ``dtype``
    (bf16 rounds the same fp32 values to nearest even on both sides)."""
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _to_torch(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _tile(hd, dtype=torch.float32):
    return ops.legalize_attn_tile(128, 128, hd, 64, H100_SMEM_OPTIN, dtype)


# ------------------------------------------------------------ kernels --
@pytest.mark.parametrize("H,Hkv", [(8, 2), (4, 4)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_pallas(H, Hkv, causal):
    """GQA and plain multi-head, causal and not, S 64, blocks 32 (as
    tests/test_kernels.py::test_flash_attention_gqa runs the kernel)."""
    B, S, hd = 2, 64, 32
    q, k, v = _arrays(0, (B, H, S, hd), (B, Hkv, S, hd), (B, Hkv, S, hd))
    (qj, qt), (kj, kt), (vj, vt) = _jt(q), _jt(k), _jt(v)
    want = ref_flash(qj, kj, vj, causal=causal, block_q=32, block_kv=32)
    before = kfa.launches
    got = kfa.flash_attention(qt, kt, vt, causal, _tile(hd))
    assert kfa.launches == before     # the CPU takes the plain version
    assert got.dtype == qt.dtype and got.shape == qt.shape
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])
    np.testing.assert_allclose(_np(kfa.flash_attention_plain(qt, kt, vt, causal)),
                               _np(want), **TOL["float32"])


def test_flash_attention_bf16_matches_pallas():
    """bf16: p is rounded to V's dtype before the P.V product, as the
    reference kernel rounds it."""
    B, H, S, hd = 1, 2, 64, 32
    q, k, v = _arrays(1, (B, H, S, hd), (B, H, S, hd), (B, H, S, hd))
    (qj, qt), (kj, kt), (vj, vt) = (_jt(x, "bfloat16") for x in (q, k, v))
    want = ref_flash(qj, kj, vj, block_q=32, block_kv=32)
    got = kfa.flash_attention(qt, kt, vt, True, _tile(hd))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **TOL["bfloat16"])


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_quantized_matches_pallas(kv_dtype, causal):
    """The same quantized K/V (the reference's quantize_rows) into the
    reference's dequant-fused kernel and the port's."""
    B, H, Hkv, S, hd = 1, 4, 2, 64, 32
    q, k, v = _arrays(2, (B, H, S, hd), (B, Hkv, S, hd), (B, Hkv, S, hd))
    kq, ks = rquant.quantize_rows(jnp.asarray(k), kv_dtype)
    vq, vs = rquant.quantize_rows(jnp.asarray(v), kv_dtype)
    want = ref_flash_quantized(jnp.asarray(q), kq, vq, ks[..., 0], vs[..., 0],
                               causal=causal, block_q=32, block_kv=32)
    before = kfa.launches_quantized
    got = kfa.flash_attention_quantized(
        torch.from_numpy(q), _to_torch(kq), _to_torch(vq),
        _to_torch(ks[..., 0]), _to_torch(vs[..., 0]), causal, _tile(hd))
    assert kfa.launches_quantized == before
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
def test_quantized_equals_native_on_dequantized_bitwise(kv_dtype):
    """The port against itself, as tests/test_quant.py::
    test_flash_quantized_matches_flash_on_dequantized holds the
    reference: in fp32 the dequant-fused path equals the native path fed
    the dequantized K/V, bit for bit."""
    B, H, Hkv, S, hd = 1, 4, 2, 256, 32
    q, k, v = (torch.from_numpy(a) for a in _arrays(
        3, (B, H, S, hd), (B, Hkv, S, hd), (B, Hkv, S, hd)))
    kq, ks = pquant.quantize_rows(k, kv_dtype)
    vq, vs = pquant.quantize_rows(v, kv_dtype)
    tile = _tile(hd)
    got = kfa.flash_attention_quantized(q, kq, vq, ks[..., 0], vs[..., 0],
                                        True, tile)
    want = kfa.flash_attention(q, pquant.dequantize_rows(kq, ks),
                               pquant.dequantize_rows(vq, vs), True, tile)
    assert torch.equal(got, want)


@pytest.mark.parametrize("causal", [True, False])
def test_ragged_attention_matches_attention_ref(causal):
    """Ragged S = Sk = 50 against blocks of 32: the port masks the ragged
    keys in the kernel.  Compared with the reference's attention_ref:
    non-causal, the reference's ops.attention lets its zero-padded keys
    into the softmax."""
    B, H, Hkv, S, hd = 2, 4, 2, 50, 32
    q, k, v = _arrays(4, (B, H, S, hd), (B, Hkv, S, hd), (B, Hkv, S, hd))
    want = rref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal)
    got = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), causal=causal, block_q=32,
                        block_kv=32)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


@pytest.mark.parametrize("kv_dtype", ["native", "int8", "fp8_e4m3"])
def test_ops_attention_matches_reference(kv_dtype):
    """ops.attention, quantization included, against the reference's
    (causal, where its padding is masked too), with blocks lowered from
    one grant by both packages."""
    B, H, Hkv, S, hd = 1, 4, 2, 96, 32
    rp = rplan.lower_attn(hd, 4, 9, kv_dtype, 1 if kv_dtype != "native" else 4)
    pp = pplan.lower_attn(hd, 4, 9, kv_dtype, 1 if kv_dtype != "native" else 4)
    assert repr(rp) == repr(pp)
    q, k, v = _arrays(5, (B, H, S, hd), (B, Hkv, S, hd), (B, Hkv, S, hd))
    want = rops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          block_q=rp.block_q, block_kv=rp.block_kv,
                          kv_dtype=kv_dtype)
    got = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), block_q=pp.block_q,
                        block_kv=pp.block_kv, kv_dtype=kv_dtype)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_ref_matches_reference(dtype, causal):
    B, H, Hkv, S, Sk, hd = 2, 4, 2, 24, 40, 32
    q, k, v = _arrays(6, (B, H, S, hd), (B, Hkv, Sk, hd), (B, Hkv, Sk, hd))
    (qj, qt), (kj, kt), (vj, vt) = (_jt(x, dtype) for x in (q, k, v))
    got = pref.attention_ref(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype
    np.testing.assert_allclose(
        _np(got), _np(rref.attention_ref(qj, kj, vj, causal=causal)),
        **TOL[dtype])


# ------------------------------------------------------- quantization --
@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
def test_quantize_rows_and_cols_match_reference(kv_dtype):
    """Same fp32 input, same codes and scales: int8 and float8 (compared
    by bit view) exactly equal; dequantized rows equal too."""
    (x,) = _arrays(7, (2, 3, 40, 32))
    x[0, 0, 0] = 0.0                      # the amax == 0 guard
    x[1, 2, 5, 7] = 1e4                   # one large value in a row
    rq, rs = rquant.quantize_rows(jnp.asarray(x), kv_dtype)
    pq, ps = pquant.quantize_rows(torch.from_numpy(x), kv_dtype)
    assert pq.dtype == pquant.kv_storage_dtype(kv_dtype)
    assert pquant.kv_dtype_of(pq.dtype) == kv_dtype
    assert torch.equal(pq, _to_torch(rq)) and torch.equal(ps, _to_torch(rs))
    np.testing.assert_array_equal(
        pquant.dequantize_rows(pq, ps).numpy(),
        np.asarray(rquant.dequantize_rows(rq, rs)))
    w = x[0, 0]
    rq, rs = rquant.quantize_cols(jnp.asarray(w), kv_dtype)
    pq, ps = pquant.quantize_cols(torch.from_numpy(w), kv_dtype)
    assert torch.equal(pq, _to_torch(rq)) and torch.equal(ps, _to_torch(rs))


def test_quantize_int8_per_tensor_matches_reference():
    (x,) = _arrays(8, (64, 48))
    rq, rs = rquant.quantize_int8(jnp.asarray(x))
    pq, ps = pquant.quantize_int8(torch.from_numpy(x))
    assert torch.equal(pq, _to_torch(rq))
    assert float(ps) == float(rs)
    np.testing.assert_array_equal(pquant.dequantize_int8(pq, ps).numpy(),
                                  np.asarray(rquant.dequantize_int8(rq, rs)))
    zq, zs = pquant.quantize_int8(torch.zeros(4))
    assert float(zs) == 1.0 and not zq.any()


def test_quant_names_match_reference():
    assert pquant.KV_DTYPES == rquant.KV_DTYPES
    for name in ("int8", "fp8_e4m3"):
        assert pquant.is_quantized(name)
        assert pquant.kv_qmax(name) == rquant.kv_qmax(name)
        assert (str(pquant.kv_storage_dtype(name)).removeprefix("torch.")
                == np.dtype(rquant.kv_storage_dtype(name)).name)
    assert not pquant.is_quantized("native")
    with pytest.raises(ValueError):
        pquant.kv_dtype_of(torch.float32)


# --------------------------------------------------------- the menu ---
def test_compiled_attn_tiles_fit_hopper():
    """Head dims 32, 64, 112 (kimi-k2) and 128; wgmma tiles of 128 q rows
    at hd 128, 112 and 64 for native and for quantized K/V, and of 64
    rows at hd 64 for native K/V; simt tiles at every head dim."""
    assert {t.hd for t in kfa.TILES} == {32, 64, 112, 128}
    wgmma = sorted((t.hd, t.bq, t.kv) for t in kfa.TILES
                   if t.kind == "wgmma")
    assert wgmma == sorted([(hd, 128, kv) for hd in (64, 112, 128)
                            for kv in (("native",), ("quantized",))]
                           + [(64, 64, ("native",))])
    for t in kfa.TILES:
        assert t.smem_bytes <= H100_SMEM_OPTIN
        if t.kind == "wgmma":   # warpgroups of 64 q rows, hd-wide P.V
            assert t.dtypes == (torch.bfloat16,)
            assert (t.bkv, t.tm, t.tn) == (128, 64, 128)
            continue
        assert t.kind == "simt"
        ntx, nty = t.bkv // t.tn, t.bq // t.tm
        assert ntx * nty <= 1024 and (ntx * nty) % 32 == 0
        assert ntx <= 32 and ntx & (ntx - 1) == 0 and t.hd % ntx == 0


SIMT = [t for t in kfa.TILES if t.kind == "simt"]
FLASH_WGMMA = next(t for t in kfa.TILES
                   if t.kind == "wgmma" and "native" in t.kv)
FLASH_WGMMA_QUANT = next(t for t in kfa.TILES
                         if t.kind == "wgmma" and "quantized" in t.kv)
# hd 64's native wgmma tiles by q rows
FLASH_HD64 = {t.bq: t for t in kfa.TILES if t.kind == "wgmma" and t.hd == 64
              and t.kv == ("native",)}
# the 128-row wgmma tiles by (head dim, K/V storage)
FLASH_WGMMA_BY = {(t.hd, t.kv[0]): t for t in kfa.TILES
                  if t.kind == "wgmma" and t.bq == 128}


@pytest.mark.parametrize("pages", [9, 32, 60, 456])
@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
@pytest.mark.parametrize("hd", [32, 64, 112, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_legalized_attn_tile_stays_under_the_plan(pages, kv_dtype, hd, dtype):
    """Plans lowered at full width (bf16) legalize to a compiled tile of
    the head dim, no larger than the plan's blocks, within shared
    memory: for bf16 q at hd 128, 112 and 64 the 128-row wgmma tile of
    the K/V storage (native or quantized; no grid given: the fewest
    wasted rows), else the simt tile the simt-only rule picks (fp32, hd
    32)."""
    plan = pplan.lower_attn(hd, 2, pages, kv_dtype,
                            1 if kv_dtype != "native" else 2)
    for s in (333, 1024):
        tile = ops.legalize_attn_tile(plan.block_q, plan.block_kv, hd, s,
                                      H100_SMEM_OPTIN, dtype,
                                      kv_dtype != "native")
        assert tile in kfa.TILES and tile.hd == hd and dtype in tile.dtypes
        assert tile.bq <= plan.block_q and tile.bkv <= plan.block_kv
        assert tile.smem_bytes <= H100_SMEM_OPTIN
        if dtype == torch.bfloat16 and hd != 32:
            kv = "native" if kv_dtype == "native" else "quantized"
            assert tile == FLASH_WGMMA_BY[(hd, kv)]
            if hd == 128:
                assert tile == (FLASH_WGMMA if kv == "native"
                                else FLASH_WGMMA_QUANT)
            if (hd, kv) == (64, "native"):
                assert tile == FLASH_HD64[128]
            continue
        assert tile.kind == "simt"
        fits = [t for t in SIMT if t.hd == hd
                and t.smem_bytes <= H100_SMEM_OPTIN]
        assert tile.bq == max(t.bq for t in fits)
    # a small grant lowers to (128, 128) and a large one to (512, 512)
    assert (pplan.lower_attn(128, 2, 9).block_q,
            pplan.lower_attn(128, 2, 9).block_kv) == (128, 128)
    assert (pplan.lower_attn(128, 2, 60).block_q,
            pplan.lower_attn(128, 2, 60).block_kv) == (512, 512)


@pytest.mark.parametrize("pages", [9, 32, 60, 456])
def test_bf16_native_hd128_takes_the_wgmma_flash_tile(pages):
    """The path's attention (bf16, native K/V, hd 128) runs the wgmma
    kernel under every plan, and with quantized K/V the quantized wgmma
    kernel; in fp32 it keeps the simt tile it had (at hd 128: 64 x 64
    for up to 64 rows, else 128 x 64)."""
    plan = pplan.lower_attn(128, 2, pages)
    assert plan.block_q >= 128 and plan.block_kv >= 128
    for s, kept in ((40, kfa.AttnTile(128, 64, 64, 4, 4)),
                    (1024, kfa.AttnTile(128, 128, 64, 8, 4))):
        assert ops.legalize_attn_tile(plan.block_q, plan.block_kv, 128, s,
                                      H100_SMEM_OPTIN, torch.bfloat16) \
            == FLASH_WGMMA
        assert ops.legalize_attn_tile(plan.block_q, plan.block_kv, 128, s,
                                      H100_SMEM_OPTIN, torch.bfloat16,
                                      True) == FLASH_WGMMA_QUANT
        assert ops.legalize_attn_tile(plan.block_q, plan.block_kv, 128, s,
                                      H100_SMEM_OPTIN, torch.float32) == kept


def test_legalize_attn_tile_floor_and_unknown_head_dim():
    for dtype in (torch.float32, torch.bfloat16):
        assert ops.legalize_attn_tile(16, 16, 64, 8, H100_SMEM_OPTIN,
                                      dtype) == \
            min((t for t in SIMT if t.hd == 64),
                key=lambda t: (t.bq * t.bkv, t.smem_bytes))
        assert ops.legalize_attn_tile(128, 128, 64, 40, None, dtype).bq == 64
        # below the wgmma tile's blocks, hd 128 keeps a simt tile
        assert ops.legalize_attn_tile(64, 64, 128, 40, H100_SMEM_OPTIN,
                                      dtype).kind == "simt"
        with pytest.raises(ValueError, match="head dim"):
            ops.legalize_attn_tile(128, 128, 16, 64, H100_SMEM_OPTIN, dtype)


def test_flash_menu_mirrors_the_cuda_source():
    src = (Path(pplan.__file__).parents[1] / "csrc" /
           "flash_attention.cu").read_text()
    menu = re.findall(r"using A(\d+) = (AttnTile<([\d, ]+)>"
                      r"|FlashWgmma<(\d+), (\d+)>|FlashWgmmaQuant<(\d+)>);",
                      src)
    assert [int(i) for i, *_ in menu] == list(range(len(kfa.TILES)))
    for (_, name, simt, hd, bq, qhd), t in zip(menu, kfa.TILES):
        if simt:
            assert (t.kind, t.hd, t.bq, t.bkv, t.tm, t.tn) == \
                ("simt", *map(int, simt.split(",")))
        elif hd:
            assert (t.kind, t.hd, t.bq, t.kv) == ("wgmma", int(hd), int(bq),
                                                  ("native",))
        else:
            assert t == FLASH_WGMMA_BY[(int(qhd), "quantized")]
            assert name == f"FlashWgmmaQuant<{t.hd}>"
    assert FLASH_WGMMA_QUANT == FLASH_WGMMA_BY[(128, "quantized")]


def test_flash_wrappers_reject_malformed_operands():
    q = torch.zeros(1, 4, 8, 32)
    kv = torch.zeros(1, 2, 8, 32)
    t32 = _tile(32)
    with pytest.raises(ValueError):                 # H % Hkv != 0
        kfa.flash_attention(q, torch.zeros(1, 3, 8, 32),
                            torch.zeros(1, 3, 8, 32), True, t32)
    with pytest.raises(ValueError):                 # tile of another hd
        kfa.flash_attention(q, kv, kv, True, _tile(64))
    with pytest.raises(TypeError):                  # mixed dtypes
        kfa.flash_attention(q, kv.bfloat16(), kv.bfloat16(), True, t32)
    with pytest.raises(TypeError):                  # native K/V to quantized
        kfa.flash_attention_quantized(q, kv, kv, torch.ones(1, 2, 8),
                                      torch.ones(1, 2, 8), True, t32)
    with pytest.raises(ValueError):                 # scale shape
        kfa.flash_attention_quantized(q, kv.to(torch.int8), kv.to(torch.int8),
                                      torch.ones(1, 2, 9),
                                      torch.ones(1, 2, 9), True, t32)
    with pytest.raises(TypeError):                  # q dtype
        kfa.flash_attention(q.half(), kv.half(), kv.half(), True, t32)
    q128, kv128 = torch.zeros(1, 4, 8, 128), torch.zeros(1, 2, 8, 128)
    with pytest.raises(TypeError):                  # wgmma tile, fp32 q
        kfa.flash_attention(q128, kv128, kv128, True, FLASH_WGMMA)
    with pytest.raises(TypeError):                  # wgmma tile, quantized
        kfa.flash_attention_quantized(
            q128.bfloat16(), kv128.to(torch.int8), kv128.to(torch.int8),
            torch.ones(1, 2, 8), torch.ones(1, 2, 8), True, FLASH_WGMMA)


# ------------------------------------------- quantized wgmma flash tile --
def _cu_struct(name, **params):
    """The ``static constexpr int`` members of struct ``name`` in
    csrc/flash_attention.cu, evaluated in order (C++ integer division,
    ``a ? b : c``) with the template parameters ``params`` (FlashWgmma's
    HD and BQ)."""
    src = (Path(pplan.__file__).parents[1] / "csrc" /
           "flash_attention.cu").read_text()
    body = src.split(f"struct {name} {{", 1)[1].split("};", 1)[0]
    env = dict(params)
    for decl in re.findall(r"static constexpr int ([^;]+);", body):
        for item in re.split(r",\s*(?=\w+ =)", decl):
            key, expr = (x.strip() for x in item.split("=", 1))
            expr = re.sub(r"(?<!/)/(?!/)", "//", expr)
            expr = re.sub(r"^(.+?) \? (.+?) : (.+)$", r"(\2) if (\1) else (\3)",
                          expr)
            env[key] = eval(expr, {}, dict(env))
    return env


@pytest.mark.parametrize("name", ["FlashWgmma", "FlashWgmmaQuant"])
def test_wgmma_flash_tiles_mirror_the_cuda_source(name):
    """Each 128-row wgmma menu entry's fields and shared memory (hd 128,
    112 and 64) are the .cu struct's, and fit in 232,448 bytes; the
    quantized ones serve int8 / e4m3 K/V only, the native ones native
    K/V only.  The quantized kernel holds two code stages where they fit
    (hd 112 and 64), one at hd 128."""
    kv = "native" if name == "FlashWgmma" else "quantized"
    for hd in (128, 112, 64):
        cu = _cu_struct(name, HD=hd, BQ=128)
        tile = FLASH_WGMMA_BY[(hd, kv)]
        mask = tile.menu_fields()  # the fields flash_attention_tile writes
        assert mask[0] == cu["kind"] and mask[1] == cu["dtypes"]
        assert (tile.hd, tile.bq, tile.bkv, tile.tm, tile.tn) == \
            (cu["hd"], cu["bq"], cu["bkv"], cu["tm"], cu["tn"])
        assert tile.smem_bytes == cu["smem"] <= H100_SMEM_OPTIN
        assert mask[7] == cu["kv"] and mask[8] == tile.smem_bytes
        assert tile.kv == (kv,)
        assert cu["boxes"] == (1 if hd == 64 else 2)
        if kv == "quantized":
            assert cu["stages"] == kfa.wgmma_quant_stages(hd) == \
                (1 if hd == 128 else 2)
            assert cu["smem_limit"] == H100_SMEM_OPTIN
    assert FLASH_WGMMA == FLASH_WGMMA_BY[(128, "native")]
    assert FLASH_WGMMA_QUANT == FLASH_WGMMA_BY[(128, "quantized")]


@pytest.mark.parametrize("bq", [128, 64])
def test_hd64_wgmma_flash_tiles_mirror_the_cuda_source(bq):
    """The hd-64 wgmma entries are csrc/flash_attention.cu's FlashWgmma<64,
    bq>: 4 k-steps of 16 for S = Q K^T, a 4-stage K/V ring of one
    128-byte box a tile (16 KB), one consumer warpgroup per 64 q rows;
    their shared memory fits 232,448 bytes, and the hd-128 entry keeps
    its 2-stage ring and its 164,904 bytes."""
    cu = _cu_struct("FlashWgmma", HD=64, BQ=bq)
    tile = FLASH_HD64[bq]
    fields = tile.menu_fields()
    assert (fields[0], fields[1], fields[7]) == (cu["kind"], cu["dtypes"],
                                                 cu["kv"])
    assert (tile.hd, tile.bq, tile.bkv, tile.tm, tile.tn) == \
        (cu["hd"], cu["bq"], cu["bkv"], cu["tm"], cu["tn"])
    assert (cu["stages"], cu["boxes"], cu["tile_bytes"]) == (4, 1, 16384)
    assert cu["threads"] == 128 * (bq // 64) + 32
    assert tile.smem_bytes == cu["smem"] == fields[8] <= H100_SMEM_OPTIN
    hd128 = _cu_struct("FlashWgmma", HD=128, BQ=128)
    assert (hd128["stages"], hd128["smem"]) == (2, 164904)
    assert FLASH_WGMMA.smem_bytes == 164904
    # hd 112 is carried in the hd-128 tile's boxes: its ring and bytes
    hd112 = _cu_struct("FlashWgmma", HD=112, BQ=128)
    assert (hd112["stages"], hd112["boxes"], hd112["smem"]) == (2, 2, 164904)


@pytest.mark.parametrize("pages", [0, 1, 9, 32, 60, 200, 456, 1000])
def test_bf16_native_hd64_takes_a_wgmma_flash_tile(pages):
    """bf16 q with native K/V at hd 64 runs a wgmma tile under every
    grant's attention blocks (at least 128 x 128).  With the grid known
    (batch x heads, 132 SMs) it takes the largest q tile whose grid still
    gives every SM a block, else 64 rows: whisper-tiny's 2 x 6 heads up
    to 448 rows take 64, a batch of 8 or 1,500 rows 128; without it, the
    fewest wasted rows (64 up to 64 rows, else 128).  Quantized K/V runs
    the quantized wgmma tile of hd 64 (128 rows, its only one); fp32 q
    keeps the simt tiles."""
    plan = pplan.lower_attn(64, 2, pages)
    assert plan.block_q >= 128 and plan.block_kv >= 128
    for heads, s, bq in ((12, 448, 64), (12, 333, 64), (12, 1, 64),
                         (12, 1024, 64), (48, 448, 128), (48, 333, 128),
                         (12, 1500, 128), (64, 1024, 128), (0, 40, 64),
                         (0, 64, 64), (0, 65, 128), (0, 448, 128)):
        assert ops.legalize_attn_tile(plan.block_q, plan.block_kv, 64, s,
                                      H100_SMEM_OPTIN, torch.bfloat16, False,
                                      heads, 132) == FLASH_HD64[bq], (heads, s)
        assert ops.legalize_attn_tile(
            plan.block_q, plan.block_kv, 64, s, H100_SMEM_OPTIN,
            torch.bfloat16, True, heads, 132) == FLASH_WGMMA_BY[(64,
                                                                 "quantized")]
        for quantized in (False, True):
            assert ops.legalize_attn_tile(
                plan.block_q, plan.block_kv, 64, s, H100_SMEM_OPTIN,
                torch.float32, quantized, heads, 132).kind == "simt"
    # hd 128 has one wgmma tile a K/V storage, grid or not
    assert ops.legalize_attn_tile(128, 128, 128, 448, H100_SMEM_OPTIN,
                                  torch.bfloat16, False, 12, 132) == FLASH_WGMMA


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("pages", [0, 1, 9, 32, 60, 200, 456, 1000])
def test_bf16_quantized_hd128_takes_the_quantized_wgmma_tile(kv_dtype, pages):
    """Every LWM grant with int8 / fp8 KV lowers attention blocks of at
    least 128 x 128 (core/plan.py::lower_attn), so bf16 q at hd 128 runs
    the quantized wgmma kernel at every prompt length; ops.attention
    routes there too."""
    plan = pplan.lower_attn(128, 2, pages, kv_dtype, 1)
    assert plan.block_q >= 128 and plan.block_kv >= 128
    for s in (1, 40, 333, 1024, 4096):
        assert ops.legalize_attn_tile(plan.block_q, plan.block_kv, 128, s,
                                      H100_SMEM_OPTIN, torch.bfloat16,
                                      True) == FLASH_WGMMA_QUANT


@pytest.mark.parametrize("hd", [32, 64, 112, 128])
def test_quantized_fp32_and_other_head_dims_keep_simt(hd):
    """fp32 q (any head dim) and bf16 q at hd 32 keep the simt tiles
    with quantized K/V; bf16 at hd 64, 112 and 128 takes the quantized
    wgmma tile; below 128 x 128 blocks hd 128 keeps simt."""
    for dtype in (torch.float32, torch.bfloat16):
        tile = ops.legalize_attn_tile(512, 512, hd, 1024, H100_SMEM_OPTIN,
                                      dtype, True)
        want_wgmma = dtype == torch.bfloat16 and hd != 32
        assert tile.kind == ("wgmma" if want_wgmma else "simt")
        assert "quantized" in tile.kv
    assert ops.legalize_attn_tile(64, 128, 128, 1024, H100_SMEM_OPTIN,
                                  torch.bfloat16, True).kind == "simt"


def test_quantized_wgmma_tile_rejects_what_it_cannot_launch():
    """The quantized wgmma tile takes bf16 q with int8 / e4m3 K/V only."""
    q = torch.zeros(1, 4, 8, 128)
    kv = torch.zeros(1, 2, 8, 128)
    ones = torch.ones(1, 2, 8)
    with pytest.raises(TypeError):                  # native K/V
        kfa.flash_attention(q.bfloat16(), kv.bfloat16(), kv.bfloat16(), True,
                            FLASH_WGMMA_QUANT)
    with pytest.raises(TypeError):                  # fp32 q
        kfa.flash_attention_quantized(q, kv.to(torch.int8), kv.to(torch.int8),
                                      ones, ones, True, FLASH_WGMMA_QUANT)
    before = dict(kfa.launches_quantized_by_kind)
    got = kfa.flash_attention_quantized(q.bfloat16(), kv.to(torch.int8),
                                        kv.to(torch.int8), ones, ones, True,
                                        FLASH_WGMMA_QUANT)
    assert got.dtype == torch.bfloat16            # the CPU: plain version
    assert kfa.launches_quantized_by_kind == before


def _folded_scales_flash(q, kq, vq, ks, vs, causal, bkv=128):
    """The quantized wgmma kernel's cast points, in torch: the codes
    exact in bf16; s = (q . code_k) * ks * hd^-0.5 in fp32 (the K scale
    folded into the score columns); an online softmax over 128-key
    tiles with fp32 m and l (l sums the fp32 p); p' = bf16(p * vs) (the
    V scale folded into P before its bf16 rounding); O += p' . code_v in
    fp32; O / l (l == 0 guarded) to bf16."""
    B, H, S, hd = q.shape
    g = H // kq.shape[1]
    kc = kq.float().repeat_interleave(g, 1)
    vc = vq.float().repeat_interleave(g, 1)
    ksr, vsr = ks.repeat_interleave(g, 1), vs.repeat_interleave(g, 1)
    qf = q.float()
    Sk = kc.shape[2]
    m = torch.full((B, H, S), -1e30)
    l = torch.zeros((B, H, S))
    o = torch.zeros((B, H, S, hd))
    qpos = torch.arange(S)[:, None]
    for k0 in range(0, Sk, bkv):
        kt, vt = kc[:, :, k0:k0 + bkv], vc[:, :, k0:k0 + bkv]
        s = (qf @ kt.transpose(-1, -2)) * ksr[:, :, None, k0:k0 + bkv] \
            * hd ** -0.5
        if causal:
            kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
            s = torch.where(kpos > qpos, torch.full_like(s, -1e30), s)
        m_new = torch.maximum(m, s.max(-1).values)
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        pv = (p * vsr[:, :, None, k0:k0 + bkv]).bfloat16().float()
        o = o * alpha[..., None] + pv @ vt
        m = m_new
    return (o / torch.where(l == 0, torch.ones_like(l), l)[..., None]).bfloat16()


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("causal", [True, False])
def test_folded_scales_emulation_matches_pallas(kv_dtype, causal):
    """The quantized wgmma kernel's rounding, emulated in torch (scales
    folded into the scores and into P, P' rounded to bf16), against the
    reference's dequant-fused Pallas kernel in interpret mode, bf16 q at
    hd 128 with 128 x 128 blocks, at the bf16 tolerance of
    tests/test_kernels.py::tol (2e-2); and against the port's plain
    version, which chip_smoke.py holds the kernel to."""
    B, H, Hkv, S, hd = 1, 4, 2, 256, 128
    q, k, v = _arrays(9, (B, H, S, hd), (B, Hkv, S, hd), (B, Hkv, S, hd))
    kq, ks = rquant.quantize_rows(jnp.asarray(k), kv_dtype)
    vq, vs = rquant.quantize_rows(jnp.asarray(v), kv_dtype)
    qj, qt = _jt(q, "bfloat16")
    want = ref_flash_quantized(qj, kq, vq, ks[..., 0], vs[..., 0],
                               causal=causal, block_q=128, block_kv=128)
    kt, vt = _to_torch(kq), _to_torch(vq)
    kst, vst = _to_torch(ks[..., 0]), _to_torch(vs[..., 0])
    got = _folded_scales_flash(qt, kt, vt, kst, vst, causal)
    tol = dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    np.testing.assert_allclose(
        _np(got), _np(kfa.flash_attention_quantized_plain(qt, kt, vt, kst, vst,
                                                          causal)), **tol)


# ------------------------------------------ head dim 112 (kimi-k2) ---
@pytest.mark.parametrize("kv_dtype", ["native", "int8", "fp8_e4m3"])
@pytest.mark.parametrize("S", [64, 50])
def test_ops_attention_hd112_matches_pallas(kv_dtype, S):
    """kimi-k2's head dim: ops.attention at hd 112, GQA 8:1, causal, S 64
    and a ragged 50, against the reference's ops.attention (its Pallas
    kernels in interpret mode) in fp32, and in bf16 for native K/V, at
    the existing tolerances; with quantized K/V in bf16 the port's
    wrapper with its hd-112 tile against the reference's dequant-fused
    Pallas kernel on the same codes (the reference's jitted ops.attention
    quantizes bf16 rows with a scale one ulp off its eager quantize_rows,
    which the port matches, and so moves a few e4m3 codes).  Before hd
    112 had a tile the port's legalization raised here."""
    B, H, Hkv, hd = 1, 8, 1, 112
    q, k, v = _arrays(10, (B, H, S, hd), (B, Hkv, S, hd), (B, Hkv, S, hd))
    for dtype in ("float32", "bfloat16"):
        (qj, qt), (kj, kt), (vj, vt) = (_jt(x, dtype) for x in (q, k, v))
        if dtype == "bfloat16" and kv_dtype != "native":
            kq, ks = rquant.quantize_rows(kj, kv_dtype)
            vq, vs = rquant.quantize_rows(vj, kv_dtype)
            want = ref_flash_quantized(qj, kq, vq, ks[..., 0], vs[..., 0],
                                       causal=True, block_q=S, block_kv=S)
            tile = ops.legalize_attn_tile(128, 128, hd, S, H100_SMEM_OPTIN,
                                          qt.dtype, True)
            assert (tile.kind, tile.hd) == ("wgmma", hd)
            got = kfa.flash_attention_quantized(
                qt, _to_torch(kq), _to_torch(vq), _to_torch(ks[..., 0]),
                _to_torch(vs[..., 0]), True, tile)
        else:
            want = rops.attention(qj, kj, vj, block_q=32, block_kv=32,
                                  kv_dtype=kv_dtype, interpret=True)
            got = ops.attention(qt, kt, vt, block_q=128, block_kv=128,
                                kv_dtype=kv_dtype)
        assert got.shape == (B, H, S, hd) and got.dtype == qt.dtype
        np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("hd", [112, 64])
def test_folded_scales_emulation_at_new_head_dims(kv_dtype, hd):
    """The quantized wgmma kernel's cast points (``_folded_scales_flash``)
    at the head dims its new instantiations serve, hd 112 (its rows
    carried as 128 with zero columns, which add nothing to the products)
    and hd 64, against the reference's dequant-fused Pallas kernel (interpret
    mode) and the port's plain version at 2e-2, GQA 8:1 and 1:1, causal,
    a ragged S."""
    B, S = 1, 200
    H, Hkv = (8, 1) if hd == 112 else (6, 6)
    q, k, v = _arrays(11, (B, H, S, hd), (B, Hkv, S, hd), (B, Hkv, S, hd))
    kq, ks = rquant.quantize_rows(jnp.asarray(k), kv_dtype)
    vq, vs = rquant.quantize_rows(jnp.asarray(v), kv_dtype)
    qj, qt = _jt(q, "bfloat16")
    want = rops.attention(qj, jnp.asarray(k), jnp.asarray(v), block_q=128,
                          block_kv=128, kv_dtype=kv_dtype, interpret=True)
    kt, vt = _to_torch(kq), _to_torch(vq)
    kst, vst = _to_torch(ks[..., 0]), _to_torch(vs[..., 0])
    got = _folded_scales_flash(qt, kt, vt, kst, vst, True)
    tol = dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    np.testing.assert_allclose(
        _np(got), _np(kfa.flash_attention_quantized_plain(qt, kt, vt, kst, vst,
                                                          True)), **tol)


def _reaches_flash(cfg) -> bool:
    """Whether a plan-lowered prefill of ``cfg`` runs flash attention:
    an attention layer without a sliding window (models/attention.py)."""
    return cfg.family != "ssm" and cfg.sliding_window == 0


def test_every_registered_head_dim_on_the_flash_path_legalizes():
    """Each registered arch whose attention reaches the flash path
    legalizes its full-width head dim under full-width grants, with the
    grid of a 2-prompt prefill on 132 SMs: bf16 to the wgmma tile of the
    head dim, native and quantized K/V; fp32 to a simt tile of the head
    dim.  zamba2 (hd 80) is off the flash path by its sliding window,
    and mamba2 has no attention."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.models.base import get_arch
    on = {}
    for arch in ARCH_IDS:
        cfg = get_arch(arch)
        if not _reaches_flash(cfg):
            continue
        on[arch] = cfg.hd
        for pages in (1, 32, 456):
            for kv in ("native", "int8", "fp8_e4m3"):
                plan = pplan.lower_attn(cfg.hd, 2, pages, kv,
                                        1 if kv != "native" else 2)
                quantized = kv != "native"
                for s in (40, 1024):
                    tile = ops.legalize_attn_tile(
                        plan.block_q, plan.block_kv, cfg.hd, s,
                        H100_SMEM_OPTIN, torch.bfloat16, quantized,
                        2 * cfg.num_heads, 132)
                    assert (tile.kind, tile.hd) == ("wgmma", cfg.hd), arch
                    assert tile.kv == (("quantized",) if quantized
                                       else ("native",))
                    simt = ops.legalize_attn_tile(
                        plan.block_q, plan.block_kv, cfg.hd, s,
                        H100_SMEM_OPTIN, torch.float32, quantized)
                    assert (simt.kind, simt.hd) == ("simt", cfg.hd), arch
    assert on == {"mistral-nemo-12b": 128, "yi-9b": 128, "starcoder2-15b": 128,
                  "granite-3-8b": 128, "whisper-tiny": 64,
                  "llava-next-mistral-7b": 128, "kimi-k2-1t-a32b": 112,
                  "olmoe-1b-7b": 128}
    zamba2 = get_arch("zamba2-2.7b")
    assert zamba2.sliding_window > 0 and not _reaches_flash(zamba2)
    assert zamba2.hd not in {t.hd for t in kfa.TILES}
    with pytest.raises(ValueError, match="head dim 80 not compiled"):
        ops.legalize_attn_tile(128, 128, zamba2.hd, 64, H100_SMEM_OPTIN,
                               torch.bfloat16)
