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
    assert {t.hd for t in kfa.TILES} == {32, 64, 128}
    for t in kfa.TILES:
        assert t.smem_bytes <= H100_SMEM_OPTIN
        if t.kind == "wgmma":   # two warpgroups of 64 q rows, hd-wide P.V
            assert t.dtypes == (torch.bfloat16,) and t.hd == 128
            assert (t.bq, t.bkv, t.tm, t.tn) == (128, 128, 64, 128)
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


@pytest.mark.parametrize("pages", [9, 32, 60, 456])
@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_legalized_attn_tile_stays_under_the_plan(pages, kv_dtype, hd, dtype):
    """Plans lowered at full width (bf16) legalize to a compiled tile of
    the head dim, no larger than the plan's blocks, within shared
    memory: for bf16 q at hd 128 the wgmma tile of the K/V storage
    (native or quantized), else the simt tile the simt-only rule picks
    (fp32, hd 32 / 64)."""
    plan = pplan.lower_attn(hd, 2, pages, kv_dtype,
                            1 if kv_dtype != "native" else 2)
    for s in (333, 1024):
        tile = ops.legalize_attn_tile(plan.block_q, plan.block_kv, hd, s,
                                      H100_SMEM_OPTIN, dtype,
                                      kv_dtype != "native")
        assert tile in kfa.TILES and tile.hd == hd and dtype in tile.dtypes
        assert tile.bq <= plan.block_q and tile.bkv <= plan.block_kv
        assert tile.smem_bytes <= H100_SMEM_OPTIN
        if dtype == torch.bfloat16 and hd == 128:
            assert tile == (FLASH_WGMMA if kv_dtype == "native"
                            else FLASH_WGMMA_QUANT)
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
    menu = re.findall(r"using A(\d+) = (AttnTile<([\d, ]+)>|FlashWgmma"
                      r"|FlashWgmmaQuant);", src)
    assert [int(i) for i, *_ in menu] == list(range(len(kfa.TILES)))
    for (_, name, simt), t in zip(menu, kfa.TILES):
        if simt:
            assert (t.kind, t.hd, t.bq, t.bkv, t.tm, t.tn) == \
                ("simt", *map(int, simt.split(",")))
        else:
            assert t == {"FlashWgmma": FLASH_WGMMA,
                         "FlashWgmmaQuant": FLASH_WGMMA_QUANT}[name]


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
def _cu_struct(name):
    """The ``static constexpr int`` members of struct ``name`` in
    csrc/flash_attention.cu, evaluated in order (C++ integer division)."""
    src = (Path(pplan.__file__).parents[1] / "csrc" /
           "flash_attention.cu").read_text()
    body = src.split(f"struct {name} {{", 1)[1].split("};", 1)[0]
    env = {}
    for decl in re.findall(r"static constexpr int ([^;]+);", body):
        for item in re.split(r",\s*(?=\w+ =)", decl):
            key, expr = (x.strip() for x in item.split("=", 1))
            env[key] = eval(re.sub(r"(?<!/)/(?!/)", "//", expr), {}, dict(env))
    return env


@pytest.mark.parametrize("name", ["FlashWgmma", "FlashWgmmaQuant"])
def test_wgmma_flash_tiles_mirror_the_cuda_source(name):
    """Each wgmma menu entry's fields and shared memory are the .cu
    struct's, and fit in 232,448 bytes; the quantized one serves int8 /
    e4m3 K/V only, the native one native K/V only."""
    cu = _cu_struct(name)
    tile = FLASH_WGMMA if name == "FlashWgmma" else FLASH_WGMMA_QUANT
    mask = tile.menu_fields()      # the fields flash_attention_tile writes
    assert mask[0] == cu["kind"] and mask[1] == cu["dtypes"]
    assert (tile.hd, tile.bq, tile.bkv, tile.tm, tile.tn) == \
        (cu["hd"], cu["bq"], cu["bkv"], cu["tm"], cu["tn"])
    assert tile.smem_bytes == cu["smem"] <= H100_SMEM_OPTIN
    assert mask[7] == cu["kv"] and mask[8] == tile.smem_bytes
    assert tile.kv == (("native",) if name == "FlashWgmma" else ("quantized",))


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


@pytest.mark.parametrize("hd", [32, 64, 128])
def test_quantized_fp32_and_other_head_dims_keep_simt(hd):
    """fp32 q (any head dim) and bf16 q at hd 32 / 64 keep the simt
    tiles with quantized K/V; below 128 x 128 blocks hd 128 does too."""
    for dtype in (torch.float32, torch.bfloat16):
        tile = ops.legalize_attn_tile(512, 512, hd, 1024, H100_SMEM_OPTIN,
                                      dtype, True)
        want_wgmma = dtype == torch.bfloat16 and hd == 128
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
