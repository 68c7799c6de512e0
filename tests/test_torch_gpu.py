"""The port's CUDA kernels against their plain versions on the card.

These tests need a CUDA device and the CUDA toolkit; without a card they
skip.  They import neither JAX nor the JAX package, so they run on a GPU
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances are tests/test_kernels.py::tol for the matmul (native and
quantized) and FFN kernels (2e-2 bf16, 2e-3 fp32), tests/test_kernels.py's flash
tolerances for attention (3e-2 bf16, 2e-3 fp32), and the fp32 one for
ssd_chunk at both input types (its arithmetic and outputs are fp32).
Each wrapper counts one launch per call.
"""
import pytest
import torch

from repro_torch.kernels import block_fused_ffn as kffn
from repro_torch.kernels import cache_matmul as kmm
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import quant as pquant
from repro_torch.kernels import ssd_scan as kssd

MATMUL_TOL = {"float32": dict(rtol=2e-3, atol=2e-3),
              "bfloat16": dict(rtol=2e-2, atol=2e-2)}
FLASH_TOL = {"float32": dict(rtol=2e-3, atol=2e-3),
             "bfloat16": dict(rtol=3e-2, atol=3e-2)}


# cache_matmul shapes (M, K, N) per tile kind: ragged rows, N and K not
# multiples of the tiles; wgmma takes K and N multiples of 8 only
MM_SHAPES = {"simt": ((37, 333, 1000),),
             "gemv": ((1, 333, 1000), (2, 4096, 11008), (2, 11008, 4096),
                      (7, 333, 1000), (8, 64, 97)),
             "wgmma": ((9, 64, 256), (37, 520, 1000), (65, 4096, 1000),
                       (300, 520, 1000), (300, 1000, 4104))}


# block_fused_ffn shapes (S, d_model, d_ff) per tile kind: ragged rows
# (the wgmma tile is held at decode rows too, though the legalization
# gives them the simt tile), d_model and d_ff off the tiles (d_ff not a
# multiple of the wgmma tile's 128 x 8-block cluster); wgmma takes
# d_model and d_ff multiples of 8 only
FFN_SHAPES = {"simt": ((37, 333, 1000),),
              "wgmma": ((1, 520, 1000), (2, 520, 1000), (7, 520, 1000),
                        (9, 64, 256), (37, 520, 1000), (65, 520, 1000),
                        (300, 520, 1000), (300, 4096, 2056))}
# cache_matmul_quant shapes (M, K, N) per tile kind; wgmma takes K
# multiples of 8 and N multiples of 16 only
QUANT_SHAPES = {"simt": ((37, 333, 1000), (2, 4096, 300), (130, 64, 97)),
                "gemv": ((1, 333, 1000), (2, 520, 1000), (2, 4096, 11008),
                         (2, 11008, 4096), (7, 333, 1000), (8, 64, 97)),
                "wgmma": ((1, 520, 1008), (2, 520, 1008), (7, 520, 1008),
                          (9, 64, 256), (37, 520, 1008), (65, 4096, 1008),
                          (300, 1000, 4112), (300, 520, 1008))}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain_versions(dtype):
    """Each CUDA kernel against its plain version on the card, ragged
    shapes, every compiled tile of the dtype (cache_matmul's gemv and
    wgmma tiles and block_fused_ffn's wgmma tiles in bf16, at their
    kinds' shapes).  Count one launch per call, on the kind's counter
    too; a gemv or wgmma tile's second launch is bitwise equal to its
    first."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dt)

    for tile in kmm.TILES:
        if dt not in tile.dtypes:
            continue
        for m, k, n in MM_SHAPES[tile.kind]:
            a, b = rand(m, k), rand(k, n, scale=k ** -0.5)
            before, kind = kmm.launches, kmm.launches_by_kind[tile.kind]
            got = kmm.cache_matmul(a, b, tile)
            assert kmm.launches == before + 1
            assert kmm.launches_by_kind[tile.kind] == kind + 1
            torch.testing.assert_close(got.float(),
                                       kmm.cache_matmul_plain(a, b).float(),
                                       **MATMUL_TOL[dtype])
            if tile.kind != "simt":
                assert torch.equal(got, kmm.cache_matmul(a, b, tile))
    for tile in kffn.TILES:
        if dt not in tile.dtypes:
            continue
        for s, d, f in FFN_SHAPES[tile.kind]:
            x = rand(s, d)
            wg, wu = rand(d, f, scale=d ** -0.5), rand(d, f, scale=d ** -0.5)
            wd = rand(f, d, scale=f ** -0.5)
            before, kind = kffn.launches, kffn.launches_by_kind[tile.kind]
            got = kffn.block_fused_ffn(x, wg, wu, wd, tile)
            assert kffn.launches == before + 1
            assert kffn.launches_by_kind[tile.kind] == kind + 1
            torch.testing.assert_close(
                got.float(), kffn.block_fused_ffn_plain(x, wg, wu, wd).float(),
                **MATMUL_TOL[dtype])
            if tile.kind != "simt":
                assert torch.equal(got, kffn.block_fused_ffn(x, wg, wu, wd,
                                                             tile))


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_cache_matmul_quant_matches_plain_version(dtype, kv):
    """The dequant-fused matmul against its plain version on the card,
    int8 and fp8 codes, ragged shapes, every compiled tile of the dtype
    (the gemv and wgmma tiles in bf16, at their kinds' shapes); one
    launch per call, on the kind's counter too; a gemv or wgmma tile's
    second launch is bitwise equal to its first."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for tile in kmm.QUANT_TILES:
        if dt not in tile.dtypes:
            continue
        for m, k, n in QUANT_SHAPES[tile.kind]:
            a = torch.randn((m, k), generator=gen, device="cuda").to(dt)
            w = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
            q, s = pquant.quantize_cols(w, kv)
            want = kmm.cache_matmul_quant_plain(a, q, s).float()
            before = kmm.launches_quant
            kind = kmm.launches_quant_by_kind[tile.kind]
            got = kmm.cache_matmul_quant(a, q, s, tile)
            assert kmm.launches_quant == before + 1
            assert kmm.launches_quant_by_kind[tile.kind] == kind + 1
            assert got.dtype == dt and got.shape == (m, n)
            torch.testing.assert_close(got.float(), want, **MATMUL_TOL[dtype])
            if tile.kind != "simt":
                assert torch.equal(got, kmm.cache_matmul_quant(a, q, s, tile))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_attention_matches_plain_versions(dtype):
    """The CUDA kernels against their plain versions on the card, ragged
    shapes, every compiled tile of the dtype, native and quantized K/V
    (the wgmma tile: bf16, native K/V, hd 128, bitwise on a repeat); the
    fp32 quantized path bitwise equal to the native one on dequantized
    K/V.  One launch per call on each counter."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for tile in kfa.TILES:
        if dt not in tile.dtypes:
            continue
        B, H, Hkv, S, hd = 2, 8, 2, 333, tile.hd
        q = torch.randn((B, H, S, hd), generator=gen, device="cuda").to(dt)
        k = torch.randn((B, Hkv, S, hd), generator=gen, device="cuda").to(dt)
        v = torch.randn((B, Hkv, S, hd), generator=gen, device="cuda").to(dt)
        for causal in (True, False):
            before = kfa.launches
            kind = kfa.launches_by_kind[tile.kind]
            got = kfa.flash_attention(q, k, v, causal, tile)
            assert kfa.launches == before + 1
            assert kfa.launches_by_kind[tile.kind] == kind + 1
            torch.testing.assert_close(
                got.float(), kfa.flash_attention_plain(q, k, v, causal).float(),
                **FLASH_TOL[dtype])
            if tile.kind == "wgmma":   # native bf16 only; bitwise repeat
                assert torch.equal(got, kfa.flash_attention(q, k, v, causal,
                                                            tile))
                continue
            for kv_dtype in ("int8", "fp8_e4m3"):
                kq, ks = pquant.quantize_rows(k, kv_dtype)
                vq, vs = pquant.quantize_rows(v, kv_dtype)
                before = kfa.launches_quantized
                got = kfa.flash_attention_quantized(q, kq, vq, ks[..., 0],
                                                    vs[..., 0], causal, tile)
                assert kfa.launches_quantized == before + 1
                torch.testing.assert_close(
                    got.float(), kfa.flash_attention_quantized_plain(
                        q, kq, vq, ks[..., 0], vs[..., 0], causal).float(),
                    **FLASH_TOL[dtype])
                if dtype == "float32":
                    native = kfa.flash_attention(
                        q, pquant.dequantize_rows(kq, ks),
                        pquant.dequantize_rows(vq, vs), causal, tile)
                    assert torch.equal(got, native)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_ssd_chunk_matches_plain_version(dtype):
    """The SSD intra-chunk kernel against its plain version on the card:
    B and C per batch row (32 heads of a row share them) at full width
    (P 64, N 128) for chunks of 256, 128, 64, a tail of 44 and 1, each
    with several chunks, and the reduced shape (P 32, N 16).  One launch
    per call; a second launch is bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(2)
    shapes = [(2, 32, 64, 128, q, 3 * q) for q in (256, 128, 64, 44, 1)]
    shapes.append((2, 8, 32, 16, 32, 96))
    for b, h, p, n, q, s in shapes:
        x = torch.randn((b * h, s, p), generator=gen, device="cuda").to(dt)
        dts = torch.nn.functional.softplus(
            torch.randn((b * h, s), generator=gen, device="cuda"))
        A = torch.randn((b * h,), generator=gen, device="cuda").abs() + 0.1
        Bm = torch.randn((b, s, n), generator=gen, device="cuda").to(dt)
        Cm = torch.randn((b, s, n), generator=gen, device="cuda").to(dt)
        before = kssd.launches
        y, st = kssd.ssd_chunk(x, dts, A, Bm, Cm, q)
        assert kssd.launches == before + 1
        assert y.dtype == st.dtype == torch.float32
        want_y, want_st = kssd.ssd_chunk_plain(
            x, dts, A, Bm.repeat_interleave(h, 0), Cm.repeat_interleave(h, 0),
            q)
        torch.testing.assert_close(y, want_y, **MATMUL_TOL["float32"])
        torch.testing.assert_close(st, want_st, **MATMUL_TOL["float32"])
        y2, st2 = kssd.ssd_chunk(x, dts, A, Bm, Cm, q)
        assert torch.equal(y, y2) and torch.equal(st, st2)
