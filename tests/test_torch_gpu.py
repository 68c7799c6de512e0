"""The port's CUDA kernels against their plain versions on the card.

These tests need a CUDA device and the CUDA toolkit; without a card they
skip.  They import neither JAX nor the JAX package, so they run on a GPU
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances are tests/test_kernels.py::tol for the matmul (native and
quantized) and FFN kernels (2e-2 bf16, 2e-3 fp32), tests/test_kernels.py's flash
tolerances for attention (3e-2 bf16, 2e-3 fp32; the quantized wgmma
kernel is held at 2e-2, the bar chip_smoke.py holds it to), and the fp32
one for ssd_chunk at both input types and both kinds (its arithmetic and
outputs are fp32), and for its backward relative to each gradient's
largest magnitude.  Two bf16 train steps (reduced mamba2 and olmoe) run
the training path on the card.
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
# the server tracer's clock error: the host's wake-up after a waited-for
# event plus the host and device clocks' drift over a run
CLOCK_ERROR_NS = 1_000_000


# cache_matmul shapes (M, K, N) per tile kind: ragged rows, N and K not
# multiples of the tiles; wgmma takes K and N multiples of 8 only
MM_SHAPES = {"simt": ((37, 333, 1000),),
             "gemv": ((1, 333, 1000), (2, 4096, 11008), (2, 11008, 4096),
                      (7, 333, 1000), (8, 64, 97)),
             "wgmma": ((9, 64, 256), (37, 520, 1000), (65, 4096, 1000),
                       (300, 520, 1000), (300, 1000, 4104))}


# block_fused_ffn shapes (S, d_model, d_ff) per tile kind: ragged rows
# (the wgmma tile is held at decode rows too, though the legalization
# gives them the gemv tile), d_model and d_ff off the tiles (d_ff not a
# multiple of the wgmma tile's 128 x 8-block cluster, nor of the gemv
# tile's 64); wgmma and gemv take d_model and d_ff multiples of 8 only,
# gemv at most 8 rows (clusters of 8, 4, 2 and 1 blocks among them on
# an H100: kernels/block_fused_ffn.py::gemv_cluster)
FFN_SHAPES = {"simt": ((37, 333, 1000),),
              "gemv": ((1, 520, 1000), (2, 384, 1536), (3, 520, 1000),
                       (7, 2560, 10240), (4, 128, 20000), (8, 64, 256),
                       (8, 64, 33792), (5, 4104, 5512)),
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
    wgmma tiles and block_fused_ffn's gemv and wgmma tiles in bf16, at
    their kinds' shapes).  Count one launch per call, on the kind's counter
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
    shapes, every compiled tile of the dtype with the K/V storage it
    takes, native and quantized (the wgmma tiles: bf16, hd 128 and 64,
    bitwise on a repeat); the fp32 quantized path bitwise equal to the native one
    on dequantized K/V.  One launch per call on each counter."""
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
            if "native" in tile.kv:
                before = kfa.launches
                kind = kfa.launches_by_kind[tile.kind]
                got = kfa.flash_attention(q, k, v, causal, tile)
                assert kfa.launches == before + 1
                assert kfa.launches_by_kind[tile.kind] == kind + 1
                torch.testing.assert_close(
                    got.float(),
                    kfa.flash_attention_plain(q, k, v, causal).float(),
                    **FLASH_TOL[dtype])
                if tile.kind == "wgmma":   # bitwise repeat
                    assert torch.equal(got, kfa.flash_attention(q, k, v,
                                                                causal, tile))
            if "quantized" not in tile.kv:
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
                if tile.kind == "wgmma":   # bitwise repeat
                    assert torch.equal(got, kfa.flash_attention_quantized(
                        q, kq, vq, ks[..., 0], vs[..., 0], causal, tile))
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


# the quantized wgmma flash kernel's shapes (B, H, Hkv, S, Sk, causal):
# the prefill path's, ragged S and Sk, S != Sk, a short prompt
FLASH_QUANT_SHAPES = ((2, 32, 4, 1024, 1024, True), (1, 8, 2, 333, 333, True),
                      (1, 8, 2, 333, 333, False), (1, 8, 2, 200, 520, False),
                      (1, 8, 2, 40, 40, True))


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["int8", "fp8_e4m3"])
def test_cuda_quantized_wgmma_flash_matches_plain_version(kv):
    """The quantized wgmma flash kernel (bf16 q, int8 / e4m3 codes at hd
    128) against the plain version at the bf16 tolerance, at the path's
    and ragged shapes, bitwise on a repeat, one launch per call on the
    wgmma counter; the fp32 quantized path stays on simt, bitwise equal
    to the native kernel on the dequantized K/V."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(3)
    limit = ops.smem_limit(torch.device("cuda"))
    for b, h, hkv, s, sk, causal in FLASH_QUANT_SHAPES:
        q = torch.randn((b, h, s, 128), generator=gen, device="cuda")
        k = torch.randn((b, hkv, sk, 128), generator=gen, device="cuda")
        v = torch.randn((b, hkv, sk, 128), generator=gen, device="cuda")
        kq, ks = pquant.quantize_rows(k, kv)
        vq, vs = pquant.quantize_rows(v, kv)
        ks, vs = ks[..., 0], vs[..., 0]
        tile = ops.legalize_attn_tile(128, 128, 128, s, limit, torch.bfloat16,
                                      True)
        assert tile.kind == "wgmma" and tile.kv == ("quantized",)
        qb = q.bfloat16()
        before = kfa.launches_quantized_by_kind["wgmma"]
        got = kfa.flash_attention_quantized(qb, kq, vq, ks, vs, causal, tile)
        assert kfa.launches_quantized_by_kind["wgmma"] == before + 1
        assert got.dtype == torch.bfloat16 and got.shape == qb.shape
        torch.testing.assert_close(
            got.float(), kfa.flash_attention_quantized_plain(
                qb, kq, vq, ks, vs, causal).float(),
            **MATMUL_TOL["bfloat16"])
        assert torch.equal(got, kfa.flash_attention_quantized(
            qb, kq, vq, ks, vs, causal, tile))
        simt = ops.legalize_attn_tile(128, 128, 128, s, limit, torch.float32,
                                      True)
        assert simt.kind == "simt"
        before = kfa.launches_quantized_by_kind["simt"]
        got32 = kfa.flash_attention_quantized(q, kq, vq, ks, vs, causal, simt)
        assert kfa.launches_quantized_by_kind["simt"] == before + 1
        native = kfa.flash_attention(q, pquant.dequantize_rows(kq, ks[..., None]),
                                     pquant.dequantize_rows(vq, vs[..., None]),
                                     causal, simt)
        assert torch.equal(got32, native)


@pytest.mark.gpu
def test_cuda_ssd_chunk_wgmma_matches_plain_version():
    """ssd_chunk's wgmma kind (bf16) against the plain version at the
    fp32 tolerance (2e-3): full width (P 64, N 128, B/C per batch row)
    for chunks of 256, 128, 64, a tail of 44 and 1, each with several
    chunks, and the reduced shape (P 32, N 16); one launch per call on
    the wgmma counter; a second launch bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(4)
    shapes = [(2, 32, 64, 128, q, 3 * q) for q in (256, 128, 64, 44, 1)]
    shapes.append((2, 8, 32, 16, 32, 96))
    for b, h, p, n, q, s in shapes:
        assert ops.ssd_kind(torch.bfloat16, n, p) == "wgmma"
        x = torch.randn((b * h, s, p), generator=gen, device="cuda").bfloat16()
        dts = torch.nn.functional.softplus(
            torch.randn((b * h, s), generator=gen, device="cuda"))
        A = torch.randn((b * h,), generator=gen, device="cuda").abs() + 0.1
        Bm = torch.randn((b, s, n), generator=gen, device="cuda").bfloat16()
        Cm = torch.randn((b, s, n), generator=gen, device="cuda").bfloat16()
        before = kssd.launches_by_kind["wgmma"]
        y, st = kssd.ssd_chunk(x, dts, A, Bm, Cm, q, kind="wgmma")
        assert kssd.launches_by_kind["wgmma"] == before + 1
        assert y.dtype == st.dtype == torch.float32
        want_y, want_st = kssd.ssd_chunk_plain(
            x, dts, A, Bm.repeat_interleave(h, 0), Cm.repeat_interleave(h, 0),
            q)
        torch.testing.assert_close(y, want_y, **MATMUL_TOL["float32"])
        torch.testing.assert_close(st, want_st, **MATMUL_TOL["float32"])
        y2, st2 = kssd.ssd_chunk(x, dts, A, Bm, Cm, q, kind="wgmma")
        assert torch.equal(y, y2) and torch.equal(st, st2)


# ------------------------------------------------------- CUDA graphs --
def _bf16(arch, name):
    """A registered bf16 copy of the reduced config (the wgmma / gemv
    kinds take bf16 only)."""
    import dataclasses
    from repro_torch.models.base import get_arch, register
    return register(dataclasses.replace(get_arch(arch).reduced(), name=name,
                                        dtype="bfloat16"))


@pytest.mark.gpu
def test_graph_replay_matches_eager_dispatch():
    """chip_smoke.py's graphs phase at the reduced widths in bf16: a
    server's captured programs (a prompt tenant's chunks and epochs with
    a native and an int8 cache, a resident alone, two as a bucket, a
    mamba2 prompt chunk, tail and epochs) against the epoch / prefill
    cores run eagerly on cloned caches, tokens and positions, bitwise in
    tokens and every cache buffer; replays count the eager run's launches
    (cache_matmul and ssd_chunk among them; the tile kinds are held at
    full width, in chip_smoke.py); a second replay of an item captures
    nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke
    out = chip_smoke.check_graphs(_bf16("yi-9b", "yi-9b-graphs"),
                                  _bf16("mamba2-370m", "mamba2-graphs"),
                                  "cuda", kinds=False)
    assert out["bit_identical"] and len(out["checks"]) == 16


@pytest.mark.gpu
def test_graph_replay_adds_its_capture_launches():
    """A warm server's program, replayed, adds exactly the launch counts
    its capture recorded (the wrappers run no Python at replay), and a
    second run() of the server captures nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import counters as kcount
    from repro_torch.launch.serve import MultiTenantServer
    cfg = _bf16("yi-9b", "yi-9b-graphs")
    srv = MultiTenantServer([cfg.name], batch=2, max_len=64, epoch_len=4,
                            device="cuda", reduced=False)
    srv.run(8)
    captures = srv._captures
    assert captures > 0
    out = srv.run(8)
    assert srv._captures == captures
    assert out["host"]["epoch_compiles"] == [0] * out["host"]["epochs"]
    entry = srv._fused_jits.peek(srv._fused_jits.keys()[-1])
    assert entry.graph is not None and entry.launches   # the FFN kernels
    before = kcount.snapshot()
    entry()
    torch.cuda.synchronize()
    assert kcount.delta(before) == entry.launches


@pytest.mark.gpu
def test_kv_window_crossing_leaves_one_crossing_record():
    """Two residents decoding as one bucket cross a 128-token kv window
    with the server's tracer on: the one capture leaves one crossing
    record, its marks in order on the host clock, no warm-up (the first
    window warmed its warm-up key) and the host's recording inside its
    gap no longer than the gap, and each mark after the host work that
    precedes it on the device (within the tracer's clock error,
    ``CLOCK_ERROR_NS``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.launch import spans
    from repro_torch.launch.serve import MultiTenantServer
    cfg = _bf16("yi-9b", "yi-9b-graphs")
    srv = MultiTenantServer([cfg.name, cfg.name], batch=2, max_len=256,
                            epoch_len=4, device="cuda", reduced=False)
    srv.run(120)                       # positions 0-119: kv window 128
    captures, warmups = srv._captures, srv._warmups
    srv.tracer.start()
    srv.run(16)                        # 120-135: one crossing, at 128
    assert srv._captures == captures + 1 and srv._warmups == warmups
    (rec,) = srv.tracer.crossings()
    assert rec["kind"] == "bucket" and len(rec["tids"]) == 2
    assert rec["d0_ns"] <= rec["d1_ns"]
    assert rec["warmup_s"] == rec["warmup_in_s"] == 0
    assert rec["record_s"] > 0
    assert rec["record_in_s"] <= rec["gap_s"]
    assert rec["compile_ns"] <= rec["d0_ns"] + CLOCK_ERROR_NS
    (recording,) = [s for s in srv.tracer.spans() if s["name"] == spans.RECORD]
    assert recording["tids"] == rec["tids"]
    assert recording["end_ns"] <= rec["d1_ns"] + CLOCK_ERROR_NS
    names = {s["name"] for s in srv.tracer.spans()}
    assert {spans.RECORD, spans.FIRST_REPLAY, "serve.replay"} <= names
    assert spans.WARMUP not in names


@pytest.mark.gpu
def test_later_kv_windows_record_without_a_warmup():
    """A graph-capturing server serves two residents as one bucket
    through four kv windows (positions 0-499), and an arrival whose
    prompt runs in chunks of 256, 256 and 188 tokens (kv windows 256, 512
    and 768): one eager warm-up per warm-up key, every later window's
    capture recorded without one, and the tokens of the serial eager
    loop (``pipeline=False``), bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np
    from repro_torch.launch.serve import MultiTenantServer
    from repro_torch.sim.driver import TenantSpec
    cfg = _bf16("yi-9b", "yi-9b-graphs")
    kw = dict(batch=2, max_len=1024, epoch_len=4, device="cuda",
              reduced=False, tenants=[TenantSpec(cfg.name, arrive_at=200.0,
                                                 prompt_len=700,
                                                 n_inferences=60)])
    srv = MultiTenantServer([cfg.name, cfg.name], **kw)
    got = srv.run(500)
    assert srv.tenants[2].chunks == [256, 256, 188]
    kvs = {key[4] for key in srv._fused_jits.keys() if key[0] == "bucket"}
    assert kvs == {128, 256, 384, 512}
    assert srv._warmups == len(srv._warm_sigs) < srv._captures
    assert srv._captures - srv._warmups >= len(kvs) - 1
    serial = MultiTenantServer([cfg.name, cfg.name], pipeline=False, **kw)
    want = serial.run(500)
    assert got["tenants"].keys() == want["tenants"].keys()
    for tid, o in want["tenants"].items():
        assert np.array_equal(got["tenants"][tid]["output"], o["output"]), tid


# ---------------------------------------------------------------- MoE --
@pytest.mark.gpu
def test_moe_graph_replay_matches_eager_dispatch():
    """chip_smoke.py's olmoe graph checks at the reduced width in bf16:
    a prompt tenant's chunks and epochs, a resident alone and two as a
    bucket, each program's replay bitwise equal to the eager epoch /
    prefill core on cloned caches, tokens and positions, with the eager
    run's launch counts (none: the server's MoE path runs no kernel); a
    second replay captures nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke
    checks, rec = chip_smoke.graph_checks(_bf16("olmoe-1b-7b", "olmoe-graphs"),
                                          "cuda")
    assert not chip_smoke._graph_faults(checks)
    assert {c["kind"] for c in checks} == {"prefill", "single", "bucket"}
    assert rec["captures"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["LBM", "LWM"])
def test_moe_expert_launches_take_the_wgmma_kind(kind):
    """A reduced bf16 olmoe ``make_prefill`` under a plan runs one
    ``planned_ffn`` per expert and layer: 88 bucket rows an expert
    (2 x 64 tokens), so the fused FFN (LBM) and the gate / up GEMMs
    (LWM) launch their wgmma kinds, and the down GEMM the kind its
    shape legalizes to (N = d_model 128 is below the wgmma tile's 256);
    the logits within 2e-2 of the largest plain-path logit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke
    from repro_torch.core.vmem import LANE
    from repro_torch.kernels import counters as kcount
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models.moe import capacity
    cfg = _bf16("olmoe-1b-7b", "olmoe-graphs")
    plan = chip_smoke.moe_prefill_plans(cfg, LANE)[f"{kind}/native"]
    params = M.init_params(cfg, seed=0, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (2, 64), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(0))
    rows = 2 * capacity(64, cfg)
    assert rows == 88
    n = cfg.num_layers * cfg.num_experts
    before = kcount.snapshot()
    got = M.make_prefill(cfg)(params, {"tokens": toks}, plan)
    torch.cuda.synchronize()
    launches = kcount.delta(before)
    want = M.make_prefill(cfg)(params, {"tokens": toks})
    if kind == "LBM":
        assert launches.get("block_fused_ffn.wgmma") == n
        assert not launches.get("cache_matmul")
    else:
        limit = ops.smem_limit(torch.device("cuda"))
        d, f = cfg.d_model, cfg.d_ff
        up = ops.legalize_matmul_tile(plan.ffn.up_tile, rows, limit,
                                      torch.bfloat16, d, f)
        down = ops.legalize_matmul_tile(plan.ffn.down_tile, rows, limit,
                                        torch.bfloat16, f, d)
        assert up.kind == "wgmma"
        want_kinds = {}
        for k, count in ((up.kind, 2 * n), (down.kind, n)):
            want_kinds[k] = want_kinds.get(k, 0) + count
        assert {k: launches.get(f"cache_matmul.{k}", 0)
                for k in want_kinds} == want_kinds
    tol = 2e-2 * float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= tol


# ----------------------------------------------------- serve features --
@pytest.mark.gpu
def test_checkpoint_roundtrip_on_the_card(tmp_path):
    """Card tensors of every cache dtype through the checkpoint: each
    leaf comes back on the card with its dtype, shape and bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.checkpoint import checkpoint as ckpt
    g = torch.Generator(device="cuda").manual_seed(0)
    r = torch.randn((2, 8, 4, 16), generator=g, device="cuda")
    tree = {"caches": [{"k": r.to(torch.bfloat16), "v": r * 3},
                       {"k": r.to(torch.float8_e4m3fn),
                        "k_scale": r[..., :1].abs(),
                        "q": (r * 40).to(torch.int8)}],
            "token": torch.arange(2, device="cuda").reshape(2, 1)}
    ckpt.save(str(tmp_path), 3, tree)
    back, _ = ckpt.restore(str(tmp_path), device="cuda")
    want, _ = ckpt._flatten(tree)
    got, _ = ckpt._flatten(back)
    for a, b in zip(want, got):
        assert b.is_cuda and a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def _serve_features_server(cfg, **kw):
    from repro_torch.launch.serve import MultiTenantServer
    return MultiTenantServer([], batch=1, max_len=128, epoch_len=4,
                             total_pages=64, device="cuda", reduced=False,
                             **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("arch, kv", [("yi-9b", "native"), ("yi-9b", "int8"),
                                      ("mamba2-370m", "native")])
def test_preempt_resume_replays_bitwise_on_the_card(arch, kv, tmp_path):
    """chip_smoke.py's serve_faults (a) at the reduced width in bf16: a
    pipelined server (captured graphs) preempted at step 8 and resumed
    two epochs later decodes bit for bit as an unfaulted one; the
    preemption evicts the tenant's programs, and the resume captures
    them again."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.sim.driver import TenantSpec
    from repro_torch.sim.faults import FaultEvent, FaultPlan
    cfg = _bf16(arch, f"{arch}-faults")
    outs = []
    for plan in (None, FaultPlan([FaultEvent(step=8, kind="preempt",
                                             hold_epochs=2)])):
        srv = _serve_features_server(cfg, kv_dtype=kv, faults=plan,
                                     ckpt_dir=str(tmp_path))
        srv.enqueue([TenantSpec(cfg.name, prompt_len=32, n_inferences=24)])
        outs.append(srv.run(24))
    ref, out = outs
    (tid, info), = out["tenants"].items()
    assert info["preemptions"] == 1
    assert torch.equal(torch.from_numpy(info["output"]),
                       torch.from_numpy(ref["tenants"][tid]["output"]))
    assert out["host"]["preempt_evictions"] > 0
    assert out["host"]["captures"] > ref["host"]["captures"]
    assert out["faults"]["checkpoint_bytes"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["yi-9b", "mamba2-370m"])
def test_full_prompt_rearrival_bitwise_on_the_card(arch):
    """A full-prompt re-arrival on the card, captured graphs: the seeded
    tenant skips prefill and decodes the producer's stream bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.sim.driver import TenantSpec
    cfg = _bf16(arch, f"{arch}-prefix")
    specs = [TenantSpec(cfg.name, arrive_at=at, n_inferences=6,
                        prompt_len=64, param_seed=5, prompt_seed=7,
                        prefix_len=64, prefix_seed=3) for at in (0.0, 4.0)]
    srv = _serve_features_server(cfg, tenants=specs, prefix_dedup=True,
                                 steps_per_s=4.0)
    out = srv.run(24)
    prod, warm = (out["tenants"][f"t{i}:{cfg.name}"] for i in (0, 1))
    assert warm["prefix_hit"] == 64 and warm["prefill_chunks"] == []
    assert warm["prefill_computed"] == 0
    assert (prod["output"] == warm["output"]).all()
    assert out["host"]["snapshot_bytes"] > 0


# ------------------------------------------------------------- hybrid --
@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions_at_hybrid_shapes():
    """The kernels at full-width zamba2-2.7b's shapes, bf16, the tiles
    the plans legalize to: cache_matmul's gemv at the shared FFN's decode
    GEMMs (2 x 2560 @ 2560 x 10240, 2 x 10240 @ 10240 x 2560) and its
    wgmma tile at 2048 rows, block_fused_ffn's wgmma tile at 2048 x 2560,
    d_ff 10240, and ssd_chunk's wgmma kind at 80 heads, P 64, N 64, chunk
    256 (B/C per batch row); each against its plain version at the
    tolerances above, one launch on its kind's counter."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.core.plan import lower_ffn
    from repro_torch.kernels import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    limit = ops.smem_limit(torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(21)
    d, f, bf16 = 2560, 10240, torch.bfloat16

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(bf16)

    lwm = lower_ffn(128, d, f, 2, 32, want_fused=False)
    for m, kind in ((2, "gemv"), (2048, "wgmma")):
        for tile, k, n in ((lwm.up_tile, d, f), (lwm.down_tile, f, d)):
            hop = ops.legalize_matmul_tile(tile, m, limit, bf16, k, n)
            assert hop.kind == kind
            a, b = rand(m, k), rand(k, n, scale=k ** -0.5)
            before = kmm.launches_by_kind[kind]
            got = kmm.cache_matmul(a, b, hop)
            assert kmm.launches_by_kind[kind] == before + 1
            torch.testing.assert_close(got, kmm.cache_matmul_plain(a, b),
                                       **MATMUL_TOL["bfloat16"])
    lbm = lower_ffn(1024, d, f, 2, 1184, want_fused=True)
    tile = ops.legalize_ffn_tile(lbm.block_s, lbm.block_f, 2048, limit, bf16,
                                 d, f)
    assert tile.kind == "wgmma"
    x = rand(2048, d)
    wg, wu = rand(d, f, scale=d ** -0.5), rand(d, f, scale=d ** -0.5)
    wd = rand(f, d, scale=f ** -0.5)
    torch.testing.assert_close(kffn.block_fused_ffn(x, wg, wu, wd, tile),
                               kffn.block_fused_ffn_plain(x, wg, wu, wd),
                               **MATMUL_TOL["bfloat16"])
    b, h, p, n, q, s = 2, 80, 64, 64, 256, 512
    assert ops.ssd_kind(bf16, n, p) == "wgmma"
    xs = rand(b * h, s, p)
    dts = torch.nn.functional.softplus(
        torch.randn((b * h, s), generator=gen, device="cuda"))
    A = torch.randn((b * h,), generator=gen, device="cuda").abs() + 0.1
    Bm, Cm = rand(b, s, n), rand(b, s, n)
    y, st = kssd.ssd_chunk(xs, dts, A, Bm, Cm, q, kind="wgmma")
    want_y, want_st = kssd.ssd_chunk_plain(
        xs, dts, A, Bm.repeat_interleave(h, 0), Cm.repeat_interleave(h, 0), q)
    torch.testing.assert_close(y, want_y, **MATMUL_TOL["float32"])
    torch.testing.assert_close(st, want_st, **MATMUL_TOL["float32"])


@pytest.mark.gpu
def test_hybrid_one_group_e2e_on_the_card():
    """chip_smoke.py's e2e_hybrid: full-width zamba2-2.7b cut to one
    group, the card with the kernels against the CPU with the plain
    versions (prefill under LBM / LWM-int8 plans, teacher-forced decode
    with native, int8 and fp8 caches), at chip_smoke's gates."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke
    from repro_torch.models.base import get_arch
    out = chip_smoke.check_e2e_hybrid(get_arch("zamba2-2.7b"), "cuda")
    assert out["layers"] == 6
    assert out["launches"]["ssd_chunk.wgmma"] > 0


@pytest.mark.gpu
def test_hybrid_graph_replay_matches_eager_dispatch():
    """chip_smoke.py's zamba2 graph checks at the reduced width in bf16,
    one group: a prompt tenant's chunks and epochs, a resident alone and
    two as a bucket, each replay bitwise equal to the eager core on
    cloned caches (K/V and Mamba2 states), with its launch counts; a
    second replay captures nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke
    checks, rec = chip_smoke.graph_checks(_bf16("zamba2-2.7b", "zamba2-graphs"),
                                          "cuda", prompt_len=300)
    assert not chip_smoke._graph_faults(checks)
    assert {c["kind"] for c in checks} == {"prefill", "single", "bucket"}
    assert rec["captures"] > 0


@pytest.mark.gpu
def test_capture_failure_raises():
    """A capture that fails (here: a read back to the host inside it)
    raises; nothing falls back to eager dispatch.  Kept last: the failed
    capture leaves its stream's pool routing behind."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.launch.serve import MultiTenantServer
    srv = MultiTenantServer([_bf16("yi-9b", "yi-9b-graphs").name], batch=2,
                            max_len=64, device="cuda", reduced=False)
    t = srv.tenants[0]
    with pytest.raises(RuntimeError):
        srv._compile(lambda: float(t.index_dev.float().sum()), ("probe",),
                     [t], 1)
    assert srv._captures == 0


# ------------------------------------ encoder-decoder and VLM shapes --
def _bf16_rand(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda")
            * scale).to(torch.bfloat16)


@pytest.mark.gpu
def test_cuda_flash_hd64_encdec_shape_runs_simt():
    """whisper-tiny's decoder prefill under a plan: causal flash attention
    at hd 64 (B 2, 6 heads, 448 positions), bf16, which legalizes to the
    64-row wgmma tile of hd 64 (48 blocks of 128 rows would leave most
    SMs idle; the simt tile before hd 64 had a wgmma tile; fp32 keeps
    simt), against the plain version, bitwise on a repeat."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(7)
    q = _bf16_rand(gen, 2, 6, 448, 64)
    k, v = _bf16_rand(gen, 2, 6, 448, 64), _bf16_rand(gen, 2, 6, 448, 64)
    limit = ops.smem_limit(q.device)
    tile = ops.legalize_attn_tile(128, 128, 64, 448, limit, q.dtype, False,
                                  12, ops.sm_count(q.device))
    assert (tile.kind, tile.hd, tile.bq) == ("wgmma", 64, 64)
    assert ops.legalize_attn_tile(128, 128, 64, 448, limit,
                                  torch.float32).kind == "simt"
    before = kfa.launches_by_kind["wgmma"]
    got = ops.attention(q, k, v, causal=True, block_q=128, block_kv=128)
    assert kfa.launches_by_kind["wgmma"] == before + 1
    torch.testing.assert_close(got.float(),
                               kfa.flash_attention_plain(q, k, v,
                                                         True).float(),
                               **FLASH_TOL["bfloat16"])
    assert torch.equal(got, ops.attention(q, k, v, causal=True, block_q=128,
                                          block_kv=128))


# hd-64 wgmma flash shapes (B, H, Hkv, S, Sk, causal): ragged S and Sk
# against both q tiles, S != Sk, GQA, a prompt shorter than one KV tile
FLASH_HD64_SHAPES = ((1, 8, 2, 333, 333, True), (1, 8, 2, 333, 333, False),
                     (1, 8, 2, 200, 520, False), (2, 6, 6, 40, 40, True),
                     (1, 4, 4, 1, 1, True), (2, 6, 6, 1500, 1500, False))


@pytest.mark.gpu
def test_cuda_flash_hd64_wgmma_ragged_shapes():
    """Both hd-64 wgmma tiles (128 and 64 q rows) at ragged shapes
    against the plain version at the bf16 flash tolerance, bitwise on a
    repeat; without the grid the legalization gives prompts of up to 64
    rows the 64-row tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(11)
    tiles = [t for t in kfa.TILES if t.kind == "wgmma" and t.hd == 64
             and t.kv == ("native",)]
    assert sorted(t.bq for t in tiles) == [64, 128]
    limit = ops.smem_limit(torch.device("cuda"))
    for b, h, hkv, s, sk, causal in FLASH_HD64_SHAPES:
        q = _bf16_rand(gen, b, h, s, 64)
        k, v = _bf16_rand(gen, b, hkv, sk, 64), _bf16_rand(gen, b, hkv, sk, 64)
        want = kfa.flash_attention_plain(q, k, v, causal).float()
        assert ops.legalize_attn_tile(128, 128, 64, s, limit, q.dtype).bq \
            == (64 if s <= 64 else 128)
        for tile in tiles:
            before = kfa.launches_by_kind["wgmma"]
            got = kfa.flash_attention(q, k, v, causal, tile)
            assert kfa.launches_by_kind["wgmma"] == before + 1
            torch.testing.assert_close(got.float(), want,
                                       **FLASH_TOL["bfloat16"])
            assert torch.equal(got, kfa.flash_attention(q, k, v, causal,
                                                        tile))


# wgmma flash shapes (B, H, Hkv, S, Sk, causal) at hd 112 (kimi-k2's
# prefill: 64 / 8 heads) and, quantized, at hd 64 (whisper-tiny's
# decoder prefill: 6 / 6 heads): each path's shape, ragged S and Sk
# causal and not, S != Sk, prompts shorter than one KV tile
FLASH_NEW_SHAPES = {112: ((2, 64, 8, 1024, 1024, True), (1, 8, 1, 333, 333, True),
                          (1, 8, 1, 333, 333, False), (1, 8, 1, 200, 520, False),
                          (1, 8, 1, 40, 40, True)),
                    64: ((2, 6, 6, 448, 448, True), (1, 8, 2, 333, 333, True),
                         (1, 8, 2, 333, 333, False), (1, 8, 2, 200, 520, False),
                         (1, 4, 4, 1, 1, True))}


def _with_poisoned_tail(t):
    """``t`` copied to the front of a buffer whose bytes past it are
    0xFF (NaN in bf16 and e4m3), contiguous: a kernel that reads past
    its operand's rows reads NaN patterns."""
    n = t.numel() * t.element_size()
    raw = torch.full((n + 4096,), 255, dtype=torch.uint8, device=t.device)
    out = raw[:n].view(t.dtype).view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("hd, kv", [(112, "native"), (112, "int8"),
                                    (112, "fp8_e4m3"), (64, "int8"),
                                    (64, "fp8_e4m3")])
def test_cuda_flash_hd112_and_quantized_hd64_run_wgmma(hd, kv):
    """bf16 flash attention at hd 112 (native and int8 / e4m3 K/V) and
    quantized at hd 64 legalizes to the wgmma tile of its head dim and
    K/V storage at every shape, and matches the plain version (native
    at the bf16 flash tolerance, quantized at 2e-2), bitwise on a
    repeat, one wgmma launch a call, no NaN: K/V lie at the front of
    buffers whose bytes past them are 0xFF, so a read past their rows
    shows.  fp32 at hd 112 runs a simt tile against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(13)
    dev = torch.device("cuda")
    limit, sms = ops.smem_limit(dev), ops.sm_count(dev)
    quantized = kv != "native"
    counter = (kfa.launches_quantized_by_kind if quantized
               else kfa.launches_by_kind)
    for b, h, hkv, s, sk, causal in FLASH_NEW_SHAPES[hd]:
        q = _bf16_rand(gen, b, h, s, hd)
        k, v = _bf16_rand(gen, b, hkv, sk, hd), _bf16_rand(gen, b, hkv, sk, hd)
        tile = ops.legalize_attn_tile(128, 128, hd, s, limit, q.dtype,
                                      quantized, b * h, sms)
        assert (tile.kind, tile.hd, tile.kv) == (
            "wgmma", hd, ("quantized",) if quantized else ("native",))
        if quantized:
            kq, ks = pquant.quantize_rows(k, kv)
            vq, vs = pquant.quantize_rows(v, kv)
            args = (_with_poisoned_tail(kq), _with_poisoned_tail(vq),
                    ks[..., 0], vs[..., 0])

            def run(tl, q=q, args=args, causal=causal):
                return kfa.flash_attention_quantized(q, *args, causal, tl)
            want = kfa.flash_attention_quantized_plain(q, kq, vq, ks[..., 0],
                                                       vs[..., 0], causal)
            tol = MATMUL_TOL["bfloat16"]
        else:
            args = (_with_poisoned_tail(k), _with_poisoned_tail(v))

            def run(tl, q=q, args=args, causal=causal):
                return kfa.flash_attention(q, *args, causal, tl)
            want = kfa.flash_attention_plain(q, k, v, causal)
            tol = FLASH_TOL["bfloat16"]
        before = counter["wgmma"]
        got = run(tile)
        assert counter["wgmma"] == before + 1
        assert got.dtype == torch.bfloat16 and got.shape == q.shape
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got.float(), want.float(), **tol)
        assert torch.equal(got, run(tile))
        if hd == 112:
            simt = ops.legalize_attn_tile(128, 128, hd, s, limit,
                                          torch.float32, quantized)
            assert simt.kind == "simt" and simt.hd == 112
            q32 = q.float()
            if quantized:
                got32 = kfa.flash_attention_quantized(q32, *args, causal, simt)
                want32 = kfa.flash_attention_quantized_plain(
                    q32, kq, vq, ks[..., 0], vs[..., 0], causal)
            else:
                k32, v32 = k.float(), v.float()
                got32 = kfa.flash_attention(q32, k32, v32, causal, simt)
                want32 = kfa.flash_attention_plain(q32, k32, v32, causal)
            torch.testing.assert_close(got32, want32, **FLASH_TOL["float32"])


@pytest.mark.gpu
def test_cuda_fused_ffn_encdec_decode_runs_simt():
    """whisper-tiny's decode FFN under its LBM grant: 2 rows, d_model 384,
    d_ff 1536, bf16, on the gemv decode tile (the 8-row simt tile before;
    fp32 keeps simt), against the plain version, bitwise on a repeat."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(8)
    d, f = 384, 1536
    x = _bf16_rand(gen, 2, d)
    wg, wu = _bf16_rand(gen, d, f, scale=d ** -0.5), _bf16_rand(
        gen, d, f, scale=d ** -0.5)
    wd = _bf16_rand(gen, f, d, scale=f ** -0.5)
    limit = ops.smem_limit(x.device)
    tile = ops.legalize_ffn_tile(128, 128, 2, limit, x.dtype, d, f)
    assert (tile.kind, tile.bs) == ("gemv", 8)
    assert ops.legalize_ffn_tile(128, 128, 2, limit, torch.float32, d,
                                 f).kind == "simt"
    before = kffn.launches_by_kind["gemv"]
    got = ops.fused_ffn(x, wg, wu, wd, block_s=128, block_f=128)
    assert kffn.launches_by_kind["gemv"] == before + 1
    torch.testing.assert_close(
        got.float(), kffn.block_fused_ffn_plain(x, wg, wu, wd).float(),
        **MATMUL_TOL["bfloat16"])
    assert torch.equal(got, ops.fused_ffn(x, wg, wu, wd, block_s=128,
                                          block_f=128))


@pytest.mark.gpu
def test_cuda_fused_ffn_yi9b_decode_runs_gemv():
    """yi-9b's decode FFN under an LBM grant: 2 rows, d_model 4096, d_ff
    11008, bf16, on the gemv tile (clusters of 2 blocks on an H100),
    against the plain version, bitwise on a repeat."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(12)
    d, f = 4096, 11008
    x = _bf16_rand(gen, 2, d)
    wg, wu = _bf16_rand(gen, d, f, scale=d ** -0.5), _bf16_rand(
        gen, d, f, scale=d ** -0.5)
    wd = _bf16_rand(gen, f, d, scale=f ** -0.5)
    tile = ops.legalize_ffn_tile(128, 128, 2, ops.smem_limit(x.device),
                                 x.dtype, d, f)
    assert tile.kind == "gemv"
    before = kffn.launches_by_kind["gemv"]
    got = ops.fused_ffn(x, wg, wu, wd, block_s=128, block_f=128)
    assert kffn.launches_by_kind["gemv"] == before + 1
    torch.testing.assert_close(
        got.float(), kffn.block_fused_ffn_plain(x, wg, wu, wd).float(),
        **MATMUL_TOL["bfloat16"])
    assert torch.equal(got, ops.fused_ffn(x, wg, wu, wd, block_s=128,
                                          block_f=128))


@pytest.mark.gpu
def test_cuda_flash_vlm_shape_runs_wgmma():
    """llava-next's prefill attention: 576 patches + 1024 tokens = 1600
    positions (ragged against the 128-row tile), causal GQA with 32 / 8
    heads of 128, bf16, on the wgmma kernel, against the plain version;
    a second launch is bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(9)
    q = _bf16_rand(gen, 2, 32, 1600, 128)
    k, v = _bf16_rand(gen, 2, 8, 1600, 128), _bf16_rand(gen, 2, 8, 1600, 128)
    tile = ops.legalize_attn_tile(128, 128, 128, 1600,
                                  ops.smem_limit(q.device), q.dtype)
    assert tile.kind == "wgmma"
    before = kfa.launches_by_kind["wgmma"]
    got = ops.attention(q, k, v, causal=True, block_q=128, block_kv=128)
    assert kfa.launches_by_kind["wgmma"] == before + 1
    torch.testing.assert_close(got.float(),
                               kfa.flash_attention_plain(q, k, v,
                                                         True).float(),
                               **FLASH_TOL["bfloat16"])
    assert torch.equal(got, ops.attention(q, k, v, causal=True, block_q=128,
                                          block_kv=128))


# -------------------------------------------------------------- fleet --
def _fleet_archs():
    yi = _bf16("yi-9b", "yi-9b-fleet")
    mb = _bf16("mamba2-370m", "mamba2-fleet")
    return yi.name, yi.name, mb.name, mb.name


@pytest.mark.gpu
def test_fleet_two_replicas_on_one_card_replay_bitwise():
    """chip_smoke.py's serve_fleet at the reduced widths in bf16: two
    replicas on cuda:0, every tenant's params, caches and buffers on it,
    one yi-9b and one mamba2 tenant each, each replica's decode streams
    bitwise equal to a replay of its routed scenario on a fresh server,
    and the fleet's launch counts the replays' sums (ssd_chunk among
    them); a warm fleet round builds nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke
    counts = {}
    out = chip_smoke.serve_fleet_main_path("cuda", counts,
                                           archs=_fleet_archs(), kinds=False)
    assert out["devices"] == ["cuda:0", "cuda:0"]
    assert counts["ssd_chunk"] > 0
    assert len(out["replays"]) == 2
    assert out["round"]["median_tokens_per_s"] > 0


@pytest.mark.gpu
def test_fleet_replicas_on_distinct_cards():
    """Replica r on card r: its tenants' params, caches and buffers lie
    there, and its decode streams replay bitwise on a fresh server on
    the same card."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    import chip_smoke
    from repro_torch.launch.serve import FleetServer, MultiTenantServer
    from repro_torch.sim.driver import TenantSpec
    devices = [torch.device("cuda", r) for r in range(2)]
    kw = dict(batch=1, max_len=256, epoch_len=4, reduced=False)
    fleet = FleetServer(devices=devices, pages_per_replica=64,
                        tenants=[TenantSpec(a, prompt_len=64, n_inferences=6)
                                 for a in _fleet_archs()], **kw)
    assert [srv.device for srv in fleet.replicas] == devices
    assert chip_smoke._misplaced(fleet) == []
    out = fleet.run(12)
    for r, routed in enumerate(fleet.replica_scenarios()):
        solo = MultiTenantServer([], tenants=routed, total_pages=64,
                                 device=devices[r], **kw).run(12)
        for tid, info in solo["tenants"].items():
            assert out["tenants"][tid]["replica"] == f"r{r}"
            assert (out["tenants"][tid]["output"] == info["output"]).all()


@pytest.mark.gpu
def test_tensor_parallel_families_match_tp1_on_the_card():
    """chip_smoke.py's e2e_tp at the reduced widths in bf16: each family
    (olmoe under both MoE modes) at tp = 2 on [cuda:0, cuda:0] against
    tp = 1 with the same weights, prefill and decode under LWM and LBM
    plans within 2e-2 of the largest logit, bitwise on a repeat, the plan
    kernels twice as often on each shard's d_ff slice (once an expert
    under "fsdp")."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import chip_smoke
    cases = [(_bf16(a, f"{a}-tp").name, m, 2) for a, m in (
        ("yi-9b", None), ("mamba2-370m", None), ("olmoe-1b-7b", "fsdp"),
        ("olmoe-1b-7b", "ep2d"), ("zamba2-2.7b", None),
        ("whisper-tiny", None), ("llava-next-mistral-7b", None))]
    counts = {}
    out = chip_smoke.e2e_tp_main_path("cuda", counts, cases=cases)
    assert len(out) == 7 and all(r["bitwise_repeat"] for r in out.values())
    assert counts["cache_matmul"] > 0 and counts["block_fused_ffn"] > 0


@pytest.mark.gpu
def test_tensor_parallel_group_on_distinct_cards():
    """A tp = 2 group of two cards: each piece on its card, each shard's
    KV heads' cache on its card, the group's programs dispatched eagerly (not captured), tokens equal to the same
    group on one card."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.launch.serve import MultiTenantServer
    from repro_torch.sim.driver import TenantSpec
    cfg = _bf16("yi-9b", "yi-9b-tp-cards")
    outs = []
    for devices in (["cuda:0", "cuda:1"], ["cuda:0", "cuda:0"]):
        srv = MultiTenantServer(
            [], batch=1, max_len=256, epoch_len=4, total_pages=64,
            tenants=[TenantSpec(cfg.name, n_inferences=6, prompt_len=64)],
            device=make_serving_mesh(1, tp=2, devices=devices),
            reduced=False)
        w = srv.tenants[0].params["layers"][0]["mlp"]["down"]["w"]
        assert [str(d) for d in w.devices] == devices
        kv = srv.tenants[0].caches[0]
        assert [str(kv[f"k@{r}"].device) for r in (0, 1)] == devices
        outs.append(srv.run(8))
        assert outs[-1]["host"]["captured"] == (devices[0] == devices[1])
    assert (outs[0]["tenants"]["t0:" + cfg.name]["output"]
            == outs[1]["tenants"]["t0:" + cfg.name]["output"]).all()


# ------------------------------------------------------------ training --
@pytest.mark.gpu
@pytest.mark.parametrize("dtype,kind", [("float32", "simt"),
                                        ("bfloat16", "simt"),
                                        ("bfloat16", "wgmma")])
def test_cuda_ssd_chunk_bwd_matches_plain_version(dtype, kind):
    """ssd_chunk's backward kernel of each kind against its plain version
    on the card: B and C per batch row at full width (32 heads, P 64,
    N 128, Q 256), the reduced shape (P 32, N 16), a 44-token tail chunk
    and Q 1 (at P 16, N 8 for simt; P 32, N 16 for wgmma, which takes P 32
    and 64 and N a multiple of 16); each gradient within the fp32
    tolerance of its largest magnitude, or of 1 where that is smaller (the
    arithmetic and the outputs are fp32; dA and ddt end in long sums that
    cancel).  One launch of the kind per call; a second launch is bitwise
    equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(3)
    r = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    q1 = (1, 2, 32, 16, 1, 8) if kind == "wgmma" else (1, 2, 16, 8, 1, 8)
    for b, h, p, n, q, s in ((2, 32, 64, 128, 256, 512), (2, 8, 32, 16, 32, 96),
                             (1, 4, 64, 128, 44, 132), q1):
        x, Bm, Cm = r(b * h, s, p).to(dt), r(b, s, n).to(dt), r(b, s, n).to(dt)
        dts = torch.nn.functional.softplus(r(b * h, s))
        A = r(b * h).abs() + 0.1
        gy, gS = r(b * h, s, p), r(b * h, s // q, n, p)
        before = dict(kssd.launches_bwd_by_kind)
        got = kssd.ssd_chunk_bwd(x, dts, A, Bm, Cm, q, gy, gS, kind=kind)
        assert {k: v - before[k] for k, v in kssd.launches_bwd_by_kind.items()
                } == {k: int(k == kind) for k in kssd.KINDS}
        want = kssd.ssd_chunk_bwd_plain(x, dts, A, Bm.repeat_interleave(h, 0),
                                        Cm.repeat_interleave(h, 0), q, gy, gS)
        want = list(want[:3]) + [w.reshape(b, h, s, n).sum(1)
                                 for w in want[3:]]
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and g.shape == w.shape
            err = float((g - w).abs().max())
            # relative to the larger of the gradient's largest magnitude
            # and 1: at Q 1, dA's terms cancel to exactly 0 in the plain
            # version and to a rounding error of O(1) terms in the kernel
            bar = 2e-3 * max(float(w.abs().max()), 1.0)
            assert err <= bar, (kind, b, h, p, n, q, err)
        again = kssd.ssd_chunk_bwd(x, dts, A, Bm, Cm, q, gy, gS, kind=kind)
        assert all(torch.equal(g, a) for g, a in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-370m", "olmoe-1b-7b"])
def test_bf16_train_step_on_the_card(arch):
    """One bf16 train step of the reduced config through make_train_step:
    finite loss and grad norm, every param in its own dtype (bf16; a
    Mamba2 layer's A_log, D and dt_bias fp32) and on the card, every
    weight matrix moved.  mamba2's step launches ssd_chunk twice a layer
    (again under remat; the wgmma kind) and ssd_chunk_bwd once (wgmma
    too: the forward's kind); olmoe's
    expert products run _dot_f32's bf16 bmm, whose gradient must reach
    the expert weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import counters as kcount
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    cfg = _bf16(arch, f"{arch}-smoke-bf16-train")
    params = M.init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                         device="cuda")
    step = M.make_train_step(cfg, adamw.AdamWConfig(lr=1e-3, warmup_steps=1))
    kcount.zero()
    new, state, m = step(params, adamw.init(params),
                         {"tokens": toks, "labels": toks})
    counts = kcount.snapshot()
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    assert int(state.step) == 1
    for old, p in zip(adamw.tree_leaves(params), adamw.tree_leaves(new)):
        assert p.dtype == old.dtype and p.is_cuda
    # a bf16 norm scale of 1.0 cannot move by lr 1e-3 (its spacing is
    # 2**-7); every weight matrix must
    moved = [not torch.equal(a, b) for a, b in zip(adamw.tree_leaves(params),
                                                   adamw.tree_leaves(new))
             if a.dim() >= 2]
    assert moved and all(moved)
    if arch == "mamba2-370m":
        assert counts["ssd_chunk.wgmma"] == 2 * cfg.num_layers
        assert counts["ssd_chunk_bwd"] == cfg.num_layers
        assert counts["ssd_chunk_bwd.wgmma"] == cfg.num_layers
    else:
        assert counts["ssd_chunk"] == 0
        for layer in new["layers"]:
            assert all(float(layer["mlp"][k].float().abs().sum()) > 0
                       for k in ("gate", "up", "down"))
