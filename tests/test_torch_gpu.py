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
outputs are fp32).
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
    shapes, every compiled tile of the dtype with the K/V storage it
    takes, native and quantized (the wgmma tiles: bf16, hd 128, bitwise
    on a repeat); the fp32 quantized path bitwise equal to the native one
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
