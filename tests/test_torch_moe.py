"""The port's MoE layer and MoE model stack against the JAX package's, at
the reduced olmoe-1b-7b and kimi-k2-1t-a32b configs (4 experts, top-2,
2 layers, fp32), with the reference's params handed over through
``repro_torch.bridge``.  Inputs come from numpy and go to both sides.
Where the reference reaches a Pallas kernel (a plan's expert FFNs) it
runs in interpret mode, as the reference's own CPU tests run it.

Tolerances, each relative to the largest reference value (|x| below 1
counts as 1): 1e-5 in fp32, where the sums are taken in another order
than XLA's; the stack's logits 1e-4 (more products deep, as
``tests/test_torch_model.py``); a bf16 variant 2e-2.  The port against
itself is bitwise.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import plan as rplan
from repro.core.allocator import Selection as RSelection
from repro.core.mct import MappingCandidate as RCandidate
from repro.models import base as rbase
from repro.models import model as RM
from repro.models import moe as RMoE
from repro.models import transformer as RT
from repro_torch import bridge
from repro_torch.core import plan as pplan
from repro_torch.core.allocator import Selection as PSelection
from repro_torch.core.mct import MappingCandidate as PCandidate
from repro_torch.models import base as pbase
from repro_torch.models import model as PM
from repro_torch.models import moe as PMoE
from repro_torch.models import transformer as PT

TOL = 1e-5
LOGIT_TOL = 1e-4
BF16_TOL = 2e-2
B, MAX_LEN = 2, 64
ARCHS = ["olmoe-1b-7b", "kimi-k2-1t-a32b"]


def _cfgs(arch, dtype="float32"):
    rcfg = dataclasses.replace(rbase.get_arch(arch).reduced(), dtype=dtype)
    pcfg = dataclasses.replace(pbase.get_arch(arch).reduced(), dtype=dtype)
    return rcfg, pcfg


@functools.lru_cache(maxsize=None)
def _model(arch, dtype="float32", seed=1):
    rcfg, pcfg = _cfgs(arch, dtype)
    rparams = RM.init_params(rcfg, jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    return rcfg, pcfg, rparams, bridge.params_from_numpy(tree, pcfg, "cpu")


def _layer(arch, dtype="float32", g=0):
    """One layer's MoE params: (reference, port)."""
    _, _, rparams, pparams = _model(arch, dtype)
    rp = jax.tree_util.tree_map(lambda a: a[g], rparams["layers"]["mlp"])
    return rp, pparams["layers"][g]["mlp"]


def _x(cfg, t, seed=0, dtype=np.float32):
    x = np.random.default_rng(seed).standard_normal((B, t, cfg.d_model))
    return x.astype(np.float32).astype(dtype)


def _prompt(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n),
                                                dtype=np.int32)


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=tol * max(1.0, float(np.abs(want).max())),
                               rtol=tol)


def _plans(kind, cfg):
    """The same grant lowered by both packages: (reference, port)."""
    pages = 4096 if kind == "LBM" else 2
    kw = dict(seq_block=128, d_model=cfg.d_model, d_ff=cfg.d_ff,
              dtype_bytes=4, head_dim=cfg.hd)

    def sel(Candidate, Selection):
        return Selection(Candidate(kind=kind, p_need=pages, dram_bytes=0,
                                   flops=0, loops=(), cache_map=(),
                                   usage_limit_bytes=0), pages, 0.0)
    rp = rplan.lower_selection(sel(RCandidate, RSelection), pages, **kw)
    pp = pplan.lower_selection(sel(PCandidate, PSelection), pages, **kw)
    assert rp.describe() == pp.describe() and rp.kind == kind
    return rp, pp


# ------------------------------------------------------------- layer --
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_equals_reference(arch):
    rcfg, pcfg = rbase.get_arch(arch), pbase.get_arch(arch)
    for r, p in ((rcfg, pcfg), (rcfg.reduced(), pcfg.reduced())):
        for t in list(range(1, 70)) + [128, 256, 328, 1000, 1024, 4096]:
            assert PMoE.capacity(t, p) == RMoE.capacity(t, r), (r.name, t)
    if arch == "olmoe-1b-7b":          # G*C = 328 at 2 x 1024 tokens
        assert PMoE.capacity(1024, pcfg) == 164


@pytest.mark.parametrize("drop_free", [False, True], ids=["dropping",
                                                          "drop_free"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, drop_free):
    """Plain buckets (no plan): y and the aux loss."""
    rcfg, pcfg, _, _ = _model(arch)
    rp, pp = _layer(arch)
    x = _x(rcfg, 40)
    want, want_aux = RMoE.moe_apply(rp, jnp.asarray(x), rcfg,
                                    drop_free=drop_free)
    got, aux = PMoE.moe_apply(pp, torch.from_numpy(x), pcfg,
                              drop_free=drop_free)
    assert got.shape == x.shape and got.dtype == torch.float32
    _close(got.numpy(), want)
    _close(float(aux), float(want_aux))


def _skew(router):
    """A router (numpy, [..., d, E]) whose experts 0 and 1 score high for
    any token with a positive mean (:func:`_skewed_x`)."""
    bias = np.zeros(router.shape, np.float32)
    bias[..., :2] = 8.0 / router.shape[-2]
    return router + bias


def _skewed_x(cfg, t, seed):
    return _x(cfg, t, seed) + 1.0


def _skewed(rp, pp):
    """Both packages' layer params with the :func:`_skew` router."""
    router = _skew(np.asarray(rp["router"]))
    return (dict(rp, router=jnp.asarray(router)),
            dict(pp, router=torch.from_numpy(router)))


@pytest.mark.parametrize("drop_free", [False, True], ids=["dropping",
                                                          "drop_free"])
def test_skewed_router_overflows_capacity_and_matches(drop_free):
    """A router skewed onto two experts overflows ``capacity(T)``: some
    entries are dropped (none when drop-free), and the port still
    matches the reference."""
    rcfg, pcfg, _, _ = _model("olmoe-1b-7b")
    rp, pp = _skewed(*_layer("olmoe-1b-7b"))
    T = 40
    x = _skewed_x(rcfg, T, seed=5)
    xt = torch.from_numpy(x)
    probs = torch.softmax(xt @ pp["router"], -1)
    top_e = torch.topk(probs, pcfg.experts_per_token, -1).indices
    C = T if drop_free else PMoE.capacity(T, pcfg)
    _, _, _, keep, _ = PMoE._dispatch(xt, top_e, C, pcfg.num_experts)
    dropped = int((~keep).sum())
    assert (dropped == 0) if drop_free else (dropped > 0)
    want, want_aux = RMoE.moe_apply(rp, jnp.asarray(x), rcfg,
                                    drop_free=drop_free)
    got, aux = PMoE.moe_apply(pp, xt, pcfg, drop_free=drop_free)
    _close(got.numpy(), want)
    _close(float(aux), float(want_aux))


@pytest.mark.parametrize("decode_fast", [True, False], ids=["fast",
                                                            "buckets"])
@pytest.mark.parametrize("arch", ARCHS)
def test_one_token_matches_reference(arch, decode_fast):
    """T == 1: the gathered-expert fast path, and with
    ``decode_fast=False`` the capacity buckets (a prefill's one-token
    tail chunk)."""
    rcfg, pcfg, _, _ = _model(arch)
    rp, pp = _layer(arch)
    x = _x(rcfg, 1, seed=2)
    want, want_aux = RMoE.moe_apply(rp, jnp.asarray(x), rcfg,
                                    decode_fast=decode_fast)
    got, aux = PMoE.moe_apply(pp, torch.from_numpy(x), pcfg,
                              decode_fast=decode_fast)
    _close(got.numpy(), want)
    _close(float(aux), float(want_aux))


@pytest.mark.parametrize("drop_free", [False, True], ids=["dropping",
                                                          "drop_free"])
@pytest.mark.parametrize("kind", ["LBM", "LWM"])
def test_planned_buckets_match_reference(kind, drop_free):
    """Under a plan each expert's SwiGLU runs through ``planned_ffn``
    (the fused LBM kernel or three LWM matmuls; the reference's Pallas
    kernels in interpret mode), and agrees with the reference and with
    the port's plain buckets."""
    rcfg, pcfg, _, _ = _model("olmoe-1b-7b")
    rp, pp = _layer("olmoe-1b-7b")
    rplan_, pplan_ = _plans(kind, rcfg)
    x = _x(rcfg, 40, seed=3)
    want, _ = RMoE.moe_apply(rp, jnp.asarray(x), rcfg, plan=rplan_.ffn,
                             drop_free=drop_free)
    got, _ = PMoE.moe_apply(pp, torch.from_numpy(x), pcfg, plan=pplan_.ffn,
                            drop_free=drop_free)
    plain, _ = PMoE.moe_apply(pp, torch.from_numpy(x), pcfg,
                              drop_free=drop_free)
    _close(got.numpy(), want)
    _close(got.numpy(), plain.numpy())


@pytest.mark.parametrize("t", [1, 40])
def test_bf16_moe_apply_matches_reference(t):
    """bf16 weights and activations (the full-width dtype): within 2e-2
    of the largest reference value, fast path and buckets.  JAX's CPU
    backend has no bf16 x bf16 -> fp32 product, which the reference's
    buckets ask for, so the reference runs on the same bf16 values held
    in fp32 (its products' fp32 semantics)."""
    rcfg, pcfg, _, _ = _model("olmoe-1b-7b", "bfloat16")
    rp, pp = _layer("olmoe-1b-7b", "bfloat16")
    x = _x(rcfg, t, seed=4, dtype=ml_dtypes.bfloat16)
    f32 = lambda a: jnp.asarray(np.asarray(a, np.float32))  # noqa: E731
    want, want_aux = RMoE.moe_apply(jax.tree_util.tree_map(f32, rp), f32(x),
                                    dataclasses.replace(rcfg,
                                                        dtype="float32"))
    got, aux = PMoE.moe_apply(pp, bridge.tensor_from_numpy(x, "cpu"), pcfg)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want, np.float32)
    tol = BF16_TOL * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)
    _close(float(aux), float(want_aux), tol=BF16_TOL)


@pytest.mark.parametrize("t", [1, 40])
def test_moe_apply_repeats_bitwise(t):
    """Two runs of the port agree bitwise (the combine adds each token's
    contributions in a fixed order)."""
    _, pcfg, _, _ = _model("olmoe-1b-7b")
    _, pp = _layer("olmoe-1b-7b")
    x = torch.from_numpy(_x(pcfg, t, seed=6))
    a, aux_a = PMoE.moe_apply(pp, x, pcfg, decode_fast=False)
    b, aux_b = PMoE.moe_apply(pp, x, pcfg, decode_fast=False)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


def test_bridge_is_bit_exact_for_moe_leaves_in_bf16():
    """The stacked ``[L, E, d, f]`` expert leaves and the ``[L, d, E]``
    router split into per-layer tensors, bit-exact in bf16."""
    rcfg, pcfg, rparams, pparams = _model("olmoe-1b-7b", "bfloat16")
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    mlp = tree["layers"]["mlp"]
    assert mlp["gate"].dtype == ml_dtypes.bfloat16
    assert mlp["gate"].shape == (rcfg.num_layers, rcfg.num_experts,
                                 rcfg.d_model, rcfg.d_ff)
    assert len(pparams["layers"]) == rcfg.num_layers
    for g in range(rcfg.num_layers):
        got = pparams["layers"][g]["mlp"]
        assert sorted(got) == ["down", "gate", "router", "up"]
        for name in got:
            assert got[name].dtype == torch.bfloat16
            assert tuple(got[name].shape) == mlp[name].shape[1:]
            np.testing.assert_array_equal(got[name].view(torch.int16).numpy(),
                                          mlp[name][g].view(np.int16))


def test_init_lm_builds_moe_layers():
    """``init_lm`` draws an MoE FFN for an MoE arch, with the reference's
    leaf shapes and dtypes."""
    _, pcfg, _, pparams = _model("olmoe-1b-7b")
    gen = torch.Generator().manual_seed(0)
    params = PT.init_lm(gen, pcfg)
    for got, want in zip(params["layers"], pparams["layers"]):
        for name in ("router", "gate", "up", "down"):
            assert got["mlp"][name].shape == want["mlp"][name].shape
            assert got["mlp"][name].dtype == want["mlp"][name].dtype


# ------------------------------------------------------------- stack --
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_logits_and_aux_match_reference(arch):
    rcfg, pcfg, rparams, pparams = _model(arch)
    toks = _prompt(rcfg, 24)
    want, want_aux = RT.lm_forward(rparams, jnp.asarray(toks), rcfg)
    got, aux = PT.lm_forward(pparams, torch.from_numpy(toks).long(), pcfg)
    _close(got.numpy(), want, LOGIT_TOL)
    assert float(want_aux) > 0
    _close(float(aux), float(want_aux))


@pytest.mark.parametrize("serve", [False, True], ids=["dropping", "serve"])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_prefill_matches_reference(arch, serve):
    rcfg, pcfg, rparams, pparams = _model(arch)
    toks = _prompt(rcfg, 33, seed=1)
    want = RM.make_prefill(rcfg, serve=serve)(rparams,
                                              {"tokens": jnp.asarray(toks)})
    got = PM.make_prefill(pcfg, serve=serve)(
        pparams, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (B, pcfg.padded_vocab)
    _close(got.numpy(), want, LOGIT_TOL)


def test_make_prefill_serve_drops_no_token():
    """``serve=True`` reaches the drop-free buckets: with a router skewed
    onto two experts the dropping prefill and the serving one differ,
    and each matches the reference's of the same ``serve``."""
    rcfg, pcfg, rparams, pparams = _model("olmoe-1b-7b")
    router = _skew(np.asarray(rparams["layers"]["mlp"]["router"]))
    rparams = jax.tree_util.tree_map(lambda a: a, rparams)
    rparams["layers"]["mlp"]["router"] = jnp.asarray(router)
    pparams = dict(pparams, layers=[
        {**lp, "mlp": {**lp["mlp"], "router": torch.from_numpy(router[g])}}
        for g, lp in enumerate(pparams["layers"])])
    # the residual stream's mean stays positive when the embeddings' is
    table = np.asarray(rparams["embed"]["table"]) + 1.0
    rparams["embed"] = {"table": jnp.asarray(table)}
    pparams["embed"] = {"table": torch.from_numpy(table)}
    toks = _prompt(rcfg, 40, seed=2)
    got = {}
    for serve in (False, True):
        want = RM.make_prefill(rcfg, serve=serve)(
            rparams, {"tokens": jnp.asarray(toks)})
        got[serve] = PM.make_prefill(pcfg, serve=serve)(
            pparams, {"tokens": torch.from_numpy(toks).long()})
        _close(got[serve].numpy(), want, LOGIT_TOL)
    assert not torch.allclose(got[False], got[True], atol=1e-3)


@pytest.mark.parametrize("kind", ["LBM", "LWM"])
def test_make_prefill_with_plan_matches_reference(kind):
    """One-shot prefill under a plan: flash attention and every expert's
    FFN through the granted kernels (the reference's in interpret
    mode)."""
    rcfg, pcfg, rparams, pparams = _model("olmoe-1b-7b")
    rp, pp = _plans(kind, rcfg)
    toks = _prompt(rcfg, 48, seed=3)
    want = RM.make_prefill(rcfg)(rparams, {"tokens": jnp.asarray(toks)}, rp)
    got = PM.make_prefill(pcfg)(pparams,
                                {"tokens": torch.from_numpy(toks).long()}, pp)
    _close(got.numpy(), want, LOGIT_TOL)


@pytest.fixture(scope="module")
def ref_fns():
    return (jax.jit(RT.decode_step, static_argnames=("cfg", "plan", "kv_len")),
            jax.jit(RT.prefill_chunk, static_argnames=("cfg", "kv_len")))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunk_and_decode_step_match_reference(arch, ref_fns):
    """Two prompt chunks (the second resuming the cache, the last a
    one-token chunk through the drop-free buckets), then decode steps
    (the fast path): logits and KV caches."""
    rcfg, pcfg, rparams, pparams = _model(arch)
    rdec, rpf = ref_fns
    toks = _prompt(rcfg, 21)
    rc = RT.init_caches(rparams, rcfg, B, MAX_LEN)
    pc = PT.init_caches(pparams, pcfg, B, MAX_LEN, device="cpu")
    for lo, hi in ((0, 12), (12, 20), (20, 21)):
        rl, rc = rpf(rparams, jnp.asarray(toks[:, lo:hi]), rc, jnp.int32(lo),
                     rcfg)
        pl, pc = PT.prefill_chunk(pparams,
                                  torch.from_numpy(toks[:, lo:hi]).long(),
                                  pc, lo, pcfg)
        _close(pl.numpy(), rl, LOGIT_TOL)
    feed = _prompt(rcfg, 3, seed=1)
    for i in range(3):
        tok = feed[:, i:i + 1]
        rl, rc = rdec(rparams, jnp.asarray(tok), rc, jnp.int32(21 + i), rcfg)
        pl, pc = PT.decode_step(pparams, torch.from_numpy(tok).long(), pc,
                                21 + i, pcfg)
        _close(pl.numpy(), rl, LOGIT_TOL)
    for g in range(rcfg.num_layers):
        for name in ("k", "v"):
            _close(pc[g][name].numpy(), rc[g][name], LOGIT_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_epoch_teacher_forced_matches_reference(arch, ref_fns):
    """8 decode steps under an LWM plan (which MoE decode ignores): the
    port's ``decode_epoch`` fed the same tokens as the reference's
    ``decode_step`` gives the same greedy tokens and matching logits."""
    rcfg, pcfg, rparams, pparams = _model(arch)
    rdec, rpf = ref_fns
    rp, pp = _plans("LWM", rcfg)
    prompt = _prompt(rcfg, 16)
    forced = _prompt(rcfg, 9, seed=2)
    rc = RT.init_caches(rparams, rcfg, B, MAX_LEN)
    _, rc = rpf(rparams, jnp.asarray(prompt), rc, jnp.int32(0), rcfg)
    want_tok, want_logits = [], []
    for i in range(8):
        rl, rc = rdec(rparams, jnp.asarray(forced[:, i:i + 1]), rc,
                      jnp.int32(16 + i), rcfg, plan=rp)
        want_logits.append(np.asarray(rl)[:, -1])
        want_tok.append(np.asarray(RM._greedy_next_token(rcfg)(rl)))

    pc = PT.init_caches(pparams, pcfg, B, MAX_LEN, device="cpu")
    _, pc = PT.prefill_chunk(pparams, torch.from_numpy(prompt).long(), pc, 0,
                             pcfg)
    greedy = PM._greedy_next_token(pcfg)
    forced_t = torch.from_numpy(forced).long()
    got_tok, got_logits = [], []

    def teacher(logits):
        got_logits.append(logits[:, -1].numpy())
        got_tok.append(greedy(logits).numpy())
        return forced_t[:, len(got_tok)]

    PT.decode_epoch(pparams, forced_t[:, :1], pc, 16, pcfg, 8,
                    next_token_fn=teacher, plan=pp)
    np.testing.assert_array_equal(np.stack(got_tok), np.stack(want_tok))
    _close(np.stack(got_logits), np.stack(want_logits), LOGIT_TOL)


def test_chunked_prefill_equals_one_shot_serve_prefill():
    """The port's chunked prefill (LANE-free chunk boundaries at the
    reduced width) against its one-shot ``make_prefill(serve=True)``:
    the drop-free buckets keep the same tokens, so the last logits agree
    within fp32 summation order."""
    _, pcfg, _, pparams = _model("olmoe-1b-7b")
    toks = torch.from_numpy(_prompt(pcfg, 40, seed=7)).long()
    one = PM.make_prefill(pcfg, serve=True)(pparams, {"tokens": toks})
    pc = PT.init_caches(pparams, pcfg, B, MAX_LEN, device="cpu")
    for lo, hi in ((0, 16), (16, 32), (32, 40)):
        logits, pc = PT.prefill_chunk(pparams, toks[:, lo:hi], pc, lo, pcfg)
    _close(logits[:, -1].numpy(), one.numpy(), LOGIT_TOL)


# ------------------------------------------- full-width expert shapes --
@pytest.mark.parametrize("rows", [328, 2048], ids=["dropping", "serve"])
def test_full_width_expert_launches_route_to_wgmma(rows):
    """olmoe-1b-7b's expert GEMMs at full width, under the prefill's
    plans lowered at d_ff 1024 (a 32-page LWM grant, and the smallest LBM
    grant that lowers fused at 1024 prompt tokens), route to the wgmma
    kinds in bf16: gate/up [rows, 2048] @ [2048, 1024] and down
    [rows, 1024] @ [1024, 2048] (``make_prefill`` at 2 x 1024 tokens has
    G*C = 328 rows per expert, 2048 with ``serve=True``); the fused
    FFN's d_ff of 1024 is one cluster of 8 blocks of 128, so its partial
    slab is one [rows, 2048] fp32."""
    from repro_torch.core.vmem import fused_ffn_pages
    from repro_torch.kernels import block_fused_ffn as kffn
    from repro_torch.kernels import ops
    cfg = pbase.get_arch("olmoe-1b-7b")
    d, f, limit, bf16 = cfg.d_model, cfg.d_ff, 232448, torch.bfloat16
    assert 2 * PMoE.capacity(1024, cfg) == 328
    kw = dict(seq_block=1024, d_model=d, d_ff=f, dtype_bytes=2,
              head_dim=cfg.hd)

    def lower(kind, pages):
        cand = PCandidate(kind=kind, p_need=pages, dram_bytes=0, flops=0,
                          loops=(), cache_map=(), usage_limit_bytes=0)
        plan = pplan.lower_selection(PSelection(cand, pages, 0.0), pages,
                                     **kw)
        assert plan.kind == kind
        return plan.ffn

    lwm = lower("LWM", 32)
    for tile, k, n in ((lwm.up_tile, d, f), (lwm.down_tile, f, d)):
        hop = ops.legalize_matmul_tile(tile, rows, limit, bf16, k, n)
        assert hop.kind == "wgmma" and hop.bm == 128, (k, n, hop)
    lbm = lower("LBM", fused_ffn_pages(1024, d, f, 2))
    hop = ops.legalize_ffn_tile(lbm.block_s, lbm.block_f, rows, limit, bf16,
                                d, f)
    assert hop.kind == "wgmma" and f // hop.bf == kffn.CLUSTER
    assert kffn.partial_bytes(hop, rows, d, f) == 4 * rows * d
