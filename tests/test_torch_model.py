"""The port's dense model stack against the JAX package's, at the reduced
yi-9b config (fp32), with the reference's params handed over through
``repro_torch.bridge``.  Tokens come from numpy and go to both sides.

Logits agree within atol = rtol = 1e-4 (fp32 with sums taken in another
order than XLA's).  Decode epochs are teacher-forced: both sides see the
same input tokens every step, and their greedy tokens must be equal.
"""
import dataclasses

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
from repro.models import transformer as RT
from repro_torch import bridge
from repro_torch.core import plan as pplan
from repro_torch.core.allocator import Selection as PSelection
from repro_torch.core.mct import MappingCandidate as PCandidate
from repro_torch.models import attention as PA
from repro_torch.models import base as pbase
from repro_torch.models import model as PM
from repro_torch.models import transformer as PT

ATOL = RTOL = 1e-4
B, MAX_LEN = 2, 64


@pytest.fixture(scope="module")
def yi():
    rcfg = rbase.get_arch("yi-9b").reduced()
    pcfg = pbase.get_arch("yi-9b").reduced()
    rparams = RM.init_params(rcfg, jax.random.PRNGKey(1))
    pparams = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, rparams), pcfg, "cpu")
    return rcfg, pcfg, rparams, pparams


@pytest.fixture(scope="module")
def ref_fns():
    return (jax.jit(RT.decode_step, static_argnames=("cfg", "plan", "kv_len")),
            jax.jit(RT.prefill_chunk, static_argnames=("cfg", "kv_len")))


def _plans(kind, cfg, kv_dtype="native"):
    """The same grant lowered by both packages: (reference, port)."""
    pages = 4096 if kind == "LBM" else 2
    kw = dict(seq_block=128, d_model=cfg.d_model, d_ff=cfg.d_ff,
              dtype_bytes=4, head_dim=cfg.hd, kv_dtype=kv_dtype)

    def sel(Candidate, Selection):
        return Selection(Candidate(kind=kind, p_need=pages, dram_bytes=0,
                                   flops=0, loops=(), cache_map=(),
                                   usage_limit_bytes=0), pages, 0.0)
    rp = rplan.lower_selection(sel(RCandidate, RSelection), pages, **kw)
    pp = pplan.lower_selection(sel(PCandidate, PSelection), pages, **kw)
    assert rp.describe() == pp.describe() and rp.kind == kind
    return rp, pp


def _prompt(cfg, n=20, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n),
                                                dtype=np.int32)


# ------------------------------------------------------------ configs --
def test_arch_configs_match_reference():
    ref, port = rbase.all_archs(), pbase.all_archs()
    assert sorted(ref) == sorted(port)
    for name, rc in ref.items():
        pc = port[name]
        for r, p in ((rc, pc), (rc.reduced(), pc.reduced())):
            assert dataclasses.asdict(r) == dataclasses.asdict(p)
            assert r.padded_vocab == p.padded_vocab
            assert r.param_count() == p.param_count()
            assert p.torch_dtype == getattr(torch, r.dtype)


def test_bridge_is_bit_exact_for_bf16():
    cfg = dataclasses.replace(rbase.get_arch("yi-9b").reduced(),
                              dtype="bfloat16")
    pcfg = dataclasses.replace(pbase.get_arch("yi-9b").reduced(),
                               dtype="bfloat16")
    tree = jax.tree_util.tree_map(
        np.asarray, RM.init_params(cfg, jax.random.PRNGKey(3)))
    params = bridge.params_from_numpy(tree, pcfg, "cpu")
    assert len(params["layers"]) == cfg.num_layers
    ref_w = tree["layers"]["mlp"]["down"]["w"]
    assert ref_w.dtype == ml_dtypes.bfloat16
    for g in range(cfg.num_layers):
        got = params["layers"][g]["mlp"]["down"]["w"]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      ref_w[g].view(np.int16))
    np.testing.assert_array_equal(
        params["embed"]["table"].view(torch.int16).numpy(),
        tree["embed"]["table"].view(np.int16))


# ------------------------------------------------------------- logits --
def test_lm_forward_matches_reference(yi):
    rcfg, pcfg, rparams, pparams = yi
    toks = _prompt(rcfg, 24)
    want, _ = RT.lm_forward(rparams, jnp.asarray(toks), rcfg)
    got, _ = PT.lm_forward(pparams, torch.from_numpy(toks).long(), pcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


def test_prefill_chunk_and_decode_step_logits_match_reference(yi, ref_fns):
    rcfg, pcfg, rparams, pparams = yi
    rdec, rpf = ref_fns
    toks = _prompt(rcfg, 20)
    rc = RT.init_caches(rparams, rcfg, B, MAX_LEN)
    pc = PT.init_caches(pparams, pcfg, B, MAX_LEN, device="cpu")
    # two chunks, the second resuming the cache
    for lo, hi in ((0, 12), (12, 20)):
        rl, rc = rpf(rparams, jnp.asarray(toks[:, lo:hi]), rc, jnp.int32(lo),
                     rcfg)
        pl, pc = PT.prefill_chunk(pparams, torch.from_numpy(toks[:, lo:hi]).long(),
                                  pc, lo, pcfg)
        np.testing.assert_allclose(pl.numpy(), np.asarray(rl),
                                   atol=ATOL, rtol=RTOL)
    feed = _prompt(rcfg, 3, seed=1)
    for i in range(3):
        tok = feed[:, i:i + 1]
        rl, rc = rdec(rparams, jnp.asarray(tok), rc, jnp.int32(20 + i), rcfg)
        pl, pc = PT.decode_step(pparams, torch.from_numpy(tok).long(), pc,
                                20 + i, pcfg)
        np.testing.assert_allclose(pl.numpy(), np.asarray(rl),
                                   atol=ATOL, rtol=RTOL)
    for g in range(rcfg.num_layers):
        for name in ("k", "v"):
            np.testing.assert_allclose(pc[g][name].numpy(),
                                       np.asarray(rc[g][name]),
                                       atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("kind", ["LBM", "LWM"])
def test_decode_epoch_teacher_forced_matches_reference(yi, ref_fns, kind):
    """8 decode steps under one plan: the port's ``decode_epoch`` fed the
    same tokens as the reference's ``decode_step`` (whose epoch scan is
    bit-identical to it, tests/test_serve_pipeline.py) yields the same
    greedy tokens and matching logits."""
    rcfg, pcfg, rparams, pparams = yi
    rdec, rpf = ref_fns
    rp, pp = _plans(kind, rcfg)
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
    np.testing.assert_allclose(np.stack(got_logits), np.stack(want_logits),
                               atol=ATOL, rtol=RTOL)


# ------------------------------------------------- port against itself --
@pytest.mark.parametrize("kind", ["LBM", "LWM"])
def test_epoch_matches_sequential_steps_bitwise(yi, kind):
    """Mirrors test_serve_pipeline.py::test_epoch_scan_matches_sequential:
    one K-step epoch equals K decode steps, tokens and caches bitwise."""
    _, pcfg, _, pparams = yi
    _, plan = _plans(kind, pcfg)
    token = torch.zeros((B, 1), dtype=torch.long)
    step = PM.make_decode_step(pcfg)
    caches = PT.init_caches(pparams, pcfg, B, 16, device="cpu")
    tok, want = token, []
    for i in range(4):
        nxt, caches = step(pparams, caches, tok, i, plan=plan)
        want.append(nxt)
        tok = nxt[:, None]
    epoch = PM.make_decode_epoch(pcfg)
    got_caches = PT.init_caches(pparams, pcfg, B, 16, device="cpu")
    got, got_caches = epoch(pparams, got_caches, token, 0, plan=plan, k=4)
    assert torch.equal(got, torch.stack(want, 1))
    for a, b in zip(got_caches, caches):
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])


def test_kv_len_window_matches_full_read(yi):
    """Mirrors test_serve_pipeline.py::test_kv_len_window_matches_full_read:
    a window covering the live prefix reproduces the full-length read."""
    _, pcfg, _, pparams = yi
    step = PM.make_decode_step(pcfg)
    outs = []
    for kv_len in (None, 128):
        caches = PT.init_caches(pparams, pcfg, 1, 256, device="cpu")
        tok, got = torch.zeros((1, 1), dtype=torch.long), []
        for i in range(4):
            nxt, caches = step(pparams, caches, tok, i, kv_len=kv_len)
            got.append(nxt)
            tok = nxt[:, None]
        outs.append(torch.stack(got, 1))
    assert torch.equal(outs[0], outs[1])


def test_unported_attention_paths_raise(yi):
    _, pcfg, _, pparams = yi
    attn = pparams["layers"][0]["attn"]
    x = torch.zeros((1, 8, pcfg.d_model))
    with pytest.raises(NotImplementedError):
        PA.mha(attn, x, pcfg, xattn_kv=x)
    with pytest.raises(ValueError):
        PA.init_kv_cache(pcfg, 1, 8, kv_dtype="int4", device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="embeds_prefix"):
        PT.lm_forward(pparams, toks, pcfg, embeds_prefix=x)
    with pytest.raises(NotImplementedError, match="remat"):
        PT.lm_forward(pparams, toks, pcfg, remat=True)


# ------------------------------------------------ plan-lowered prefill --
@pytest.fixture(scope="module")
def yi_gqa():
    """Reduced yi-9b with 2 KV heads for 4 query heads: the reduced
    configs have H = Hkv, so only this variant exercises GQA grouping at
    model level.  It is passed to both packages as a config object, so
    neither registry changes."""
    rcfg = dataclasses.replace(rbase.get_arch("yi-9b").reduced(),
                               num_kv_heads=2)
    pcfg = dataclasses.replace(pbase.get_arch("yi-9b").reduced(),
                               num_kv_heads=2)
    rparams = RM.init_params(rcfg, jax.random.PRNGKey(2))
    pparams = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, rparams), pcfg, "cpu")
    return rcfg, pcfg, rparams, pparams


@pytest.mark.parametrize("arch", ["yi", "yi_gqa"])
@pytest.mark.parametrize("kind,kv_dtype", [("LBM", "native"), ("LWM", "int8")])
def test_make_prefill_with_plan_matches_reference(request, arch, kind,
                                                  kv_dtype):
    """One-shot prefill under a plan (flash attention with the plan's
    blocks and KV precision, the FFN through the granted kernel) against
    the reference's, whose Pallas kernels run in interpret mode.  A
    48-token prompt leaves the flash tiles ragged.  The int8 plan is held
    at 2e-3 (tests/test_plan.py's bar for plan-lowered prefill): K and V
    are quantized from values computed in another summation order, and a
    value a few ULP apart can round to the other int8 step."""
    rcfg, pcfg, rparams, pparams = request.getfixturevalue(arch)
    rp, pp = _plans(kind, rcfg, kv_dtype)
    assert rp.attn.kv_dtype == pp.attn.kv_dtype == kv_dtype
    toks = _prompt(rcfg, 48, seed=3)
    want = RM.make_prefill(rcfg)(rparams, {"tokens": jnp.asarray(toks)}, rp)
    got = PM.make_prefill(pcfg)(pparams, {"tokens": torch.from_numpy(toks).long()},
                                pp)
    assert got.shape == (B, pcfg.padded_vocab)
    tol = ATOL if kv_dtype == "native" else 2e-3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)
    plain = PM.make_prefill(pcfg)(
        pparams, {"tokens": torch.from_numpy(toks).long()})
    if kv_dtype == "native":
        np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL,
                                   rtol=RTOL)
