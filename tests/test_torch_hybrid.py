"""The port's hybrid family (Zamba2-style: groups of Mamba2 layers and
one shared attention + FFN block) against the JAX package's, at the
reduced zamba2-2.7b config (fp32: 6 layers, ``attn_every`` 2, so 3 groups
of one Mamba2 layer and the shared block; sliding window 64), with the
reference's params and caches handed over through ``repro_torch.bridge``.
Inputs come from numpy and go to both sides.

Tolerances, stated per test:

* logits, decode and chunked prefill: rtol = atol = 2e-3, the SSM
  family's (tests/test_torch_ssm.py: the reference rounds its
  intra-chunk weights to x's dtype, fp32 here, and both sum in another
  order); greedy tokens must be equal;
* int8 / fp8 KV caches: the reference's hybrid bars of
  tests/test_quant_decode.py:38 against the native cache (cosine >=
  0.999, max |logit error| <= 0.50), and the port's quantized stream
  within 2e-3 of the reference's;
* bridge, cache layout and prefix seeding: bit-exact.

Also: a variant with ``attn_every`` 3 (two Mamba2 layers a group), a
prompt longer than the window, an 18-layer variant whose 9 groups take
the reference's stacked cache form, plan-lowered prefill under LBM and
LWM grants (the reference's Pallas kernels in interpret mode), and the
kernel routing of the full-width shapes.
"""
import dataclasses

import jax
import jax.numpy as jnp
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
from repro_torch.core.vmem import LANE
from repro_torch.kernels import ops
from repro_torch.models import base as pbase
from repro_torch.models import model as PM
from repro_torch.models import transformer as PT

TOL = dict(rtol=2e-3, atol=2e-3)       # tests/test_torch_ssm.py::TOL
QUANT_MIN_COS, QUANT_MAX_ERR = 0.999, 0.50   # tests/test_quant_decode.py:38
ARCH = "zamba2-2.7b"
B, MAX_LEN = 2, 96
H100_SMEM = 232448                      # opt-in shared memory per block


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _cfgs(**kw):
    """(reference, port) reduced zamba2 configs with ``kw`` replaced."""
    return (dataclasses.replace(rbase.get_arch(ARCH).reduced(), **kw),
            dataclasses.replace(pbase.get_arch(ARCH).reduced(), **kw))


def _model(seed=1, **kw):
    rcfg, pcfg = _cfgs(**kw)
    rparams = RM.init_params(rcfg, jax.random.PRNGKey(seed))
    pparams = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, rparams), pcfg, "cpu")
    return rcfg, pcfg, rparams, pparams


@pytest.fixture(scope="module")
def zamba():
    return _model()


@pytest.fixture(scope="module")
def zamba3():
    """``attn_every`` 3: two groups of two Mamba2 layers and the block."""
    return _model(seed=2, attn_every=3)


@pytest.fixture(scope="module")
def ref_fns():
    return (jax.jit(RT.decode_step, static_argnames=("cfg", "plan", "kv_len")),
            jax.jit(RT.prefill_chunk, static_argnames=("cfg", "kv_len")))


def _prompt(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n),
                                                dtype=np.int32)


def _plans(cfg, kind, pages, kv_dtype="native"):
    """One grant lowered by both packages, with the SSD chunk lowered from
    it: (reference, port)."""
    kw = dict(seq_block=128, d_model=cfg.d_model, d_ff=cfg.d_ff,
              dtype_bytes=4, head_dim=cfg.hd, ssm_chunk=cfg.ssm_chunk,
              kv_dtype=kv_dtype)

    def sel(Candidate, Selection):
        return Selection(Candidate(kind=kind, p_need=pages, dram_bytes=0,
                                   flops=0, loops=(), cache_map=(),
                                   usage_limit_bytes=0), pages, 0.0)
    rp = rplan.lower_selection(sel(RCandidate, RSelection), pages, **kw)
    pp = pplan.lower_selection(sel(PCandidate, PSelection), pages, **kw)
    assert rp.describe() == pp.describe() and rp.ssm_chunk == pp.ssm_chunk
    assert pp.kind == kind
    return rp, pp


def _flat_ref_caches(rc, cfg):
    """The reference's caches (tuple of groups or stacked over groups) as
    the port's per-layer list of numpy dicts, in execution order."""
    G = RT.num_groups(cfg)
    groups = (list(rc) if isinstance(rc, tuple) else
              [jax.tree_util.tree_map(lambda a, g=g: a[g], rc)
               for g in range(G)])
    out = []
    for grp in groups:
        for j in range(cfg.attn_every - 1):
            out.append({k: np.asarray(v)[j] for k, v in grp["ssm"].items()})
        out.append({k: np.asarray(v) for k, v in grp["attn"].items()})
    return out


# ------------------------------------------------------------ params --
def test_bridge_carries_hybrid_params(zamba3):
    """``layers`` [G, attn_every - 1, ...] becomes one ``{"ssm": [...]}``
    dict per group, bit-exactly; ``shared_attn`` is one dense layer."""
    rcfg, pcfg, rparams, pparams = zamba3
    G, n_ssm = RT.num_groups(rcfg), rcfg.attn_every - 1
    assert len(pparams["layers"]) == G == 2
    for g, group in enumerate(pparams["layers"]):
        assert set(group) == {"ssm"} and len(group["ssm"]) == n_ssm == 2
        for j, layer in enumerate(group["ssm"]):
            for name in ("conv_w", "A_log", "D", "dt_bias"):
                np.testing.assert_array_equal(
                    layer["mamba"][name].numpy(),
                    np.asarray(rparams["layers"]["ssm"]["mamba"][name])[g, j])
            np.testing.assert_array_equal(
                layer["mamba"]["in_proj"]["w"].numpy(),
                np.asarray(rparams["layers"]["ssm"]["mamba"]["in_proj"]["w"])
                [g, j])
    assert set(pparams["shared_attn"]) == {"ln1", "attn", "ln2", "mlp"}
    np.testing.assert_array_equal(
        pparams["shared_attn"]["mlp"]["down"]["w"].numpy(),
        np.asarray(rparams["shared_attn"]["mlp"]["down"]["w"]))


@pytest.mark.parametrize("attn_every", [2, 3])
def test_init_lm_stores_the_shared_block_once(attn_every):
    """The port's random params have the reference's tree: per-group
    Mamba2 layers and one shared block, so the same number of
    parameters, leaf for leaf in shape and dtype."""
    rcfg, pcfg = _cfgs(attn_every=attn_every)
    ref = jax.tree_util.tree_map(np.asarray,
                                 RM.init_params(rcfg, jax.random.PRNGKey(0)))
    got = PM.init_params(pcfg, seed=0, device="cpu")
    flat = bridge.params_from_numpy(ref, pcfg, "cpu")
    shapes = lambda tree: [(tuple(x.shape), x.dtype)  # noqa: E731
                           for x in _leaves(tree)]
    assert shapes(got) == shapes(flat)
    assert sum(x.numel() for x in _leaves(got)) == sum(
        x.size for x in jax.tree_util.tree_leaves(ref))
    layers = list(PT._layers(got, pcfg))
    assert len(layers) == pcfg.num_layers
    shared = [lp for i, lp in enumerate(layers)
              if PT.is_attention_layer(pcfg, i)]
    assert all(lp is got["shared_attn"] for lp in shared)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("variant", ["full", "reduced", "attn_every3"])
def test_num_groups_equal_reference(variant):
    r, p = rbase.get_arch(ARCH), pbase.get_arch(ARCH)
    if variant != "full":
        r, p = r.reduced(), p.reduced()
    if variant == "attn_every3":
        r, p = (dataclasses.replace(c, attn_every=3) for c in (r, p))
    assert PT.num_groups(p) == RT.num_groups(r)
    assert PT.num_groups(pbase.get_arch(ARCH)) == 9
    with pytest.raises(ValueError):
        PT.num_groups(dataclasses.replace(p, num_layers=7))


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_init_caches_layout_matches_reference(kv_dtype):
    """One dict per layer in execution order: each group's Mamba2 states
    (never quantized), then its own K/V, the reference's leaves flattened
    group by group, in shape, dtype and value."""
    rcfg, pcfg = _cfgs(attn_every=3)
    rc = RT.init_caches(None, rcfg, B, MAX_LEN, kv_dtype=kv_dtype)
    pc = PT.init_caches(None, pcfg, B, MAX_LEN, kv_dtype=kv_dtype,
                        device="cpu")
    want = _flat_ref_caches(rc, rcfg)
    assert len(pc) == len(want) == pcfg.num_layers
    for i, (p, w) in enumerate(zip(pc, want)):
        assert set(p) == set(w)
        attn = PT.is_attention_layer(pcfg, i)
        assert ("k" in p) == attn and ("ssm" in p) == (not attn)
        for name in p:
            assert tuple(p[name].shape) == w[name].shape
            np.testing.assert_array_equal(
                p[name].float().numpy() if p[name].dtype != torch.int8
                else p[name].numpy(), w[name].astype(np.float32)
                if p[name].dtype != torch.int8 else w[name])


# ----------------------------------------------------------- forward --
@pytest.mark.parametrize("n", [40, 80], ids=["s40", "s80_past_window"])
@pytest.mark.parametrize("variant", ["zamba", "zamba3"])
def test_lm_forward_matches_reference(request, variant, n):
    """Logits within TOL, greedy tokens equal; at 80 tokens the 64-token
    sliding window binds."""
    rcfg, pcfg, rparams, pparams = request.getfixturevalue(variant)
    toks = _prompt(rcfg, n, seed=n)
    want, _ = RT.lm_forward(rparams, jnp.asarray(toks), rcfg)
    got, aux = PT.lm_forward(pparams, _t(toks).long(), pcfg)
    assert aux == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                  np.asarray(want).argmax(-1))


@pytest.mark.parametrize("serve", [False, True], ids=["default", "serve"])
def test_make_prefill_matches_reference(zamba, serve):
    rcfg, pcfg, rparams, pparams = zamba
    toks = _prompt(rcfg, 70, seed=3)
    want = RM.make_prefill(rcfg, serve=serve)(rparams,
                                              {"tokens": jnp.asarray(toks)})
    got = PM.make_prefill(pcfg, serve=serve)(pparams,
                                             {"tokens": _t(toks).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(
        PM.mask_padded_logits(got, pcfg).argmax(-1).numpy(),
        np.asarray(RM.mask_padded_logits(want, rcfg)).argmax(-1))


@pytest.mark.parametrize("kind, pages, kv", [("LBM", 4096, "native"),
                                             ("LWM", 2, "native"),
                                             ("LWM", 2, "int8")],
                         ids=["LBM", "LWM", "LWM_int8"])
def test_planned_prefill_matches_reference(zamba3, kind, pages, kv):
    """``make_prefill`` under a plan: the shared FFN through the granted
    kernel (fused LBM or tiled LWM), the Mamba2 layers at the plan's SSD
    chunk, against the reference's, whose Pallas kernels run in
    interpret mode; within TOL and equal to the plain path within TOL
    (the sliding window keeps the attention plain, so the int8 plan's KV
    precision reaches no kernel)."""
    rcfg, pcfg, rparams, pparams = zamba3
    rp, pp = _plans(rcfg, kind, pages, kv)
    toks = _prompt(rcfg, 64, seed=4)
    want = RM.make_prefill(rcfg)(rparams, {"tokens": jnp.asarray(toks)}, rp)
    got = PM.make_prefill(pcfg)(pparams, {"tokens": _t(toks).long()}, pp)
    plain = PM.make_prefill(pcfg)(pparams, {"tokens": _t(toks).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                  np.asarray(want).argmax(-1))


# ------------------------------------------------------------ decode --
@pytest.mark.parametrize("prompt_len", [40, 60],
                         ids=["p40", "p60_past_window"])
@pytest.mark.parametrize("variant", ["zamba", "zamba3"])
def test_decode_epoch_teacher_forced_matches_reference(request, ref_fns,
                                                       variant, prompt_len):
    """8 teacher-forced decode steps after a prefill, under an LWM plan
    (the shared FFN's GEMMs through cache_matmul): the port's
    ``decode_epoch`` against the reference's ``decode_step``, greedy
    tokens equal, logits and the recurrent states within TOL.  From a
    60-token prompt the steps cross the 64-token window."""
    rcfg, pcfg, rparams, pparams = request.getfixturevalue(variant)
    rdec, rpf = ref_fns
    rp, pp = _plans(rcfg, "LWM", 2)
    prompt = _prompt(rcfg, prompt_len)
    forced = _prompt(rcfg, 9, seed=2)
    rc = RT.init_caches(rparams, rcfg, B, MAX_LEN)
    _, rc = rpf(rparams, jnp.asarray(prompt), rc, jnp.int32(0), rcfg)
    want_tok, want_logits = [], []
    for i in range(8):
        rl, rc = rdec(rparams, jnp.asarray(forced[:, i:i + 1]), rc,
                      jnp.int32(prompt_len + i), rcfg, plan=rp)
        want_logits.append(np.asarray(rl)[:, -1])
        want_tok.append(np.asarray(RM._greedy_next_token(rcfg)(rl)))

    pc = PT.init_caches(pparams, pcfg, B, MAX_LEN, device="cpu")
    _, pc = PT.prefill_chunk(pparams, _t(prompt).long(), pc, 0, pcfg)
    greedy = PM._greedy_next_token(pcfg)
    forced_t = _t(forced).long()
    got_tok, got_logits = [], []

    def teacher(logits):
        got_logits.append(logits[:, -1].numpy())
        got_tok.append(greedy(logits).numpy())
        return forced_t[:, len(got_tok)]

    PT.decode_epoch(pparams, forced_t[:, :1], pc, prompt_len, pcfg, 8,
                    next_token_fn=teacher, plan=pp)
    np.testing.assert_array_equal(np.stack(got_tok), np.stack(want_tok))
    np.testing.assert_allclose(np.stack(got_logits), np.stack(want_logits),
                               **TOL)
    for got, want in zip(pc, _flat_ref_caches(rc, rcfg)):
        for name in ("ssm", "k"):
            if name in got:
                np.testing.assert_allclose(got[name].numpy(), want[name],
                                           **TOL)


@pytest.mark.parametrize("cuts", [(32,), (32, 64), (64,)],
                         ids=["32+40", "32+32+8", "64+8"])
def test_prefill_chunk_chunked_matches_one_shot(zamba, ref_fns, cuts):
    """A 72-token prompt (past the 64-token window) prefilled in chunks cut
    at SSD-chunk boundaries, the states and K/V carried, against one
    chunk of 72 and against the reference's chunked prefill: the last
    logits within TOL and the greedy token equal (not bitwise: chunked
    and one-shot sum in another order, as the reference's own caveat
    says)."""
    rcfg, pcfg, rparams, pparams = zamba
    _, rpf = ref_fns
    toks = _prompt(rcfg, 72, seed=5)
    one = PT.init_caches(pparams, pcfg, B, MAX_LEN, device="cpu")
    want, one = PT.prefill_chunk(pparams, _t(toks).long(), one, 0, pcfg)
    pc = PT.init_caches(pparams, pcfg, B, MAX_LEN, device="cpu")
    rc = RT.init_caches(rparams, rcfg, B, MAX_LEN)
    bounds = (0,) + cuts + (72,)
    for lo, hi in zip(bounds, bounds[1:]):
        got, pc = PT.prefill_chunk(pparams, _t(toks[:, lo:hi]).long(), pc, lo,
                                   pcfg)
        rl, rc = rpf(rparams, jnp.asarray(toks[:, lo:hi]), rc, jnp.int32(lo),
                     rcfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(rl), **TOL)
    greedy = PM._greedy_next_token(pcfg)
    assert torch.equal(greedy(got), greedy(want))
    assert torch.equal(greedy(got), greedy(torch.from_numpy(np.array(rl))))
    for a, b in zip(pc, one):
        for name in a:
            np.testing.assert_allclose(a[name].numpy(), b[name].numpy(),
                                       **TOL)


def test_epoch_matches_sequential_steps_bitwise(zamba3):
    """One 4-step epoch equals 4 decode steps, tokens and every cache
    leaf bitwise (test_serve_pipeline.py's contract)."""
    _, pcfg, _, pparams = zamba3
    _, pp = _plans(pcfg, "LWM", 2)
    token = torch.zeros((B, 1), dtype=torch.long)
    step = PM.make_decode_step(pcfg)
    caches = PT.init_caches(pparams, pcfg, B, 16, device="cpu")
    tok, want = token, []
    for i in range(4):
        nxt, caches = step(pparams, caches, tok, i, plan=pp)
        want.append(nxt)
        tok = nxt[:, None]
    fresh = PT.init_caches(pparams, pcfg, B, 16, device="cpu")
    toks, fresh = PM.make_decode_epoch(pcfg)(pparams, fresh, token, 0,
                                             plan=pp, k=4)
    assert torch.equal(toks, torch.stack(want, 1))
    for a, b in zip(caches, fresh):
        assert all(torch.equal(a[n], b[n]) for n in a)


# ------------------------------------------------------------ caches --
@pytest.mark.parametrize("layers", [6, 18], ids=["tuple_G3", "stacked_G9"])
def test_bridge_carries_reference_hybrid_caches(ref_fns, layers):
    """Both of the reference's cache forms carry over bit-exactly: a tuple
    of ``{"ssm", "attn"}`` groups (at most 8 groups) and one such dict
    stacked over groups (18 layers at ``attn_every`` 2: 9 groups); the
    port decodes from them as the reference does (logits within TOL)."""
    rcfg, pcfg, rparams, pparams = _model(seed=3, num_layers=layers)
    rdec, rpf = ref_fns
    rc = RT.init_caches(rparams, rcfg, B, MAX_LEN)
    assert isinstance(rc, tuple) == (layers == 6)
    _, rc = rpf(rparams, jnp.asarray(_prompt(rcfg, 24)), rc, jnp.int32(0),
                rcfg)
    pc = bridge.caches_from_numpy(jax.tree_util.tree_map(np.asarray, rc),
                                  pcfg, "cpu")
    want = _flat_ref_caches(rc, rcfg)
    assert len(pc) == layers
    for got, w in zip(pc, want):
        assert set(got) == set(w)
        for name in got:
            np.testing.assert_array_equal(got[name].numpy(), w[name])
    tok = _prompt(rcfg, 1, seed=7)
    want_l, _ = rdec(rparams, jnp.asarray(tok), rc, jnp.int32(24), rcfg)
    got_l, _ = PT.decode_step(pparams, _t(tok).long(), pc, 24, pcfg)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)


@pytest.mark.parametrize("n", [40, 2], ids=["p40", "p2_under_state_rows"])
@pytest.mark.parametrize("kv", [None, "int8", "fp8_e4m3"])
def test_seed_caches_from_prefix_equals_reference(zamba, ref_fns, kv, n):
    """A snapshot the reference's prefill filled (``n`` tokens), seeded by
    both packages at its full length: every K/V leaf's rows [0, n) and
    every recurrent leaf whole, bit-exactly, the rest as a fresh cache.
    At 2 tokens the prefix is shorter than the conv window's 3 rows and
    the state's 8 heads, which a row cut would truncate."""
    rcfg, pcfg, rparams, _ = zamba
    _, rpf = ref_fns
    rc = RT.init_caches(rparams, rcfg, B, MAX_LEN, kv_dtype=kv)
    _, rc = rpf(rparams, jnp.asarray(_prompt(rcfg, n)), rc, jnp.int32(0),
                rcfg)
    want = RT.seed_caches_from_prefix(rcfg, B, MAX_LEN, rc, n, kv_dtype=kv)
    snap = bridge.caches_from_numpy(jax.tree_util.tree_map(np.asarray, rc),
                                    pcfg, "cpu")
    got = PT.seed_caches_from_prefix(pcfg, B, MAX_LEN, snap, n, kv_dtype=kv)
    for g, w in zip(got, _flat_ref_caches(want, rcfg)):
        for name in g:
            leaf = g[name]
            if leaf.dtype in (torch.bfloat16, torch.float8_e4m3fn):
                leaf = leaf.view(torch.uint8 if leaf.element_size() == 1
                                 else torch.int16)
                w_name = w[name].view(np.uint8 if w[name].itemsize == 1
                                      else np.int16)
            else:
                w_name = w[name]
            np.testing.assert_array_equal(leaf.numpy(), w_name)


# ------------------------------------------------------- quantized KV --
@pytest.fixture(scope="module")
def quant_model():
    """tests/test_quant_decode.py's inputs: params of PRNGKey(0), a
    128-token prompt of PRNGKey(1), batch 1."""
    rcfg, pcfg, rparams, pparams = _model(seed=0)
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (1, 128), 0,
                                       rcfg.vocab_size))
    return rcfg, pcfg, rparams, pparams, toks


def _streams(step, prefill, init, kv_dtypes, toks, steps=8):
    """Teacher-forced logits [steps, V] per cache precision, all fed the
    native stream's greedy tokens (tests/test_quant_decode.py)."""
    n = toks.shape[1]
    streams = {}
    for kv in kv_dtypes:
        caches = init(kv)
        last, caches = prefill(toks, caches)
        streams[kv] = [caches, np.asarray(last)[:, -1], []]
    for i in range(steps):
        token = np.asarray(streams["native"][1]).argmax(-1)[:, None]
        for st in streams.values():
            logits, st[0] = step(token.astype(np.int32), st[0], n + i)
            st[1] = np.asarray(logits)[:, -1]
            st[2].append(st[1][0])
    return {kv: np.stack(st[2]).astype(np.float64)
            for kv, st in streams.items()}


@pytest.mark.parametrize("kv", ["int8", "fp8_e4m3"])
def test_quantized_kv_decode_within_reference_bars(quant_model, ref_fns, kv):
    """tests/test_quant_decode.py's hybrid case on the port and on its
    inputs: after a 128-token prompt, 8 teacher-forced steps with a
    ``kv`` cache against a native one fed the same tokens.  The bars of
    :data:`QUANT_MIN_COS` / :data:`QUANT_MAX_ERR` (the reference holds
    its int8 cache to them); fp8_e4m3, 3 mantissa bits, reaches a larger
    error in the reference itself on these inputs (0.557), so the fp8
    stream's error is held to the larger of the bar and the reference's
    own.  Each of the port's streams within TOL of the reference's."""
    rcfg, pcfg, rparams, pparams, toks = quant_model
    rdec, rpf = ref_fns
    kvs = ("native", kv)
    port = _streams(
        lambda tok, c, i: PT.decode_step(pparams, _t(tok).long(), c, i, pcfg),
        lambda tk, c: PT.prefill_chunk(pparams, _t(tk).long(), c, 0, pcfg),
        lambda k: PT.init_caches(pparams, pcfg, 1, 136, kv_dtype=k,
                                 device="cpu"), kvs, toks)
    ref = _streams(
        lambda tok, c, i: rdec(rparams, jnp.asarray(tok), c, jnp.int32(i),
                               rcfg),
        lambda tk, c: rpf(rparams, jnp.asarray(tk), c, jnp.int32(0), rcfg),
        lambda k: RT.init_caches(rparams, rcfg, 1, 136, kv_dtype=k), kvs,
        toks)
    for name in kvs:
        np.testing.assert_allclose(port[name], ref[name], **TOL)
    bar = max(QUANT_MAX_ERR, float(np.abs(ref["native"] - ref[kv]).max()))
    if kv == "int8":
        assert bar == QUANT_MAX_ERR
    for a, b in zip(port["native"], port[kv]):
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
        assert cos >= QUANT_MIN_COS, cos
        assert np.abs(a - b).max() <= bar, (np.abs(a - b).max(), bar)


# ----------------------------------------------------------- routing --
def test_full_width_shapes_route_to_the_hopper_kinds():
    """At full width, bf16, the H100's shared memory: the shared FFN's
    decode GEMMs (2 rows at K / N 2560 and 10240) take cache_matmul's gemv
    tile and its prefill GEMMs (2048 rows) the wgmma tile under the LWM
    grants; the fused FFN at 2048 rows takes block_fused_ffn's wgmma tile
    under every LBM grant up to the widest block (the 2-row decode its
    gemv tile); ssd_chunk at N 64, P 64 its wgmma kind (fp32: simt)."""
    cfg = pbase.get_arch(ARCH)
    d, f, bf16 = cfg.d_model, cfg.d_ff, torch.bfloat16
    assert (d, f, cfg.ssm_state, cfg.ssm_head_dim) == (2560, 10240, 64, 64)
    for pages in (2, 32, 200):
        lwm = pplan.lower_ffn(LANE, d, f, 2, pages, want_fused=False)
        for m, kind in ((2, "gemv"), (2048, "wgmma")):
            for tile, k, n in ((lwm.up_tile, d, f), (lwm.down_tile, f, d)):
                got = ops.legalize_matmul_tile(tile, m, H100_SMEM, bf16, k, n)
                assert got.kind == kind, (pages, m, k, n, got)
                assert got.smem_bytes <= H100_SMEM
    for pages in (288, 324, 1184, 3072):
        lbm = pplan.lower_ffn(1024, d, f, 2, pages, want_fused=True)
        assert lbm.fused, pages
        tile = ops.legalize_ffn_tile(lbm.block_s, lbm.block_f, 2048,
                                     H100_SMEM, bf16, d, f)
        assert tile.kind == "wgmma" and tile.smem_bytes <= H100_SMEM
        assert ops.legalize_ffn_tile(lbm.block_s, lbm.block_f, 2, H100_SMEM,
                                     bf16, d, f).kind == "gemv"
    assert pplan.lower_ffn(1024, d, f, 2, 1184, True).block_f == 1024
    assert ops.ssd_kind(bf16, cfg.ssm_state, cfg.ssm_head_dim) == "wgmma"
    assert ops.ssd_kind(torch.float32, cfg.ssm_state,
                        cfg.ssm_head_dim) == "simt"
