"""The port's SSM family (Mamba2 / SSD) against the JAX package's, at the
reduced mamba2-370m config (fp32), with the reference's params and
caches handed over through ``repro_torch.bridge``.  Inputs come from
numpy and go to both sides.

* ``ssd_chunk``: the port's plain version (which the wrapper runs on the
  CPU) against the reference's Pallas kernel in interpret mode, as
  tests/test_kernels.py::test_ssd_chunk runs it, and against its
  ``ssd_chunk_ref``, at that test's tolerance (rtol = atol = 1e-3).
* ``ssd``, ``_causal_conv``, ``mamba2_forward``, ``ssd_decode_step`` and
  the model entry points: within rtol = atol = 2e-3.  The reference casts
  the intra-chunk weights to x's dtype before contracting them and the
  port's kernel keeps fp32; in fp32 the two differ only in the order of
  summation.  Greedy tokens must be equal.
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
from repro.kernels import ref as rref
from repro.kernels.ssd_scan import ssd_chunk as ref_ssd_chunk
from repro.models import base as rbase
from repro.models import model as RM
from repro.models import ssm as RS
from repro.models import transformer as RT
from repro_torch import bridge
from repro_torch.core import plan as pplan
from repro_torch.core.allocator import Selection as PSelection
from repro_torch.core.mct import MappingCandidate as PCandidate
from repro_torch.kernels import ops
from repro_torch.kernels import ref as pref
from repro_torch.kernels import ssd_scan as kssd
from repro_torch.models import base as pbase
from repro_torch.models import model as PM
from repro_torch.models import ssm as PS
from repro_torch.models import transformer as PT

KTOL = dict(rtol=1e-3, atol=1e-3)     # tests/test_kernels.py::test_ssd_chunk
TOL = dict(rtol=2e-3, atol=2e-3)
B, MAX_LEN = 2, 64


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _chunk_inputs(BH, S, P, N, seed, G=None):
    """x, dt (softplus of a normal), A (|normal| + 0.1), B, C [G, S, N]."""
    rng = np.random.default_rng(seed)
    G = BH if G is None else G
    x = rng.standard_normal((BH, S, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((BH, S)))).astype(np.float32)
    A = (np.abs(rng.standard_normal(BH)) + 0.1).astype(np.float32)
    Bm = rng.standard_normal((G, S, N)).astype(np.float32)
    Cm = rng.standard_normal((G, S, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


# ---------------------------------------------------------- ssd_chunk --
@pytest.mark.parametrize("S,P,N,chunk", [(64, 16, 8, 16), (66, 16, 8, 22)],
                         ids=["test_ssd_chunk", "ragged_q22"])
def test_ssd_chunk_plain_matches_reference_kernel(S, P, N, chunk):
    x, dt, A, Bm, Cm = _chunk_inputs(4, S, P, N, seed=0)
    want_y, want_s = ref_ssd_chunk(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                                   chunk)
    oracle_y, oracle_s = rref.ssd_chunk_ref(
        *map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk)
    got_y, got_s = kssd.ssd_chunk(*map(_t, (x, dt, A, Bm, Cm)), chunk)
    assert got_y.dtype == got_s.dtype == torch.float32
    assert got_s.shape == (4, S // chunk, N, P)
    for want, oracle, got in ((want_y, oracle_y, got_y),
                              (want_s, oracle_s, got_s)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **KTOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **KTOL)
    plain = pref.ssd_chunk_ref(*map(_t, (x, dt, A, Bm, Cm)), chunk)
    assert torch.equal(plain[0], got_y) and torch.equal(plain[1], got_s)


@pytest.mark.parametrize("chunk", [16, 1, 48])
def test_ssd_chunk_per_batch_row_equals_broadcast_bitwise(chunk):
    """B and C given once per batch row (the model's layout, the kernel's
    ``bh // heads`` map) equal the reference's broadcast layout."""
    b, h = 2, 3
    x, dt, A, Bm, Cm = _chunk_inputs(b * h, 48, 16, 8, seed=1, G=b)
    per_row = kssd.ssd_chunk(*map(_t, (x, dt, A, Bm, Cm)), chunk)
    wide = kssd.ssd_chunk(_t(x), _t(dt), _t(A),
                          _t(np.repeat(Bm, h, axis=0)),
                          _t(np.repeat(Cm, h, axis=0)), chunk)
    assert torch.equal(per_row[0], wide[0])
    assert torch.equal(per_row[1], wide[1])
    via_ops = ops.ssd_intra_chunk(*map(_t, (x, dt, A, Bm, Cm)), chunk)
    assert torch.equal(via_ops[0], wide[0])


def test_ssd_chunk_bf16_inputs_give_fp32_outputs():
    x, dt, A, Bm, Cm = map(_t, _chunk_inputs(4, 32, 16, 8, seed=2))
    y, s = kssd.ssd_chunk(x.bfloat16(), dt, A, Bm.bfloat16(), Cm.bfloat16(),
                          16)
    want = kssd.ssd_chunk_plain(x.bfloat16().float(), dt, A,
                                Bm.bfloat16().float(), Cm.bfloat16().float(),
                                16)
    assert y.dtype == s.dtype == torch.float32
    assert torch.equal(y, want[0]) and torch.equal(s, want[1])


@pytest.mark.parametrize("bad", ["chunk_not_dividing", "chunk_too_long",
                                 "dtype_mix", "dt_bf16", "heads_not_dividing"])
def test_ssd_chunk_rejects_malformed_operands(bad):
    x, dt, A, Bm, Cm = map(_t, _chunk_inputs(4, 512, 16, 8, seed=3))
    chunk = 16
    if bad == "chunk_not_dividing":
        chunk = 24
    elif bad == "chunk_too_long":
        chunk = 512
    elif bad == "dtype_mix":
        Bm = Bm.bfloat16()
    elif bad == "dt_bf16":
        dt = dt.bfloat16()
    else:
        Bm, Cm = Bm[:3], Cm[:3]
    with pytest.raises((ValueError, TypeError)):
        kssd.ssd_chunk(x, dt, A, Bm, Cm, chunk)


def test_smem_bytes_fit_the_h100_at_every_compiled_head_dim():
    """The launch's shared memory (full width N 128; N 256 as headroom)
    stays within the H100's 232,448 bytes a block for every head dim."""
    for p in kssd.HEAD_DIMS:
        assert kssd.smem_bytes(256, p) <= 232_448
    assert kssd.smem_bytes(128, 64) == 101_632


# --------------------------------------------------------------- ssd --
def _ssd_inputs(b, s, h, p, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = np.linspace(1.0, 4.0, h).astype(np.float32)
    Bm = rng.standard_normal((b, s, n)).astype(np.float32)
    Cm = rng.standard_normal((b, s, n)).astype(np.float32)
    D = rng.standard_normal(h).astype(np.float32)
    h0 = rng.standard_normal((b, h, n, p)).astype(np.float32)
    return x, dt, A, Bm, Cm, D, h0


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero_h0", "h0"])
@pytest.mark.parametrize("s,chunk", [(64, 16), (64, 64), (44, 44), (96, 32)])
def test_ssd_matches_reference(s, chunk, with_h0):
    x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(2, s, 3, 16, 8, seed=s + chunk)
    h0 = h0 if with_h0 else None
    want_y, want_h = RS.ssd(*map(jnp.asarray, (x, dt, A, Bm, Cm, D)), chunk,
                            None if h0 is None else jnp.asarray(h0))
    got_y, got_h = PS.ssd(*map(_t, (x, dt, A, Bm, Cm, D)), chunk,
                          None if h0 is None else _t(h0))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)
    assert got_h.dtype == torch.float32


def test_ssd_rejects_a_chunk_that_does_not_divide():
    x, dt, A, Bm, Cm, D, _ = map(_t, _ssd_inputs(1, 40, 2, 16, 8, seed=0))
    with pytest.raises(ValueError):
        PS.ssd(x, dt, A, Bm, Cm, D, 16)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((PS.CONV_K, 12)).astype(np.float32)
    st = (rng.standard_normal((2, PS.CONV_K - 1, 12)).astype(np.float32)
          if with_state else None)
    want_y, want_s = RS._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                     None if st is None else jnp.asarray(st))
    got_y, got_s = PS._causal_conv(_t(x), _t(w),
                                   None if st is None else _t(st))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


# -------------------------------------------------------------- model --
@pytest.fixture(scope="module")
def mamba():
    rcfg = rbase.get_arch("mamba2-370m").reduced()
    pcfg = pbase.get_arch("mamba2-370m").reduced()
    rparams = RM.init_params(rcfg, jax.random.PRNGKey(1))
    pparams = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, rparams), pcfg, "cpu")
    return rcfg, pcfg, rparams, pparams


@pytest.fixture(scope="module")
def ref_fns():
    return (jax.jit(RT.decode_step, static_argnames=("cfg", "plan", "kv_len")),
            jax.jit(RT.prefill_chunk, static_argnames=("cfg", "kv_len")))


def _prompt(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n),
                                                dtype=np.int32)


def _hidden(cfg, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, s, cfg.d_model)).astype(np.float32)


def _plans(cfg, pages):
    """One LBM grant of ``pages`` lowered by both packages, with the SSD
    chunk lowered from it: (reference, port)."""
    kw = dict(seq_block=32, d_model=cfg.d_model,
              d_ff=max(cfg.d_ff, cfg.d_model), dtype_bytes=4,
              head_dim=cfg.hd, ssm_chunk=cfg.ssm_chunk)

    def sel(Candidate, Selection):
        return Selection(Candidate(kind="LBM", p_need=8, dram_bytes=0,
                                   flops=0, loops=(), cache_map=(),
                                   usage_limit_bytes=0), 8, 0.0)
    rp = rplan.lower_selection(sel(RCandidate, RSelection), pages, **kw)
    pp = pplan.lower_selection(sel(PCandidate, PSelection), pages, **kw)
    assert rp.describe() == pp.describe() and rp.ssm_chunk == pp.ssm_chunk
    return rp, pp


def test_bridge_splits_the_ssm_layer_stack(mamba):
    rcfg, pcfg, rparams, pparams = mamba
    assert len(pparams["layers"]) == rcfg.num_layers
    for g, layer in enumerate(pparams["layers"]):
        assert set(layer) == {"ln1", "mamba"}
        assert set(layer["mamba"]) == {"in_proj", "conv_w", "A_log", "D",
                                       "dt_bias", "out_proj"}
        for name in ("conv_w", "A_log", "D", "dt_bias"):
            np.testing.assert_array_equal(
                layer["mamba"][name].numpy(),
                np.asarray(rparams["layers"]["mamba"][name])[g])
        np.testing.assert_array_equal(
            layer["mamba"]["in_proj"]["w"].numpy(),
            np.asarray(rparams["layers"]["mamba"]["in_proj"]["w"])[g])


@pytest.mark.parametrize("with_state", [False, True],
                         ids=["no_state", "state"])
@pytest.mark.parametrize("s,chunk", [(64, None), (64, 16), (64, 24), (70, None),
                                     (70, 16), (6, None)],
                         ids=["s64", "s64_plan16", "s64_plan24_ignored",
                              "s70_tail6", "s70_plan16_ignored", "s6_tail_only"])
def test_mamba2_forward_matches_reference(mamba, s, chunk, with_state):
    """The plan's chunk applies only where it divides s; a sequence not a
    multiple of the chunk runs its tail as one final chunk, carrying the
    state across."""
    rcfg, pcfg, rparams, pparams = mamba
    rp = jax.tree_util.tree_map(lambda a: a[0], rparams["layers"]["mamba"])
    pp = pparams["layers"][0]["mamba"]
    x = _hidden(rcfg, s, seed=s)
    rstate = pstate = None
    if with_state:
        rng = np.random.default_rng(9)
        conv = rng.standard_normal((B, PS.CONV_K - 1, rcfg.d_inner
                                    + 2 * rcfg.ssm_state)).astype(np.float32)
        ssm = rng.standard_normal((B, rcfg.ssm_heads, rcfg.ssm_state,
                                   rcfg.ssm_head_dim)).astype(np.float32)
        rstate = {"conv": jnp.asarray(conv), "ssm": jnp.asarray(ssm)}
        pstate = {"conv": _t(conv), "ssm": _t(ssm)}
    want, wst = RS.mamba2_forward(rp, jnp.asarray(x), rcfg, rstate,
                                  chunk=chunk)
    got, gst = PS.mamba2_forward(pp, _t(x), pcfg, pstate, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(gst[name].numpy(), np.asarray(wst[name]),
                                   **TOL)


def test_ssd_decode_step_matches_reference(mamba):
    rcfg, pcfg, rparams, pparams = mamba
    rp = jax.tree_util.tree_map(lambda a: a[0], rparams["layers"]["mamba"])
    pp = pparams["layers"][0]["mamba"]
    rst = RS.init_ssm_state(rcfg, B)
    pst = PS.init_ssm_state(pcfg, B, "cpu")
    for i in range(4):
        x = _hidden(rcfg, 1, seed=20 + i)
        want, rst = RS.ssd_decode_step(rp, jnp.asarray(x), rcfg, rst)
        got, pst = PS.ssd_decode_step(pp, _t(x), pcfg, pst)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(pst["ssm"].numpy(), np.asarray(rst["ssm"]),
                                   **TOL)
        np.testing.assert_allclose(pst["conv"].numpy(),
                                   np.asarray(rst["conv"]), **TOL)
        assert pst["conv"].dtype == pcfg.torch_dtype
        assert pst["ssm"].dtype == torch.float32


@pytest.mark.parametrize("n", [32, 40])
@pytest.mark.parametrize("pages", [None, 4096, 2], ids=["plain", "lbm4096p",
                                                        "lbm2p"])
def test_lm_forward_matches_reference(mamba, n, pages):
    """Mirrors tests/test_plan.py::test_prefill_through_plan_matches_reference
    [mamba2-370m]: plain and under a plan, against the reference."""
    rcfg, pcfg, rparams, pparams = mamba
    rp, pp = _plans(rcfg, pages) if pages else (None, None)
    toks = _prompt(rcfg, n)
    want, _ = RT.lm_forward(rparams, jnp.asarray(toks), rcfg, plan=rp)
    got, _ = PT.lm_forward(pparams, _t(toks).long(), pcfg, plan=pp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                  np.asarray(want).argmax(-1))


def test_make_prefill_matches_reference(mamba):
    rcfg, pcfg, rparams, pparams = mamba
    rp, pp = _plans(rcfg, 4096)
    toks = _prompt(rcfg, 40, seed=3)
    for r, p in ((None, None), (rp, pp)):
        want = RM.make_prefill(rcfg)(rparams, {"tokens": jnp.asarray(toks)}, r)
        got = PM.make_prefill(pcfg)(pparams, {"tokens": _t(toks).long()}, p)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_array_equal(
            PM.mask_padded_logits(got, pcfg).argmax(-1).numpy(),
            np.asarray(RM.mask_padded_logits(want, rcfg)).argmax(-1))


def test_decode_epoch_teacher_forced_matches_reference(mamba, ref_fns):
    """8 decode steps from a prefilled state: the port's ``decode_epoch``
    fed the same tokens as the reference's ``decode_step`` gives the
    same greedy tokens and matching logits; the plan changes nothing for
    SSM decode."""
    rcfg, pcfg, rparams, pparams = mamba
    rdec, rpf = ref_fns
    _, pp = _plans(rcfg, 4096)
    prompt = _prompt(rcfg, 40)
    forced = _prompt(rcfg, 9, seed=2)
    rc = RT.init_caches(rparams, rcfg, B, MAX_LEN)
    _, rc = rpf(rparams, jnp.asarray(prompt), rc, jnp.int32(0), rcfg)
    want_tok, want_logits = [], []
    for i in range(8):
        rl, rc = rdec(rparams, jnp.asarray(forced[:, i:i + 1]), rc,
                      jnp.int32(40 + i), rcfg)
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

    PT.decode_epoch(pparams, forced_t[:, :1], pc, 40, pcfg, 8,
                    next_token_fn=teacher, plan=pp)
    np.testing.assert_array_equal(np.stack(got_tok), np.stack(want_tok))
    np.testing.assert_allclose(np.stack(got_logits), np.stack(want_logits),
                               **TOL)
    for g in range(rcfg.num_layers):
        np.testing.assert_allclose(pc[g]["ssm"].numpy(),
                                   np.asarray(rc[g]["ssm"]), **TOL)


@pytest.mark.parametrize("cuts", [(32,), (32, 64), (64,)],
                         ids=["32+40", "32+32+8", "64+8"])
def test_prefill_chunk_state_carry_matches_one_shot(mamba, ref_fns, cuts):
    """A 72-token prompt prefilled in chunks cut at SSD-chunk boundaries,
    the state carried across, against one chunk of 72: the last logits
    within tolerance and the greedy token equal (and both against the
    reference's chunked prefill)."""
    rcfg, pcfg, rparams, pparams = mamba
    _, rpf = ref_fns
    toks = _prompt(rcfg, 72, seed=5)
    one = PT.init_caches(pparams, pcfg, B, MAX_LEN + 16, device="cpu")
    want, one = PT.prefill_chunk(pparams, _t(toks).long(), one, 0, pcfg)
    pc = PT.init_caches(pparams, pcfg, B, MAX_LEN + 16, device="cpu")
    rc = RT.init_caches(rparams, rcfg, B, MAX_LEN + 16)
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
    for g in range(rcfg.num_layers):
        np.testing.assert_allclose(pc[g]["ssm"].numpy(), one[g]["ssm"].numpy(),
                                   **TOL)
        assert torch.equal(pc[g]["conv"], one[g]["conv"])


def test_epoch_matches_sequential_steps_bitwise(mamba):
    """Mirrors test_serve_pipeline.py::test_epoch_scan_matches_sequential:
    one K-step epoch equals K decode steps, tokens and states bitwise."""
    _, pcfg, _, pparams = mamba
    token = torch.zeros((B, 1), dtype=torch.long)
    step = PM.make_decode_step(pcfg)
    caches = PT.init_caches(pparams, pcfg, B, 16, device="cpu")
    tok, want = token, []
    for i in range(4):
        nxt, caches = step(pparams, caches, tok, i)
        want.append(nxt)
        tok = nxt[:, None]
    epoch = PM.make_decode_epoch(pcfg)
    fresh = PT.init_caches(pparams, pcfg, B, 16, device="cpu")
    toks, fresh = epoch(pparams, fresh, token, 0, k=4)
    assert torch.equal(toks, torch.stack(want, 1))
    for a, b in zip(caches, fresh):
        assert torch.equal(a["ssm"], b["ssm"]) and torch.equal(a["conv"],
                                                               b["conv"])


@pytest.mark.parametrize("layers", [2, 10], ids=["tuple", "stacked"])
def test_bridge_carries_reference_ssm_caches(layers, ref_fns):
    """Both of the reference's cache layouts (a tuple per group for at
    most 8 groups, stacked leaves above) carry over bit-exactly, and the
    port decodes from them as the reference does."""
    rcfg = dataclasses.replace(rbase.get_arch("mamba2-370m").reduced(),
                               num_layers=layers)
    pcfg = dataclasses.replace(pbase.get_arch("mamba2-370m").reduced(),
                               num_layers=layers)
    rdec, rpf = ref_fns
    rparams = RM.init_params(rcfg, jax.random.PRNGKey(2))
    pparams = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, rparams), pcfg, "cpu")
    rc = RT.init_caches(rparams, rcfg, B, MAX_LEN)
    assert isinstance(rc, tuple) == (layers <= 8)
    _, rc = rpf(rparams, jnp.asarray(_prompt(rcfg, 24)), rc, jnp.int32(0),
                rcfg)
    pc = bridge.caches_from_numpy(jax.tree_util.tree_map(np.asarray, rc),
                                  pcfg, "cpu")
    assert len(pc) == layers
    for g in range(layers):
        for name in ("conv", "ssm"):
            ref_leaf = (rc[g][name] if isinstance(rc, tuple)
                        else rc[name][g])
            np.testing.assert_array_equal(pc[g][name].numpy(),
                                          np.asarray(ref_leaf))
    tok = _prompt(rcfg, 1, seed=7)
    want, _ = rdec(rparams, jnp.asarray(tok), rc, jnp.int32(24), rcfg)
    got, _ = PT.decode_step(pparams, _t(tok).long(), pc, 24, pcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_caches_match_reference_structure(dtype):
    """One state dict per layer: the conv window in the compute dtype,
    the SSM state in fp32, never quantized."""
    rcfg = dataclasses.replace(rbase.get_arch("mamba2-370m").reduced(),
                               dtype=dtype)
    pcfg = dataclasses.replace(pbase.get_arch("mamba2-370m").reduced(),
                               dtype=dtype)
    rc = RT.init_caches(None, rcfg, B, MAX_LEN, kv_dtype="int8")
    pc = PT.init_caches(None, pcfg, B, MAX_LEN, kv_dtype="int8",
                        device="cpu")
    assert len(pc) == len(rc)
    for r, p in zip(rc, pc):
        assert set(p) == set(r) == {"conv", "ssm"}
        for name in ("conv", "ssm"):
            assert tuple(p[name].shape) == r[name].shape
            assert str(p[name].dtype).removeprefix("torch.") == \
                str(r[name].dtype)
            assert not bool(p[name].any())


# --------------------------------------------------------------- bf16 --
# The reference rounds the intra-chunk weights w = (C B^T) * L * dt and
# decay_out * dt to x's dtype before its contractions; the port's SSD
# scan is held to it in bf16 at the model rule of the logits gates: max
# |difference| within 2e-2 of the largest reference |y|.
BF16_REL = 2e-2


def _rel_err(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max() / np.abs(want).max())


def _bf16_pair(a):
    """One fp32 numpy array as a JAX and a torch bf16 array (both round
    to nearest even)."""
    return (jnp.asarray(a).astype(jnp.bfloat16),
            torch.from_numpy(a).to(torch.bfloat16))


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero_h0", "h0"])
@pytest.mark.parametrize("s,chunk", [(64, 16), (96, 32), (44, 44)])
def test_ssd_bf16_matches_reference(s, chunk, with_h0):
    """x, B and C in bf16 (dt, A, D and the state in fp32, as
    mamba2_forward passes them)."""
    x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(2, s, 3, 16, 8, seed=s + chunk)
    (xj, xt), (bj, bt), (cj, ct) = map(_bf16_pair, (x, Bm, Cm))
    want_y, want_h = RS.ssd(xj, jnp.asarray(dt), jnp.asarray(A), bj, cj,
                            jnp.asarray(D), chunk,
                            jnp.asarray(h0) if with_h0 else None)
    got_y, got_h = PS.ssd(xt, _t(dt), _t(A), bt, ct, _t(D), chunk,
                          _t(h0) if with_h0 else None)
    assert got_y.dtype == torch.bfloat16 and got_h.dtype == torch.float32
    assert _rel_err(got_y.float(), want_y.astype(jnp.float32)) <= BF16_REL
    assert _rel_err(got_h, want_h) <= BF16_REL


@pytest.fixture(scope="module")
def mamba_bf16():
    rcfg = dataclasses.replace(rbase.get_arch("mamba2-370m").reduced(),
                               dtype="bfloat16")
    pcfg = dataclasses.replace(pbase.get_arch("mamba2-370m").reduced(),
                               dtype="bfloat16")
    rparams = RM.init_params(rcfg, jax.random.PRNGKey(1))
    pparams = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, rparams), pcfg, "cpu")
    return rcfg, pcfg, rparams, pparams


@pytest.mark.parametrize("s,chunk", [(64, None), (64, 16), (70, None)],
                         ids=["s64", "s64_plan16", "s70_tail6"])
def test_mamba2_forward_bf16_matches_reference(mamba_bf16, s, chunk):
    """The reduced mamba2 block in bf16, weights bridged from the
    reference's: the block output within 2e-2 of its largest reference
    value, and the carried SSM state likewise."""
    rcfg, pcfg, rparams, pparams = mamba_bf16
    rp = jax.tree_util.tree_map(lambda a: a[0], rparams["layers"]["mamba"])
    pp = pparams["layers"][0]["mamba"]
    assert pp["in_proj"]["w"].dtype == torch.bfloat16
    xj, xt = _bf16_pair(_hidden(rcfg, s, seed=s))
    want, wst = RS.mamba2_forward(rp, xj, rcfg, None, chunk=chunk)
    got, gst = PS.mamba2_forward(pp, xt, pcfg, None, chunk=chunk)
    assert got.dtype == torch.bfloat16
    assert _rel_err(got.float(), want.astype(jnp.float32)) <= BF16_REL
    assert _rel_err(gst["ssm"], wst["ssm"]) <= BF16_REL
