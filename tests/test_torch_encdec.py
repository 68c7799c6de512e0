"""The port's encoder-decoder family (Whisper-style: a bidirectional
encoder over audio-frame embeddings and a decoder whose layers add a
cross-attention block over the encoder output) against the JAX
package's, at the reduced whisper-tiny config (fp32: 2 encoder and 2
decoder layers, d_model 128, 16 frames), with the reference's params
handed over through ``repro_torch.bridge``.  Inputs come from numpy and
go to both sides.

Tolerance: atol = rtol = 1e-4, the dense family's
(tests/test_torch_model.py: fp32 with sums taken in another order than
XLA's); teacher-forced greedy tokens must be equal; the bridge is
bit-exact.  Plan-lowered prefill runs the reference's Pallas kernels in
interpret mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as rplan
from repro.core.allocator import Selection as RSelection
from repro.core.mct import MappingCandidate as RCandidate
from repro.models import attention as RA
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

ATOL = RTOL = 1e-4                      # tests/test_torch_model.py:33
ARCH = "whisper-tiny"
B, MAX_LEN = 2, 64


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def whisper():
    rcfg = rbase.get_arch(ARCH).reduced()
    pcfg = pbase.get_arch(ARCH).reduced()
    rparams = RM.init_params(rcfg, jax.random.PRNGKey(1))
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    pparams = bridge.params_from_numpy(tree, pcfg, "cpu")
    return rcfg, pcfg, rparams, pparams, tree


@pytest.fixture(scope="module")
def ref_fns():
    return (jax.jit(RT.decode_step, static_argnames=("cfg", "plan", "kv_len")),
            jax.jit(RT.prefill_chunk, static_argnames=("cfg", "kv_len")))


def _prompt(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n),
                                                dtype=np.int32)


def _frames(cfg, seed=0):
    """Frame embeddings [B, enc_len, d] (the stub frontend's output)."""
    return np.random.default_rng(100 + seed).standard_normal(
        (B, cfg.enc_len, cfg.d_model)).astype(np.float32)


def _plans(cfg, kind, kv_dtype="native"):
    """One grant lowered by both packages: (reference, port)."""
    pages = 4096 if kind == "LBM" else 2
    kw = dict(seq_block=128, d_model=cfg.d_model, d_ff=cfg.d_ff,
              dtype_bytes=4, head_dim=cfg.hd, kv_dtype=kv_dtype)

    def sel(Candidate, Selection):
        return Selection(Candidate(kind=kind, p_need=pages, dram_bytes=0,
                                   flops=0, loops=(), cache_map=(),
                                   usage_limit_bytes=0), pages, 0.0)
    rp = rplan.lower_selection(sel(RCandidate, RSelection), pages, **kw)
    pp = pplan.lower_selection(sel(PCandidate, PSelection), pages, **kw)
    assert rp.describe() == pp.describe() and pp.kind == kind
    return rp, pp


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


# ------------------------------------------------------------ params --
def test_bridge_carries_encoder_and_xattn(whisper):
    """``encoder.layers`` (stacked over enc_layers) and ``xattn`` (stacked
    over the decoder layers) become per-layer lists, bit-exactly."""
    rcfg, _, _, pparams, tree = whisper
    enc = pparams["encoder"]
    assert len(enc["layers"]) == rcfg.enc_layers == 2
    assert len(pparams["xattn"]) == len(pparams["layers"]) == rcfg.num_layers
    for g, layer in enumerate(enc["layers"]):
        for name in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(
                layer["attn"][name]["w"].numpy(),
                tree["encoder"]["layers"]["attn"][name]["w"][g])
        np.testing.assert_array_equal(
            layer["mlp"]["down"]["w"].numpy(),
            tree["encoder"]["layers"]["mlp"]["down"]["w"][g])
    np.testing.assert_array_equal(enc["final_norm"]["scale"].numpy(),
                                  tree["encoder"]["final_norm"]["scale"])
    for g, xp in enumerate(pparams["xattn"]):
        assert set(xp) == {"ln", "attn"}
        np.testing.assert_array_equal(xp["ln"]["scale"].numpy(),
                                      tree["xattn"]["ln"]["scale"][g])
        for name in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(xp["attn"][name]["w"].numpy(),
                                          tree["xattn"]["attn"][name]["w"][g])


def test_init_lm_has_the_reference_tree(whisper):
    """The port's own random params have the reference's tree, layer for
    layer, with the reference's shapes."""
    rcfg, pcfg, _, pparams, _ = whisper
    own = PM.init_params(pcfg, seed=3, device="cpu")

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return tuple(t.shape)
    assert shapes(own) == shapes(pparams)


def test_bridge_carries_encdec_caches(whisper):
    """The reference's encdec decode caches (the decoder's self-attention
    K/V, a tuple of groups) become the port's per-layer dicts."""
    rcfg, pcfg, rparams, _, _ = whisper
    rc = RT.init_caches(rparams, rcfg, B, MAX_LEN)
    rc = tuple({k: v + i for k, v in c.items()} for i, c in enumerate(rc))
    pc = bridge.caches_from_numpy(
        jax.tree_util.tree_map(np.asarray, rc), pcfg, "cpu")
    assert len(pc) == rcfg.num_layers
    for g, c in enumerate(pc):
        assert set(c) == {"k", "v"}
        np.testing.assert_array_equal(c["k"].numpy(), np.asarray(rc[g]["k"]))


# ---------------------------------------------------------- modules --
def test_mha_cross_attention_matches_reference(whisper):
    """q from the decoder stream, K/V projected from the encoder output,
    no RoPE, no mask, no cache."""
    rcfg, pcfg, rparams, pparams, _ = whisper
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, 5, rcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, rcfg.enc_len, rcfg.d_model)
                              ).astype(np.float32)
    rattn = jax.tree_util.tree_map(lambda a: a[0], rparams["xattn"]["attn"])
    want, rcache = RA.mha(rattn, jnp.asarray(x), rcfg, causal=False,
                          xattn_kv=jnp.asarray(enc))
    got, pcache = PA.mha(pparams["xattn"][0]["attn"], _t(x), pcfg,
                         causal=False, xattn_kv=_t(enc))
    assert rcache is None and pcache is None
    _close(got, want)
    # positions do not enter cross-attention: shifting them changes nothing
    shifted, _ = PA.mha(pparams["xattn"][0]["attn"], _t(x), pcfg,
                        positions=torch.arange(5)[None] + 7, causal=False,
                        xattn_kv=_t(enc))
    assert torch.equal(shifted, got)


def test_encode_matches_reference(whisper):
    rcfg, pcfg, rparams, pparams, _ = whisper
    frames = _frames(rcfg)
    want = RT.encode(rparams, jnp.asarray(frames), rcfg)
    got = PT.encode(pparams, _t(frames), pcfg)
    assert got.shape == (B, rcfg.enc_len, rcfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("frames", [True, False], ids=["frames", "no_frames"])
def test_lm_forward_matches_reference(whisper, frames):
    """With frames the encoder runs on them and the logits cover the
    decoder tokens only; without, the encoder runs on the token
    embeddings, as the reference's."""
    rcfg, pcfg, rparams, pparams, _ = whisper
    toks = _prompt(rcfg, 12)
    pre = _frames(rcfg) if frames else None
    want, _ = RT.lm_forward(rparams, jnp.asarray(toks), rcfg,
                            embeds_prefix=None if pre is None
                            else jnp.asarray(pre))
    got, aux = PT.lm_forward(pparams, _t(toks).long(), pcfg,
                             embeds_prefix=None if pre is None else _t(pre))
    assert got.shape == (B, 12, pcfg.padded_vocab) and aux == 0.0
    _close(got, want)


@pytest.mark.parametrize("plan", ["plain", "LBM", "LWM"])
def test_make_prefill_matches_reference(whisper, plan):
    """``make_prefill`` with frames: plain, and under an LBM and an LWM
    plan (the decoder's self-attention through flash attention, its FFN
    through the granted kernel; the encoder and the cross-attention
    plain).  Under a plan it also stays within the tolerance of the
    port's plain path."""
    rcfg, pcfg, rparams, pparams, _ = whisper
    rp, pp = _plans(rcfg, plan) if plan != "plain" else (None, None)
    toks, frames = _prompt(rcfg, 20, seed=3), _frames(rcfg, seed=3)
    want = RM.make_prefill(rcfg)(
        rparams, {"tokens": jnp.asarray(toks),
                  "embeds_prefix": jnp.asarray(frames)}, rp)
    batch = {"tokens": _t(toks).long(), "embeds_prefix": _t(frames)}
    got = PM.make_prefill(pcfg)(pparams, batch, pp)
    assert got.shape == (B, pcfg.padded_vocab)
    _close(got, want)
    _close(got, PM.make_prefill(pcfg)(pparams, batch))


# ------------------------------------------------------------ decode --
def test_prefill_chunk_and_decode_step_with_enc_out(whisper, ref_fns):
    """Two prompt chunks, the second resuming the cache, then three decode
    steps, every cross-attention over the same encoder output; logits and
    the self-attention caches against the reference's."""
    rcfg, pcfg, rparams, pparams, _ = whisper
    rdec, rpf = ref_fns
    toks = _prompt(rcfg, 20)
    enc = np.asarray(RT.encode(rparams, jnp.asarray(_frames(rcfg)), rcfg))
    rc = RT.init_caches(rparams, rcfg, B, MAX_LEN)
    pc = PT.init_caches(pparams, pcfg, B, MAX_LEN, device="cpu")
    for lo, hi in ((0, 12), (12, 20)):
        rl, rc = rpf(rparams, jnp.asarray(toks[:, lo:hi]), rc, jnp.int32(lo),
                     rcfg, jnp.asarray(enc))
        pl, pc = PT.prefill_chunk(pparams, _t(toks[:, lo:hi]).long(), pc, lo,
                                  pcfg, _t(enc))
        _close(pl, rl)
    feed = _prompt(rcfg, 3, seed=1)
    for i in range(3):
        tok = feed[:, i:i + 1]
        rl, rc = rdec(rparams, jnp.asarray(tok), rc, jnp.int32(20 + i), rcfg,
                      jnp.asarray(enc))
        pl, pc = PT.decode_step(pparams, _t(tok).long(), pc, 20 + i, pcfg,
                                _t(enc))
        _close(pl, rl)
    for g in range(rcfg.num_layers):
        for name in ("k", "v"):
            _close(pc[g][name], rc[g][name])


@pytest.mark.parametrize("kind", ["LBM", "LWM"])
def test_decode_epoch_teacher_forced_with_enc_out(whisper, ref_fns, kind):
    """8 decode steps under one plan with the encoder output: the port's
    ``decode_epoch`` fed the same tokens as the reference's
    ``decode_step`` yields the same greedy tokens and matching logits;
    the serving closure (``make_decode_epoch``) greedy-decodes the
    reference's own epoch tokens."""
    rcfg, pcfg, rparams, pparams, _ = whisper
    rdec, rpf = ref_fns
    rp, pp = _plans(rcfg, kind)
    prompt, forced = _prompt(rcfg, 16), _prompt(rcfg, 9, seed=2)
    enc = np.asarray(RT.encode(rparams, jnp.asarray(_frames(rcfg, 1)), rcfg))
    rc = RT.init_caches(rparams, rcfg, B, MAX_LEN)
    _, rc = rpf(rparams, jnp.asarray(prompt), rc, jnp.int32(0), rcfg,
                jnp.asarray(enc))
    rc0 = rc
    want_tok, want_logits = [], []
    for i in range(8):
        rl, rc = rdec(rparams, jnp.asarray(forced[:, i:i + 1]), rc,
                      jnp.int32(16 + i), rcfg, jnp.asarray(enc), plan=rp)
        want_logits.append(np.asarray(rl)[:, -1])
        want_tok.append(np.asarray(RM._greedy_next_token(rcfg)(rl)))

    pc = PT.init_caches(pparams, pcfg, B, MAX_LEN, device="cpu")
    _, pc = PT.prefill_chunk(pparams, _t(prompt).long(), pc, 0, pcfg, _t(enc))
    greedy = PM._greedy_next_token(pcfg)
    forced_t = _t(forced).long()
    got_tok, got_logits = [], []

    def teacher(logits):
        got_logits.append(logits[:, -1].numpy())
        got_tok.append(greedy(logits).numpy())
        return forced_t[:, len(got_tok)]

    PT.decode_epoch(pparams, forced_t[:, :1], pc, 16, pcfg, 8,
                    next_token_fn=teacher, enc_out=_t(enc), plan=pp)
    np.testing.assert_array_equal(np.stack(got_tok), np.stack(want_tok))
    np.testing.assert_allclose(np.stack(got_logits), np.stack(want_logits),
                               atol=ATOL, rtol=RTOL)

    # the serving epoch, greedy, against the reference's
    want, _ = jax.jit(RM.make_decode_epoch(rcfg),
                      static_argnames=("plan", "k", "kv_len"))(
        rparams, rc0, jnp.asarray(forced[:, :1]), jnp.int32(16),
        jnp.asarray(enc), plan=rp, k=4)
    pc = PT.init_caches(pparams, pcfg, B, MAX_LEN, device="cpu")
    _, pc = PT.prefill_chunk(pparams, _t(prompt).long(), pc, 0, pcfg, _t(enc))
    got, _ = PM.make_decode_epoch(pcfg)(pparams, pc, forced_t[:, :1], 16,
                                        _t(enc), plan=pp, k=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_batched_epoch_with_enc_equals_single_epochs(whisper):
    """A bucket of two tenants with their own encoder outputs (a list,
    and a stacked tensor as the reference's) equals each tenant's own
    epoch, bitwise."""
    _, pcfg, _, pparams, _ = whisper
    _, plan = _plans(pcfg, "LBM")
    encs = [_t(_frames(pcfg, s)) for s in (5, 6)]
    toks = torch.tensor([[[3], [4]], [[5], [6]]])
    single = PM.make_decode_epoch(pcfg)
    want = []
    for i in range(2):
        c = PT.init_caches(pparams, pcfg, B, 16, device="cpu")
        want.append(single(pparams, c, toks[i], 0, encs[i], plan=plan,
                           k=4)[0])
    batched = PM.make_decode_epoch_batched(pcfg)
    for enc in (encs, torch.stack(encs)):
        caches = [PT.init_caches(pparams, pcfg, B, 16, device="cpu")
                  for _ in range(2)]
        got, _ = batched([pparams, pparams], caches, toks,
                         torch.zeros(2, dtype=torch.long), enc, plan=plan,
                         k=4)
        assert torch.equal(got, torch.stack(want))


def test_prefix_seeding_refuses_encdec(whisper):
    """Cross-attention caches come from the encoder, not a prompt
    prefix: both packages refuse to seed an encdec cache."""
    rcfg, pcfg, _, pparams, _ = whisper
    snap = PT.init_caches(pparams, pcfg, B, 16, device="cpu")
    with pytest.raises(ValueError, match="encdec"):
        RT.seed_caches_from_prefix(rcfg, B, 16, RT.init_caches(
            None, rcfg, B, 16), 8)
    with pytest.raises(ValueError, match="encdec"):
        PT.seed_caches_from_prefix(pcfg, B, 16, snap, 8)


# ----------------------------------------------------------- routing --
H100_SMEM_OPTIN = 232448   # shared_memory_per_block_optin of an H100


def _full_width_plan(cfg, kind, pages, seq_block, kv_dtype="native"):
    sel = PSelection(PCandidate(kind=kind, p_need=pages, dram_bytes=0,
                                flops=0, loops=(), cache_map=(),
                                usage_limit_bytes=0), pages, 0.0)
    plan = pplan.lower_selection(sel, pages, seq_block=seq_block,
                                 d_model=cfg.d_model, d_ff=cfg.d_ff,
                                 dtype_bytes=2, head_dim=cfg.hd,
                                 kv_dtype=kv_dtype)
    assert plan.kind == kind
    return plan


def test_full_width_whisper_plans_route_to_the_hopper_kinds():
    """Full-width whisper-tiny in bf16 under the grants its paths get:
    the decoder's prefill attention (hd 64, 448 positions, a batch of
    2 x 6 heads on 132 SMs) takes the 64-row wgmma flash tile under the
    smallest fused LBM grant and under LWM@32p (int8 K/V there takes the
    quantized wgmma tile of hd 64); the decode FFN (2
    rows, d_model 384, d_ff 1536) under LBM@34p the fused FFN's gemv
    tile, and its 896 prefill rows the wgmma tile; fp32 keeps simt."""
    from repro_torch.core.vmem import LANE, fused_ffn_pages
    from repro_torch.kernels import ops
    cfg = pbase.get_arch(ARCH)
    d, f, hd, S = cfg.d_model, cfg.d_ff, cfg.hd, 448
    assert (d, f, hd) == (384, 1536, 64)
    bf16 = torch.bfloat16
    lbm = _full_width_plan(cfg, "LBM", fused_ffn_pages(S, d, f, 2), S)
    for plan in (lbm, _full_width_plan(cfg, "LWM", 32, S)):
        a = plan.attn
        tile = ops.legalize_attn_tile(a.block_q, a.block_kv, hd, S,
                                      H100_SMEM_OPTIN, bf16, False,
                                      2 * cfg.num_heads, 132)
        assert (tile.kind, tile.hd, tile.bq) == ("wgmma", 64, 64)
        assert ops.legalize_attn_tile(a.block_q, a.block_kv, hd, S,
                                      H100_SMEM_OPTIN, torch.float32
                                      ).kind == "simt"
    q8 = _full_width_plan(cfg, "LWM", 32, S, "int8").attn
    tile = ops.legalize_attn_tile(q8.block_q, q8.block_kv, hd, S,
                                  H100_SMEM_OPTIN, bf16, True,
                                  2 * cfg.num_heads, 132)
    assert (tile.kind, tile.hd, tile.bq, tile.kv) == ("wgmma", 64, 128,
                                                      ("quantized",))
    dec = _full_width_plan(cfg, "LBM", 34, LANE).ffn
    assert dec.fused
    for rows, kind in ((2, "gemv"), (1, "gemv"), (896, "wgmma")):
        blocks = (lbm.ffn.block_s, lbm.ffn.block_f) if rows > 8 else \
            (dec.block_s, dec.block_f)
        assert ops.legalize_ffn_tile(*blocks, rows, H100_SMEM_OPTIN, bf16, d,
                                     f).kind == kind
        assert ops.legalize_ffn_tile(*blocks, rows, H100_SMEM_OPTIN,
                                     torch.float32, d, f).kind == "simt"
