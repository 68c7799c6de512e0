"""The port's VLM family (LLaVA-style: the dense decoder with patch
embeddings prepended to the token embeddings) against the JAX
package's, at the reduced llava-next-mistral-7b config (fp32: 2 layers,
d_model 128, 8 patches), with the reference's params handed over
through ``repro_torch.bridge``.  Inputs come from numpy and go to both
sides.

Tolerance: atol = rtol = 1e-4, the dense family's
(tests/test_torch_model.py:33), for the plain path and the native-KV
plan; the int8-KV plan at 2e-3, the dense family's bar for it
(tests/test_torch_model.py::test_make_prefill_with_plan_matches_reference,
from tests/test_plan.py: K and V are quantized from values summed in
another order, and a value a few ULP apart can round to the other int8
step).  Plan-lowered prefill runs the reference's Pallas kernels in
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
from repro.models import base as rbase
from repro.models import model as RM
from repro.models import transformer as RT
from repro_torch import bridge
from repro_torch.core import plan as pplan
from repro_torch.core.allocator import Selection as PSelection
from repro_torch.core.mct import MappingCandidate as PCandidate
from repro_torch.models import base as pbase
from repro_torch.models import model as PM
from repro_torch.models import transformer as PT

ATOL = RTOL = 1e-4                      # tests/test_torch_model.py:33
INT8_TOL = 2e-3                         # the dense family's int8-plan bar
ARCH = "llava-next-mistral-7b"
B = 2


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def llava():
    rcfg = rbase.get_arch(ARCH).reduced()
    pcfg = pbase.get_arch(ARCH).reduced()
    rparams = RM.init_params(rcfg, jax.random.PRNGKey(1))
    pparams = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, rparams), pcfg, "cpu")
    return rcfg, pcfg, rparams, pparams


def _inputs(cfg, n, seed=0):
    """Tokens [B, n] and patch embeddings [B, num_patches, d]."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, n), dtype=np.int32)
    patches = rng.standard_normal((B, cfg.num_patches, cfg.d_model)
                                  ).astype(np.float32)
    return toks, patches


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
    assert pp.attn.kv_dtype == kv_dtype
    return rp, pp


def test_vlm_params_are_the_dense_stack(llava):
    """A VLM's params are the dense decoder's: no encoder, no
    cross-attention, the reference's tree layer for layer."""
    rcfg, pcfg, _, pparams = llava
    assert set(pparams) == {"embed", "layers", "final_norm"}
    assert len(pparams["layers"]) == rcfg.num_layers
    own = PM.init_params(pcfg, seed=3, device="cpu")
    assert set(own) == set(pparams)
    assert [sorted(lp) for lp in own["layers"]] == [
        ["attn", "ln1", "ln2", "mlp"]] * rcfg.num_layers


@pytest.mark.parametrize("n", [12, 1])
def test_lm_forward_with_patches_matches_reference(llava, n):
    """The logits cover the patch positions and the tokens (num_patches +
    n), the positions running over both."""
    rcfg, pcfg, rparams, pparams = llava
    toks, patches = _inputs(rcfg, n)
    want, _ = RT.lm_forward(rparams, jnp.asarray(toks), rcfg,
                            embeds_prefix=jnp.asarray(patches))
    got, aux = PT.lm_forward(pparams, _t(toks).long(), pcfg,
                             embeds_prefix=_t(patches))
    assert got.shape == (B, rcfg.num_patches + n, pcfg.padded_vocab)
    assert aux == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_patch_prefix_moves_the_token_positions(llava):
    """The token logits with patches differ from those without (RoPE
    positions start after the prefix, and the tokens attend to it)."""
    _, pcfg, _, pparams = llava
    toks, patches = _inputs(pcfg, 6)
    with_p, _ = PT.lm_forward(pparams, _t(toks).long(), pcfg,
                              embeds_prefix=_t(patches))
    without, _ = PT.lm_forward(pparams, _t(toks).long(), pcfg)
    assert not torch.allclose(with_p[:, pcfg.num_patches:], without,
                              atol=1e-3)


@pytest.mark.parametrize("kind,kv_dtype", [("plain", "native"),
                                           ("LBM", "native"),
                                           ("LWM", "native"),
                                           ("LWM", "int8")])
def test_make_prefill_with_patches_matches_reference(llava, kind, kv_dtype):
    """``make_prefill`` with patch embeddings: the last position's logits
    (the last token's), plain and under plans (flash attention over the
    patches and tokens with the plan's blocks and KV precision, the FFN
    through the granted kernel), against the reference's; a native plan
    also within the tolerance of the port's plain path."""
    rcfg, pcfg, rparams, pparams = llava
    rp, pp = (_plans(rcfg, kind, kv_dtype) if kind != "plain"
              else (None, None))
    toks, patches = _inputs(rcfg, 40, seed=3)
    want = RM.make_prefill(rcfg)(
        rparams, {"tokens": jnp.asarray(toks),
                  "embeds_prefix": jnp.asarray(patches)}, rp)
    batch = {"tokens": _t(toks).long(), "embeds_prefix": _t(patches)}
    got = PM.make_prefill(pcfg)(pparams, batch, pp)
    assert got.shape == (B, pcfg.padded_vocab)
    tol = ATOL if kv_dtype == "native" else INT8_TOL
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)
    if kv_dtype == "native":
        full, _ = PT.lm_forward(pparams, batch["tokens"], pcfg,
                                embeds_prefix=batch["embeds_prefix"])
        np.testing.assert_allclose(got.numpy(), full[:, -1].numpy(),
                                   atol=ATOL, rtol=RTOL)


def test_serve_make_prefill_with_patches(llava):
    """``make_prefill(cfg, serve=True)`` takes the same prefix (a dense
    stack: the serving semantics change nothing)."""
    rcfg, pcfg, rparams, pparams = llava
    toks, patches = _inputs(rcfg, 9, seed=5)
    want = RM.make_prefill(rcfg, serve=True)(
        rparams, {"tokens": jnp.asarray(toks),
                  "embeds_prefix": jnp.asarray(patches)})
    got = PM.make_prefill(pcfg, serve=True)(
        pparams, {"tokens": _t(toks).long(), "embeds_prefix": _t(patches)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_prefix_seeding_follows_reference(llava):
    """The reference's ``seed_caches_from_prefix`` serves dense, MoE, SSM
    and hybrid stacks only; the port's refuses a VLM alike."""
    rcfg, pcfg, _, pparams = llava
    with pytest.raises(ValueError, match="vlm"):
        RT.seed_caches_from_prefix(rcfg, B, 16, RT.init_caches(
            None, rcfg, B, 16), 8)
    snap = PT.init_caches(pparams, pcfg, B, 16, device="cpu")
    with pytest.raises(ValueError, match="vlm"):
        PT.seed_caches_from_prefix(pcfg, B, 16, snap, 8)
