"""The gradient of the port's SSD scan against the JAX package's autodiff.

* ``ssd_chunk_bwd_plain`` (the backward kernel's plain version, which
  ``ssd_chunk_bwd`` runs on the CPU) against ``torch.autograd`` of
  ``ssd_chunk_plain``, per head and summed over the heads that share B
  and C: within 1e-5 of each gradient's largest magnitude (both fp32;
  only the order of summation differs).
* ``kssd.SsdChunk`` (the model's call): its gradients are
  ``ssd_chunk_bwd``'s, each in its input's dtype.
* The port's ``ssd`` and ``mamba2_forward`` gradients (x, dt, A, B, C, D,
  h0; every Mamba2 param) against ``jax.grad`` of the reference's
  (src/repro/models/ssm.py:56), heads > 1 sharing B and C, and the tail
  segment of a sequence that is not a multiple of the chunk: within 2e-3
  of each gradient's largest magnitude (fp32; the reference's einsum and
  the port's kernel sum in other orders, and the backward's reverse
  cumsum adds a long fp32 sum).  Inputs and output cotangents come from
  numpy and go to both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import base as rbase
from repro.models import model as RM
from repro.models import ssm as RS
from repro_torch import bridge
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as kssd
from repro_torch.models import base as pbase
from repro_torch.models import ssm as PS

PLAIN_TOL = 1e-5
TOL = 2e-3


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _close(got, want, tol, label=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{label}: err {err} scale {scale}"


def _chunk_inputs(BH, G, S, P, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BH, S, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((BH, S)))).astype(np.float32)
    A = (np.abs(rng.standard_normal(BH)) + 0.1).astype(np.float32)
    Bm = rng.standard_normal((G, S, N)).astype(np.float32)
    Cm = rng.standard_normal((G, S, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


CHUNK_SHAPES = [(4, 4, 64, 16, 8, 16), (6, 2, 64, 32, 16, 32),
                (4, 1, 66, 16, 8, 22), (2, 2, 8, 16, 8, 1),
                (3, 3, 96, 16, 24, 96)]
CHUNK_IDS = ["per_head", "heads3_shared", "ragged_q22", "q1", "one_chunk"]


@pytest.mark.parametrize("BH,G,S,P,N,Q", CHUNK_SHAPES, ids=CHUNK_IDS)
def test_bwd_plain_matches_autograd_of_the_plain_forward(BH, G, S, P, N, Q):
    x, dt, A, Bm, Cm = _chunk_inputs(BH, G, S, P, N, seed=S + Q)
    rng = np.random.default_rng(1)
    gy = rng.standard_normal((BH, S, P)).astype(np.float32)
    gS = rng.standard_normal((BH, S // Q, N, P)).astype(np.float32)
    h = BH // G
    leaves = [_t(a, grad=True) for a in (x, dt, A, Bm, Cm)]
    y, st = kssd.ssd_chunk_plain(leaves[0], leaves[1], leaves[2],
                                 leaves[3].repeat_interleave(h, 0),
                                 leaves[4].repeat_interleave(h, 0), Q)
    want = torch.autograd.grad((y * _t(gy)).sum() + (st * _t(gS)).sum(),
                               leaves)
    got = kssd.ssd_chunk_bwd(*map(_t, (x, dt, A, Bm, Cm)), Q, _t(gy), _t(gS))
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        assert g.dtype == torch.float32
        _close(g.numpy(), w.numpy(), PLAIN_TOL, name)


def test_bwd_plain_per_head_sums_to_the_shared_gradient():
    """ssd_chunk_bwd's dB and dC for B, C shared by heads are the per-head
    plain gradients summed over each batch row's heads."""
    x, dt, A, Bm, Cm = _chunk_inputs(6, 2, 32, 16, 8, seed=3)
    rng = np.random.default_rng(2)
    gy = _t(rng.standard_normal((6, 32, 16)).astype(np.float32))
    gS = _t(rng.standard_normal((6, 2, 8, 16)).astype(np.float32))
    per_head = kssd.ssd_chunk_bwd_plain(
        *map(_t, (x, dt, A, np.repeat(Bm, 3, 0), np.repeat(Cm, 3, 0))), 16,
        gy, gS)
    shared = kssd.ssd_chunk_bwd(*map(_t, (x, dt, A, Bm, Cm)), 16, gy, gS)
    for i in range(3):
        assert torch.equal(per_head[i], shared[i])
    for i in (3, 4):
        assert torch.equal(per_head[i].reshape(2, 3, 32, 8).sum(1), shared[i])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunk_function_routes_its_gradient_through_the_backward(dtype):
    """The model's call (ops.ssd_intra_chunk -> SsdChunk) gets its
    gradients from ssd_chunk_bwd, each in its input's dtype."""
    dt_ = getattr(torch, dtype)
    x, dt, A, Bm, Cm = _chunk_inputs(4, 2, 64, 32, 16, seed=7)
    leaves = [_t(x).to(dt_).requires_grad_(), _t(dt, True), _t(A, True),
              _t(Bm).to(dt_).requires_grad_(), _t(Cm).to(dt_).requires_grad_()]
    y, st = ops.ssd_intra_chunk(*leaves, 32)
    rng = np.random.default_rng(4)
    gy = _t(rng.standard_normal(tuple(y.shape)).astype(np.float32))
    gS = _t(rng.standard_normal(tuple(st.shape)).astype(np.float32))
    got = torch.autograd.grad((y * gy).sum() + (st * gS).sum(), leaves)
    want = kssd.ssd_chunk_bwd(*[t.detach() for t in leaves], 32, gy, gS)
    for leaf, g, w in zip(leaves, got, want):
        assert g.dtype == leaf.dtype and g.shape == leaf.shape
        assert torch.equal(g, w.to(leaf.dtype))


def test_ssd_chunk_bwd_rejects_malformed_gradients():
    x, dt, A, Bm, Cm = map(_t, _chunk_inputs(2, 2, 32, 16, 8, seed=0))
    gy = torch.zeros((2, 32, 16))
    with pytest.raises(ValueError):
        kssd.ssd_chunk_bwd(x, dt, A, Bm, Cm, 16, gy, torch.zeros((2, 2, 8, 8)))
    with pytest.raises(ValueError):
        kssd.ssd_chunk_bwd(x, dt, A, Bm, Cm, 16, gy.double(),
                           torch.zeros((2, 2, 8, 16)))


def test_bwd_smem_bytes_fit_the_h100():
    """The backward's column block holds B and C transposed: every compiled
    head dim fits the H100's 232,448 bytes a block up to N 256."""
    for p in kssd.HEAD_DIMS:
        assert kssd.bwd_smem_bytes(256, p) <= 232448
    assert kssd.bwd_smem_bytes(128, 64) == 4 * (3 * 256 + 2 * 128 * 65
                                                + 2 * 64 * 65 + 64 * 64
                                                + 2 * 64 * 65)


# ---------------------------------------------------------------- ssd --
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
@pytest.mark.parametrize("s,chunk", [(64, 16), (44, 44), (96, 32)])
def test_ssd_grads_match_reference(s, chunk, with_h0):
    """Three heads share each batch row's B and C."""
    ins = _ssd_inputs(2, s, 3, 16, 8, seed=s + chunk)
    if not with_h0:
        ins = ins[:-1]
    rng = np.random.default_rng(11)
    gy = rng.standard_normal((2, s, 3, 16)).astype(np.float32)
    gh = rng.standard_normal((2, 3, 8, 16)).astype(np.float32)

    def ref_loss(*args):
        h0 = args[6] if with_h0 else None
        y, hf = RS.ssd(*args[:6], chunk, h0)
        return jnp.sum(y * gy) + jnp.sum(hf * gh)

    want = jax.jit(jax.grad(ref_loss, argnums=tuple(range(len(ins)))))(
        *map(jnp.asarray, ins))
    leaves = [_t(a, grad=True) for a in ins]
    y, hf = PS.ssd(*leaves[:6], chunk, leaves[6] if with_h0 else None)
    got = torch.autograd.grad((y * _t(gy)).sum() + (hf * _t(gh)).sum(),
                              leaves)
    for name, g, w in zip(("x", "dt", "A", "B", "C", "D", "h0"), got, want):
        _close(g.numpy(), w, TOL, name)


@pytest.fixture(scope="module")
def mamba():
    rcfg = rbase.get_arch("mamba2-370m").reduced()
    pcfg = pbase.get_arch("mamba2-370m").reduced()
    rparams = RM.init_params(rcfg, jax.random.PRNGKey(1))
    rp = jax.tree_util.tree_map(lambda a: np.asarray(a[0]),
                                rparams["layers"]["mamba"])
    return rcfg, pcfg, rp


@pytest.mark.parametrize("s,chunk", [(64, None), (70, None), (64, 16),
                                     (6, None)],
                         ids=["s64", "s70_tail6", "s64_plan16",
                              "s6_tail_only"])
def test_mamba2_forward_grads_match_reference(mamba, s, chunk):
    """Every Mamba2 param's gradient and the input's, through the chunked
    scan and, where s is not a multiple of the chunk (32), its tail
    segment."""
    rcfg, pcfg, rp = mamba
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, rcfg.d_model)).astype(np.float32)
    gout = rng.standard_normal((2, s, rcfg.d_model)).astype(np.float32)
    gssm = rng.standard_normal((2, rcfg.ssm_heads, rcfg.ssm_state,
                                rcfg.ssm_head_dim)).astype(np.float32)

    def ref_loss(p, x):
        out, st = RS.mamba2_forward(p, x, rcfg, chunk=chunk)
        return jnp.sum(out * gout) + jnp.sum(st["ssm"] * gssm)

    want_p, want_x = jax.jit(jax.grad(ref_loss, argnums=(0, 1)))(
        jax.tree_util.tree_map(jnp.asarray, rp), jnp.asarray(x))
    pp = bridge._tree(rp, lambda a: _t(a, grad=True))
    xt = _t(x, grad=True)
    out, st = PS.mamba2_forward(pp, xt, pcfg, chunk=chunk)
    flat = [("in_proj", pp["in_proj"]["w"], want_p["in_proj"]["w"]),
            ("out_proj", pp["out_proj"]["w"], want_p["out_proj"]["w"])]
    flat += [(k, pp[k], want_p[k]) for k in ("conv_w", "A_log", "D",
                                              "dt_bias")]
    got = torch.autograd.grad((out * _t(gout)).sum()
                              + (st["ssm"] * _t(gssm)).sum(),
                              [xt] + [t for _, t, _ in flat])
    _close(got[0].numpy(), want_x, TOL, "x")
    for (name, _, w), g in zip(flat, got[1:]):
        _close(g.numpy(), w, TOL, name)
