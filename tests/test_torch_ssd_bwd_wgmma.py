"""ssd_chunk_bwd's wgmma kind (csrc/ssd_chunk_bwd.cu) on the CPU.

The kernel runs only on the card, so its arithmetic is held here through
a torch emulation of its cast points: x, B and C bf16 values (exact on the
tensor cores), cum by the forward wgmma kind's warp scan, gy and gS split
into bf16 hi + lo as their tiles load, the weights M = CB o L o dt_j and
W = G o L o dt_j split alike on the fragments, every product of halves
summed in fp32 (dx takes hi hi + hi lo + lo hi).  At full width (P 64,
N 128), Q 256 and a ragged Q 44, on bf16-valued inputs from numpy:

* against ``jax.grad`` of the reference's ``ssd_chunk_ref``
  (src/repro/kernels/ref.py:40) and against ``ssd_chunk_bwd_plain``,
  within 2e-3 of each gradient's largest magnitude (the bar chip_smoke.py
  holds the kernel to);
* without the lo halves (bf16 gy, gS, M and W alone) it misses that bar
  (the largest of the five relative errors is above it at both chunks)
  and each gradient's error is ten times the split's or more: the split
  is what keeps the bar.

Then the routing (bf16 -> wgmma, fp32 -> simt, ``SsdChunk`` handing the
forward's kind to the backward), the head groups and the shared memory
against the source's constants.  The card-only checks are in
tests/test_torch_gpu.py.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import ssd_chunk_ref
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as kssd
from test_torch_ssm import _hi_lo, _warp_scan_cum

TOL = 2e-3
CSRC = Path(kssd.__file__).resolve().parent.parent / "csrc"


def _bwd_wgmma_emulation(x, dt, A, B, C, chunk, gy, gS, split=True):
    """The wgmma kind's backward in torch fp32 (B, C [BH, S, N]);
    ``split=False`` drops every lo half.  Returns (dx, ddt, dA, dB, dC)."""
    BH, S, P = x.shape
    N = B.shape[-1]
    n_c = S // chunk
    xr = x.reshape(BH, n_c, chunk, P)
    dtr = dt.reshape(BH, n_c, chunk)
    Br = B.reshape(BH, n_c, chunk, N)
    Cr = C.reshape(BH, n_c, chunk, N)
    a = A[:, None, None]
    cum = _warp_scan_cum(-dtr * a)
    tri = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    diff = cum[..., :, None] - cum[..., None, :]
    L = torch.where(tri, torch.exp(torch.where(tri, diff, torch.zeros_like(diff))),
                    torch.zeros_like(diff))
    e = torch.exp(cum[..., -1:] - cum)
    ed = e * dtr
    dtj = dtr[..., None, :]
    gyh, gyl = _hi_lo(gy.reshape(BH, n_c, chunk, P), split)
    gSh, gSl = _hi_lo(gS, split)
    t = lambda m: m.transpose(-1, -2)  # noqa: E731
    CL = (Cr @ t(Br)) * L
    G = gyh @ t(xr) + gyl @ t(xr)
    Mh, Ml = _hi_lo(CL * dtj, split)
    Wh, Wl = _hi_lo(G * L * dtj, split)
    u = Br @ gSh + Br @ gSl
    v = xr @ t(gSh) + xr @ t(gSl)
    dx = t(Mh) @ gyh + t(Mh) @ gyl + t(Ml) @ gyh + ed[..., None] * u
    dB = t(Wh) @ Cr + t(Wl) @ Cr + ed[..., None] * v
    dC = Wh @ Br + Wl @ Br
    T = G * CL
    R = T * dtj
    s = (u * xr).sum(-1)
    sterm = ed * s
    dcum = R.sum(-1) - R.sum(-2) - sterm
    dcum[..., -1] += sterm.sum(-1)
    rc = dcum.flip(-1).cumsum(-1).flip(-1)
    ddt = T.sum(-2) + e * s - a * rc
    dA = -(dtr * rc).sum((1, 2))
    return (dx.reshape(BH, S, P), ddt.reshape(BH, S), dA,
            dB.reshape(BH, S, N), dC.reshape(BH, S, N))


def _inputs(BH, S, P, N, chunk, seed):
    """bf16-valued x, B, C (fp32 arrays), fp32 dt, A, gy, gS."""
    rng = np.random.default_rng(seed)
    bf = lambda a: torch.from_numpy(a).bfloat16().float().numpy()  # noqa: E731
    x = bf(rng.standard_normal((BH, S, P)).astype(np.float32))
    dt = np.log1p(np.exp(rng.standard_normal((BH, S)))).astype(np.float32)
    A = (np.abs(rng.standard_normal(BH)) + 0.1).astype(np.float32)
    Bm = bf(rng.standard_normal((BH, S, N)).astype(np.float32))
    Cm = bf(rng.standard_normal((BH, S, N)).astype(np.float32))
    gy = rng.standard_normal((BH, S, P)).astype(np.float32)
    gS = rng.standard_normal((BH, S // chunk, N, P)).astype(np.float32)
    return (x, dt, A, Bm, Cm), gy, gS


def _jax_grads(ins, chunk, gy, gS):
    def loss(*args):
        y, st = ssd_chunk_ref(*args, chunk)
        return jnp.sum(y * gy) + jnp.sum(st * gS)
    return jax.jit(jax.grad(loss, argnums=tuple(range(5))))(
        *map(jnp.asarray, ins))


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-6)


NAMES = ("dx", "ddt", "dA", "dB", "dC")


@pytest.mark.parametrize("S,chunk", [(512, 256), (88, 44)],
                         ids=["q256", "ragged_q44"])
def test_wgmma_bwd_emulation_matches_jax_grad_and_plain(S, chunk):
    ins, gy, gS = _inputs(2, S, 64, 128, chunk, seed=S + chunk)
    want = _jax_grads(ins, chunk, gy, gS)
    tin = [torch.from_numpy(a) for a in ins]
    tgy, tgS = torch.from_numpy(gy), torch.from_numpy(gS)
    got = _bwd_wgmma_emulation(*tin, chunk, tgy, tgS)
    plain = kssd.ssd_chunk_bwd_plain(*tin, chunk, tgy, tgS)
    for name, g, w, p in zip(NAMES, got, want, plain):
        assert _rel_err(g.numpy(), w) <= TOL, name
        assert _rel_err(g.numpy(), p.numpy()) <= TOL, name


@pytest.mark.parametrize("S,chunk", [(512, 256), (88, 44)],
                         ids=["q256", "ragged_q44"])
def test_wgmma_bwd_without_lo_halves_loses_the_split_s_precision(S, chunk):
    """bf16 gy, gS, M and W alone (no lo halves): the gradients miss the
    2e-3 bar against jax.grad (not each of them: dA at Q 256 and ddt, dB,
    dC at Q 44 stay under it on these inputs), and each gradient's error
    is ten times the split's or more."""
    ins, gy, gS = _inputs(2, S, 64, 128, chunk, seed=S + chunk)
    want = _jax_grads(ins, chunk, gy, gS)
    tin = [torch.from_numpy(a) for a in ins]
    tgy, tgS = torch.from_numpy(gy), torch.from_numpy(gS)
    split = _bwd_wgmma_emulation(*tin, chunk, tgy, tgS)
    hi = _bwd_wgmma_emulation(*tin, chunk, tgy, tgS, split=False)
    errs = []
    for name, s, h, w in zip(NAMES, split, hi, want):
        errs.append(_rel_err(h.numpy(), w))
        assert errs[-1] >= 10 * _rel_err(s.numpy(), w), name
    assert max(errs) > TOL


def test_ssd_chunk_function_hands_the_forward_kind_to_the_backward(
        monkeypatch):
    """bf16 at full width routes both passes to wgmma, fp32 to simt:
    SsdChunk saves the forward's kind and passes it on."""
    seen = []
    real = kssd.ssd_chunk_bwd

    def spy(*args, kind="simt"):
        seen.append(kind)
        return real(*args, kind=kind)

    monkeypatch.setattr(kssd, "ssd_chunk_bwd", spy)
    ins, _, _ = _inputs(2, 64, 64, 128, 32, seed=3)
    for dtype, kind in ((torch.bfloat16, "wgmma"), (torch.float32, "simt")):
        x, dt, A, Bm, Cm = [torch.from_numpy(a) for a in ins]
        leaves = [x.to(dtype).requires_grad_(), dt.requires_grad_(),
                  A.requires_grad_(), Bm.to(dtype).requires_grad_(),
                  Cm.to(dtype).requires_grad_()]
        assert ops.ssd_kind(dtype, 128, 64) == kind
        y, st = ops.ssd_intra_chunk(*leaves, 32)
        (y.sum() + st.sum()).backward()
        assert seen[-1] == kind
    assert seen == ["wgmma", "simt"]


def test_bwd_wgmma_kind_routes_and_rejects_like_the_forward():
    """The wgmma kind takes what the forward's takes (kssd.wgmma_takes);
    on the CPU it computes the plain backward and counts no launch."""
    ins, gy, gS = _inputs(4, 64, 32, 16, 32, seed=5)
    x, dt, A, Bm, Cm = [torch.from_numpy(a) for a in ins]
    gy, gS = torch.from_numpy(gy), torch.from_numpy(gS)
    bf = [x.bfloat16(), dt, A, Bm.bfloat16(), Cm.bfloat16()]
    before = dict(kssd.launches_bwd_by_kind)
    got = kssd.ssd_chunk_bwd(*bf, 32, gy, gS, kind="wgmma")
    want = kssd.ssd_chunk_bwd(*bf, 32, gy, gS, kind="simt")
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert kssd.launches_bwd_by_kind == before
    assert set(kssd.launches_bwd_by_kind) == {"simt", "wgmma"}
    with pytest.raises(TypeError):                    # fp32
        kssd.ssd_chunk_bwd(x, dt, A, Bm, Cm, 32, gy, gS, kind="wgmma")
    with pytest.raises(TypeError):                    # P 16 not taken
        kssd.ssd_chunk_bwd(bf[0][..., :16], dt, A, bf[3], bf[4], 32,
                           gy[..., :16], gS[..., :16], kind="wgmma")
    with pytest.raises(ValueError):
        kssd.ssd_chunk_bwd(*bf, 32, gy, gS, kind="gemv")


def test_bwd_head_groups():
    """A wgmma block sums dB / dC over up to four heads that share B and
    C (the largest divisor of the heads); simt keeps per-head slabs."""
    assert kssd.bwd_head_group(32, "wgmma") == 4
    assert kssd.bwd_head_group(80, "wgmma") == 4
    assert kssd.bwd_head_group(6, "wgmma") == 2
    assert kssd.bwd_head_group(3, "wgmma") == 1
    assert kssd.bwd_head_group(32, "simt") == 1


def _constant(name, text):
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_bwd_wgmma_smem_bytes_match_the_source_and_fit_the_h100():
    """bwd_smem_bytes(n, p, "wgmma") against csrc/ssd_chunk_bwd.cu's
    wgmma_bwd_smem_bytes, recomputed from the source's constants: the
    alignment, the cum / dt / e stripes and four reduction rows, then B_j,
    x_j and the larger of C_i + gy_i's halves and gS's halves, in 64-row
    boxes of 128 bytes a row (N in whole slices of 64 or 128)."""
    bwd = (CSRC / "ssd_chunk_bwd.cu").read_text()
    common = (CSRC / "ssd_common.cuh").read_text()
    max_chunk, rows = _constant("kMaxChunk", bwd), _constant("kWRows", common)
    assert "kWStripeBytes = (3 * kMaxChunk + 4 * kWRows)" in bwd
    assert "constexpr int kWBox = kWRows * 128;" in common
    for n in range(16, 257, 16):
        slice_ = 64 if n <= 64 else 128
        nb = -(-n // slice_) * slice_ // 64
        want = (1024 + (3 * max_chunk + 4 * rows) * 4
                + (nb + 1 + max(nb + 2, 2 * nb)) * rows * 128)
        for p in kssd.WGMMA_HEAD_DIMS:
            assert kssd.bwd_smem_bytes(n, p, "wgmma") == want, (n, p)
    assert kssd.bwd_smem_bytes(128, 64, "wgmma") == 62_464
    assert kssd.bwd_smem_bytes(kssd.MAX_WGMMA_STATE, 64, "wgmma") <= 232_448
