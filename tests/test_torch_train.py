"""The port's training path against the JAX package's, on the CPU at the
reduced configs (fp32), with the reference's params, grads and optimizer
state handed over through ``repro_torch.bridge`` and every input made
with numpy.

Tolerances, each relative to the largest magnitude of the compared
quantity (``_close``):
* AdamW (``update``, ``cosine_schedule``, ``clip_by_global_norm``) on the
  same grads: 1e-6, the same fp32 arithmetic in another library; with
  bf16 moments, one bf16 rounding step of m and v (1e-2).
* ``loss_fn`` and its gradients, per family: 2e-3 for the grads, 1e-5
  for the loss (the forward's summation order differs; the backward adds
  more sums).
* One ``make_train_step``: the metrics within 1e-5 (grad_norm 2e-3); the
  new params within 2.1 x the step's learning rate of the reference's
  and, for all but 1% of their entries, within 1e-4.  AdamW's first step
  moves each entry by about lr x sign(g), so an entry whose gradient is
  near zero may move the other way on either side.
* ``microbatches=2`` against the full batch: the reference's own bar
  (tests/test_substrate.py:227, rtol 1e-4, atol 1e-5).
* Remat on against off, ``SyntheticTokens`` against the reference's
  batches: bitwise.  ``compress_grads``: 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import SyntheticTokens as RSyntheticTokens
from repro.distributed import compression as rcomp
from repro.models import base as rbase
from repro.models import model as RM
from repro.optim import adamw as radamw
from repro_torch import bridge
from repro_torch.checkpoint import checkpoint as pckpt
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.distributed import compression as pcomp
from repro_torch.distributed.fault_tolerance import (SupervisorConfig,
                                                     TrainSupervisor)
from repro_torch.launch import train as ptrain
from repro_torch.models import base as pbase
from repro_torch.models import model as PM
from repro_torch.models import transformer as PT
from repro_torch.optim import adamw as padamw

ARCHS = ["yi-9b", "olmoe-1b-7b", "mamba2-370m", "zamba2-2.7b",
         "whisper-tiny", "llava-next-mistral-7b"]
B, S = 2, 16


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, label=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{label}: err {err} scale {scale}"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return [t.detach().float().numpy() for t in padamw.tree_leaves(tree)]


# --------------------------------------------------------------- adamw --
def _opt_tree(seed=0):
    """A params tree with 2-D (decayed) and 1-D leaves, and grads on it."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "b": (5,), "layers": {"k": (3, 4, 2), "s": (4,)}}
    make = lambda: jax.tree_util.tree_map(  # noqa: E731
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    return make(), [make() for _ in range(3)]


def _port_tree(tree):
    return jax.tree_util.tree_map(_t, tree)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference_on_the_same_grads(state_dtype):
    params, grads = _opt_tree()
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=5, clip_norm=1.0,
               state_dtype=state_dtype)
    rcfg, pcfg = radamw.AdamWConfig(**cfg), padamw.AdamWConfig(**cfg)
    rp, rs = jax.tree_util.tree_map(jnp.asarray, params), \
        radamw.init(params, state_dtype)
    pp = _port_tree(params)
    ps = padamw.init(pp, state_dtype)
    tol = 1e-6 if state_dtype == "float32" else 1e-2
    for g in grads:
        rp, rs, rm = radamw.update(rcfg, jax.tree_util.tree_map(jnp.asarray, g),
                                   rs, rp)
        pp, ps, pm = padamw.update(pcfg, _port_tree(g), ps, pp)
        for k in ("grad_norm", "lr"):
            _close(pm[k].numpy(), np.asarray(rm[k]), 1e-6, k)
        assert int(ps.step) == int(rs.step)
        for name, ptree, rtree in (("params", pp, rp), ("m", ps.m, rs.m),
                                   ("v", ps.v, rs.v)):
            for got, want in zip(_leaves(ptree),
                                 jax.tree_util.tree_leaves(rtree)):
                _close(got, np.asarray(want, np.float32),
                       tol if name != "params" else max(tol / 10, 1e-6), name)
    assert jax.tree_util.tree_leaves(ps.m)[0].dtype == getattr(torch,
                                                               state_dtype)


def test_cosine_schedule_and_clip_match_reference():
    cfg = dict(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        want = radamw.cosine_schedule(radamw.AdamWConfig(**cfg),
                                      jnp.asarray(step, jnp.int32))
        got = padamw.cosine_schedule(padamw.AdamWConfig(**cfg),
                                     torch.tensor(step, dtype=torch.int32))
        _close(got.numpy(), np.asarray(want), 1e-6, f"lr@{step}")
    _, grads = _opt_tree(seed=3)
    for max_norm in (0.5, 1e3):
        want, wn = radamw.clip_by_global_norm(
            jax.tree_util.tree_map(jnp.asarray, grads[0]), max_norm)
        got, gn = padamw.clip_by_global_norm(_port_tree(grads[0]), max_norm)
        _close(gn.numpy(), np.asarray(wn), 1e-6, "norm")
        for g, w in zip(_leaves(got), jax.tree_util.tree_leaves(want)):
            _close(g, np.asarray(w), 1e-6, "clipped")


# ---------------------------------------------------------- the loss --
@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    rcfg = rbase.get_arch(request.param).reduced()
    pcfg = pbase.get_arch(request.param).reduced()
    rparams = RM.init_params(rcfg, jax.random.PRNGKey(1))
    pparams = bridge.params_from_numpy(_np(rparams), pcfg, "cpu")
    return rcfg, pcfg, rparams, pparams


def _batch(cfg, seed=0, batch=B):
    """Tokens and labels [batch, S] (a VLM's S minus its patches, as
    ``batch_specs``), and the prefix frames or patches, from numpy."""
    rng = np.random.default_rng(seed)
    n = S
    out = {}
    if cfg.family in ("encdec", "vlm"):
        P = cfg.enc_len if cfg.family == "encdec" else cfg.num_patches
        n = S if cfg.family == "encdec" else S + P
        out["embeds_prefix"] = (0.5 * rng.standard_normal(
            (batch, P, cfg.d_model))).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (batch, n), dtype=np.int32)
    out["tokens"] = toks
    out["labels"] = np.roll(toks, -1, axis=1)
    return out


def _ref_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _port_batch(b):
    return {k: _t(v).long() if v.dtype == np.int32 else _t(v)
            for k, v in b.items()}


@pytest.fixture(scope="module")
def ref_value_and_grad():
    return jax.jit(jax.value_and_grad(RM.loss_fn, has_aux=True),
                   static_argnames=("cfg",))


def test_loss_and_grads_match_reference(family, ref_value_and_grad):
    rcfg, pcfg, rparams, pparams = family
    batch = _batch(rcfg)
    (rloss, rmetrics), rgrads = ref_value_and_grad(rparams, _ref_batch(batch),
                                                   rcfg)
    ploss, pmetrics, pgrads = PM._value_and_grad(pparams, _port_batch(batch),
                                                 pcfg)
    _close(ploss.numpy(), np.asarray(rloss), 1e-5, "loss")
    for k in ("ce", "aux"):
        _close(pmetrics[k].numpy(), np.asarray(rmetrics[k]), 1e-5, k)
    want = bridge.params_from_numpy(_np(rgrads), pcfg, "cpu")
    for got, w in zip(_leaves(pgrads), _leaves(want)):
        _close(got, w, 2e-3, rcfg.name)


def test_remat_on_equals_off_bitwise(family):
    """The same loss and gradients bitwise with remat on and off, and with
    the ``"dots"`` policy."""
    _, pcfg, _, pparams = family
    batch = _port_batch(_batch(pcfg, seed=1))

    def run(remat):
        loss, _, grads = PM._value_and_grad(pparams, batch, pcfg, remat=remat)
        return [loss] + padamw.tree_leaves(grads)

    off = run(False)
    on = run(True)
    PT.set_remat_policy("dots")
    try:
        dots = run(True)
    finally:
        PT.set_remat_policy("full")
    for a, b, c in zip(off, on, dots):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_train_step_matches_reference():
    rcfg = rbase.get_arch("olmoe-1b-7b").reduced()
    pcfg = pbase.get_arch("olmoe-1b-7b").reduced()
    rparams = RM.init_params(rcfg, jax.random.PRNGKey(2))
    pparams = bridge.params_from_numpy(_np(rparams), pcfg, "cpu")
    cfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    batch = _batch(rcfg, seed=5)
    rp, rs, rm = jax.jit(RM.make_train_step(rcfg, radamw.AdamWConfig(**cfg)))(
        rparams, radamw.init(rparams), _ref_batch(batch))
    pp, ps, pm = PM.make_train_step(pcfg, padamw.AdamWConfig(**cfg))(
        pparams, padamw.init(pparams), _port_batch(batch))
    for k in ("loss", "ce", "aux", "lr"):
        _close(pm[k].numpy(), np.asarray(rm[k]), 1e-5, k)
    _close(pm["grad_norm"].numpy(), np.asarray(rm["grad_norm"]), 2e-3, "gn")
    assert int(ps.step) == int(rs.step) == 1
    lr = float(rm["lr"])
    want = bridge.params_from_numpy(_np(rp), pcfg, "cpu")
    near = total = 0
    for got, w in zip(_leaves(pp), _leaves(want)):
        np.testing.assert_allclose(got, w, rtol=0, atol=2.1 * lr)
        near += int((np.abs(got - w) <= 1e-4).sum())
        total += got.size
    assert near >= 0.99 * total


def test_microbatches_match_the_full_batch():
    """The reference's test_substrate.py:227 case on the port."""
    cfg = pbase.ArchConfig(name="mb", family="dense", num_layers=2,
                           d_model=32, num_heads=4, num_kv_heads=2, d_ff=64,
                           vocab_size=128, dtype="float32")
    params = PM.init_params(cfg, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": _t(rng.integers(0, 128, (4, 8))),
             "labels": _t(rng.integers(0, 128, (4, 8)))}
    pf, _, mf = PM.make_train_step(cfg)(params, padamw.init(params), batch)
    pm, _, mm = PM.make_train_step(cfg, microbatches=2)(
        params, padamw.init(params), batch)
    for a, b in zip(_leaves(pf), _leaves(pm)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(mf["loss"]), float(mm["loss"]),
                               rtol=1e-5)


# ------------------------------------------------- data, compression --
@pytest.mark.parametrize("hosts", [1, 2])
def test_synthetic_tokens_equal_the_reference(hosts):
    for host in range(hosts):
        args = (1000, 32, 4, 1234, hosts, host)
        ref, port = RSyntheticTokens(RDataConfig(*args)), \
            SyntheticTokens(DataConfig(*args))
        for step in (0, 1, 17):
            want, got = ref.batch_at(step), port.batch_at(step)
            assert want.keys() == got.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])


def test_compress_grads_matches_reference():
    _, grads = _opt_tree(seed=7)
    rng = np.random.default_rng(8)
    err = jax.tree_util.tree_map(
        lambda g: (0.01 * rng.standard_normal(g.shape)).astype(np.float32),
        grads[0])
    rrec, rerr = rcomp.compress_grads(
        jax.tree_util.tree_map(jnp.asarray, grads[0]),
        jax.tree_util.tree_map(jnp.asarray, err))
    prec, perr = pcomp.compress_grads(_port_tree(grads[0]), _port_tree(err))
    for got, want in zip(_leaves(prec) + _leaves(perr),
                         jax.tree_util.tree_leaves((rrec, rerr))):
        _close(got, np.asarray(want), 1e-6, "compress")
    assert pcomp.compressed_bytes(_port_tree(grads[0])) == \
        rcomp.compressed_bytes(grads[0])
    zeros = pcomp.init_error_state(_port_tree(grads[0]))
    assert all(float(z.abs().sum()) == 0 for z in padamw.tree_leaves(zeros))


# ------------------------------------------------ supervisor and CLI --
def test_supervisor_run_restore_resume(tmp_path):
    """The reference's test_integration.py:18 scenario: the loss descends;
    a restore resumes at the saved step with an ``AdamWState``, and the
    run continues to the end."""
    opt_cfg = padamw.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=40)
    cfg, params, opt_state, step_fn, batch_at = ptrain.build(
        "olmoe-1b-7b", smoke=True, seq_len=32, global_batch=4,
        opt_cfg=opt_cfg, device="cpu")
    sup = TrainSupervisor(SupervisorConfig(ckpt_dir=str(tmp_path),
                                           ckpt_every=10, async_save=False))
    losses = []
    params, opt_state, step = sup.run(
        step_fn, (params, opt_state), batch_at, num_steps=20,
        on_metrics=lambda s, m: losses.append(float(m["loss"])))
    assert step == 20
    p2, o2, resumed = sup.restore((params, opt_state))
    assert resumed == 20 and isinstance(o2, padamw.AdamWState)
    assert int(o2.step) == 20 and o2.step.dtype == torch.int32
    for a, b in zip(padamw.tree_leaves((params, opt_state)),
                    padamw.tree_leaves((p2, o2))):
        assert torch.equal(a, b)
    p2, o2, step = sup.run(step_fn, (p2, o2), batch_at, num_steps=40,
                           start_step=resumed,
                           on_metrics=lambda s, m: losses.append(
                               float(m["loss"])))
    assert step == 40 and sup.restarts == 0
    assert losses[-1] < losses[0]


def test_supervisor_contains_a_crash_and_async_saves(tmp_path):
    """A step that raises once is contained: the supervisor restores the
    last (asynchronous) checkpoint and replays from its step."""
    opt_cfg = padamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=8)
    _, params, opt_state, step_fn, batch_at = ptrain.build(
        "mamba2-370m", smoke=True, seq_len=32, global_batch=2,
        opt_cfg=opt_cfg, device="cpu")
    seen = []

    def flaky(p, o, batch):
        seen.append(int(o.step))
        if len(seen) == 5:
            raise RuntimeError("preempted")
        return step_fn(p, o, batch)

    sup = TrainSupervisor(SupervisorConfig(ckpt_dir=str(tmp_path),
                                           ckpt_every=3, async_save=True))
    _, opt_state, step = sup.run(flaky, (params, opt_state), batch_at,
                                 num_steps=6)
    assert step == 6 and sup.restarts == 1 and int(opt_state.step) == 6
    assert seen == [0, 1, 2, 3, 4, 3, 4, 5]
    assert pckpt.latest_step(tmp_path) == 6


def test_checkpoint_restore_keeps_named_tuples(tmp_path):
    state = padamw.AdamWState(torch.tensor(3, dtype=torch.int32),
                              {"a": torch.ones(2)}, {"a": torch.zeros(2)})
    pckpt.save(tmp_path, 3, {"opt": state, "t": (torch.ones(1),)})
    tree, _ = pckpt.restore(tmp_path, {"opt": state, "t": (torch.ones(1),)},
                            device="cpu")
    assert isinstance(tree["opt"], padamw.AdamWState)
    assert type(tree["t"]) is tuple and int(tree["opt"].step) == 3
    saved, _ = pckpt.restore(tmp_path, device="cpu")
    assert type(saved["opt"]) is tuple


def test_train_cli_smoke_and_resume(tmp_path, capsys):
    """``main`` trains the reduced config on the CPU; ``--resume`` from
    its mid-run checkpoint replays the same steps with the same batches,
    loss for loss."""
    args = ["--arch", "mamba2-370m", "--smoke", "--steps", "8", "--seq-len",
            "64", "--global-batch", "2", "--lr", "3e-3", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "2", "--device", "cpu"]
    first = ptrain.main(args)
    assert first["step"] == 8 and len(first["losses"]) == 8
    assert first["restarts"] == 0 and first["losses"][-1] < first["losses"][0]
    (tmp_path / "LATEST").write_text("step_00000002")
    again = ptrain.main(args + ["--resume"])
    assert again["start"] == 2 and again["step"] == 8
    assert again["losses"] == first["losses"][2:]
    assert "[train] resumed at step 2" in capsys.readouterr().out


def test_opt_state_bridge_matches_reference_state():
    rcfg = rbase.get_arch("zamba2-2.7b").reduced()
    pcfg = pbase.get_arch("zamba2-2.7b").reduced()
    rparams = RM.init_params(rcfg, jax.random.PRNGKey(4))
    rstate = radamw.init(rparams, "bfloat16")
    rstate = rstate._replace(
        step=jnp.asarray(7, jnp.int32),
        m=jax.tree_util.tree_map(lambda p: jnp.full(p.shape, 0.5,
                                                    jnp.bfloat16), rparams))
    got = bridge.opt_state_from_numpy(rstate.step, _np(rstate.m),
                                      _np(rstate.v), pcfg, "cpu")
    assert isinstance(got, padamw.AdamWState) and int(got.step) == 7
    assert got.step.dtype == torch.int32
    pparams = bridge.params_from_numpy(_np(rparams), pcfg, "cpu")
    for p, m, v in zip(padamw.tree_leaves(pparams),
                       padamw.tree_leaves(got.m), padamw.tree_leaves(got.v)):
        assert m.shape == p.shape and m.dtype == torch.bfloat16
        assert float(m.float().min()) == float(m.float().max()) == 0.5
        assert float(v.float().abs().max()) == 0.0


def test_train_config_is_the_full_width_one_without_smoke(monkeypatch):
    """``build`` without smoke takes the registered config as it is (the
    card's full width); with smoke its reduced one."""
    seen = []
    monkeypatch.setattr(PM, "init_params",
                        lambda cfg, seed=0, device="cuda": seen.append(cfg)
                        or {"embed": {"table": torch.zeros(1)}})
    opt_cfg = padamw.AdamWConfig()
    full = ptrain.build("mamba2-370m", False, 64, 2, opt_cfg, device="cpu")[0]
    smoke = ptrain.build("mamba2-370m", True, 64, 2, opt_cfg, device="cpu")[0]
    assert full == pbase.get_arch("mamba2-370m")
    assert smoke == pbase.get_arch("mamba2-370m").reduced()
    assert [c.name for c in seen] == [full.name, smoke.name]
