"""The four registered archs no other CPU test serves at a shape of their
own, granite-3-8b, mistral-nemo-12b, starcoder2-15b and kimi-k2-1t-a32b,
against the JAX package's model and server.

Each runs at its reduced config with the one trait its full width has
and ``reduced()`` erases put back (``dataclasses.replace`` on both
sides, as tests/test_torch_model.py's ``yi_gqa`` fixture does, so
neither registry changes):

* granite-3-8b: a d_ff that is no power of two, so the tiles do not
  divide it evenly (12,800 at full width; 320 here);
* mistral-nemo-12b: an attention width H x hd below d_model (4096 beside
  5120; 128 beside 160 here);
* starcoder2-15b: 12 query heads a KV head (48:4; 12:1 here);
* kimi-k2-1t-a32b: head dim 112 on the flash path.

Compared: ``make_prefill`` under an LBM plan with native K/V and an LWM
plan with int8 K/V (the reference's Pallas kernels in interpret mode;
1e-4 and 2e-3, as tests/test_torch_model.py: absolute for the dense
archs, relative to the logits' largest magnitude for the MoE one, as
tests/test_torch_moe.py::_close holds MoE logits), eight teacher-forced
decode steps under each plan kind (greedy tokens equal, logits within
1e-4), and a served resident and arrival whose grants, plans, chunks,
reservations, NEC counters and tokens equal the reference server's, the
port handed the reference's params and prompts.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as rplan
from repro.core.allocator import Selection as RSelection
from repro.core.mct import MappingCandidate as RCandidate
from repro.launch import serve as RS
from repro.models import base as rbase
from repro.models import model as RM
from repro.models import transformer as RT
from repro.sim.driver import TenantSpec as RSpec
from repro_torch import bridge
from repro_torch.core import plan as pplan
from repro_torch.core.allocator import Selection as PSelection
from repro_torch.core.mct import MappingCandidate as PCandidate
from repro_torch.launch import serve as PS
from repro_torch.models import base as pbase
from repro_torch.models import model as PM
from repro_torch.models import transformer as PT
from repro_torch.sim.driver import TenantSpec as PSpec

ATOL = RTOL = 1e-4
B, MAX_LEN = 2, 64
# arch -> the reduced config's change that keeps its full-width trait
TRAITS = {"granite-3-8b": dict(d_ff=320),
          "mistral-nemo-12b": dict(d_model=160),
          "starcoder2-15b": dict(num_heads=12, num_kv_heads=1),
          "kimi-k2-1t-a32b": dict(head_dim=112)}
ARCHS = list(TRAITS)
SERVER = dict(batch=1, max_len=128, epoch_len=4, total_pages=32)
ARRIVAL = dict(arrive_at=4.0, prompt_len=96, n_inferences=8)
STEPS = 16


def _cfgs(arch):
    """(reference, port) configs of ``arch``: reduced, its trait kept."""
    return (dataclasses.replace(rbase.get_arch(arch).reduced(), **TRAITS[arch]),
            dataclasses.replace(pbase.get_arch(arch).reduced(), **TRAITS[arch]))


@functools.lru_cache(maxsize=None)
def _model(arch, seed=1):
    rcfg, pcfg = _cfgs(arch)
    rparams = RM.init_params(rcfg, jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    return rcfg, pcfg, rparams, bridge.params_from_numpy(tree, pcfg, "cpu")


@functools.lru_cache(maxsize=None)
def _ref_fns():
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


def _close(got, want, tol, moe):
    """Within ``tol``: absolute and relative for a dense arch (as
    tests/test_torch_model.py), for an MoE arch the absolute part scaled
    by the largest |logit| (tests/test_torch_moe.py::_close)."""
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max())) if moe else 1.0
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=tol * scale, rtol=tol)


def _prompt(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n),
                                                dtype=np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_keeps_the_full_width_trait(arch):
    """The trait holds at full width and in the test's config, and
    ``reduced()`` alone erases it."""
    def trait(c):
        return {"granite-3-8b": c.d_ff & (c.d_ff - 1) != 0,
                "mistral-nemo-12b": c.num_heads * c.hd < c.d_model,
                "starcoder2-15b": c.num_heads // c.num_kv_heads == 12,
                "kimi-k2-1t-a32b": c.hd == 112}[arch]
    full = pbase.get_arch(arch)
    rcfg, pcfg = _cfgs(arch)
    assert trait(full) and trait(pcfg) and not trait(full.reduced())
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(pcfg)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind,kv_dtype", [("LBM", "native"), ("LWM", "int8")])
def test_make_prefill_with_plan_matches_reference(arch, kind, kv_dtype):
    """One-shot prefill under a plan (flash attention with the plan's
    blocks and K/V precision, the FFN or every expert's FFN through the
    granted kernel) against the reference's, a 48-token prompt (ragged
    flash tiles); the plain prefill too.  At hd 112 (kimi-k2) the port's
    legalization raised before the flash menu had that head dim.  Its
    int8 plan's logits (up to 114 in size) differ from the reference's by
    up to 0.011 where a K or V value computed in another summation order
    lands on the other int8 step: within 2e-3 of the largest."""
    rcfg, pcfg, rparams, pparams = _model(arch)
    rp, pp = _plans(kind, rcfg, kv_dtype)
    toks = _prompt(rcfg, 48, seed=3)
    want = RM.make_prefill(rcfg)(rparams, {"tokens": jnp.asarray(toks)}, rp)
    batch = {"tokens": torch.from_numpy(toks).long()}
    got = PM.make_prefill(pcfg)(pparams, batch, pp)
    assert got.shape == (B, pcfg.padded_vocab)
    moe = pcfg.is_moe
    _close(got.numpy(), want, ATOL if kv_dtype == "native" else 2e-3, moe)
    if kv_dtype == "native":
        plain = PM.make_prefill(pcfg)(pparams, batch)
        _close(plain.numpy(), RM.make_prefill(rcfg)(
            rparams, {"tokens": jnp.asarray(toks)}), ATOL, moe)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", ["LBM", "LWM"])
def test_decode_epoch_teacher_forced_matches_reference(arch, kind):
    """8 decode steps under one plan after a 16-token prompt chunk: the
    port's ``decode_epoch`` fed the reference's tokens gives its greedy
    tokens and logits."""
    rcfg, pcfg, rparams, pparams = _model(arch)
    rdec, rpf = _ref_fns()
    rp, pp = _plans(kind, rcfg)
    prompt, forced = _prompt(rcfg, 16), _prompt(rcfg, 9, seed=2)
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


class _Registered:
    """What a server's ``get_arch`` returns for a test arch: its
    ``reduced()`` is the trait-keeping config."""

    def __init__(self, cfg):
        self._cfg = cfg

    def reduced(self):
        return self._cfg


@functools.lru_cache(maxsize=None)
def _served(arch):
    """The reference's and the port's server on one scenario, a resident
    and a 96-token arrival of ``arch`` in a 32-page pool, each run for
    16 steps; the port handed the reference's params and prompts.
    Both servers look the arch up through a ``get_arch`` that gives its
    trait-keeping config for the run."""
    rcfg, pcfg = _cfgs(arch)
    ref_params = {}

    def params_fn(cfg, pkey):
        if pkey not in ref_params:
            ref_params[pkey] = jax.tree_util.tree_map(
                np.asarray, RM.init_params(rcfg, jax.random.PRNGKey(pkey)))
        return bridge.params_from_numpy(ref_params[pkey], cfg, "cpu")

    def prompt_fn(spec, i, cfg, batch):
        return RS._prompt_tokens(RSpec(arch, prompt_len=spec.prompt_len), i,
                                 rcfg, batch)

    with pytest.MonkeyPatch.context() as mp:
        for module, cfg in ((RS, rcfg), (PS, pcfg)):
            real = module.get_arch
            mp.setattr(module, "get_arch",
                       lambda aid, real=real, cfg=cfg:
                       _Registered(cfg) if aid == arch else real(aid))
        ref = RS.MultiTenantServer([arch], tenants=[RSpec(arch, **ARRIVAL)],
                                   **SERVER)
        ref_out = ref.run(steps=STEPS)
        port = PS.MultiTenantServer([arch], tenants=[PSpec(arch, **ARRIVAL)],
                                    device="cpu", params_fn=params_fn,
                                    prompt_fn=prompt_fn, **SERVER)
        port_out = port.run(steps=STEPS)
    return ref, ref_out, port, port_out


@pytest.mark.parametrize("arch", ARCHS)
def test_served_tenants_match_reference(arch):
    """A resident and an arrival served by the port's MultiTenantServer:
    per-tenant grants, plan sequences, prompt chunks, KV reservations,
    the NEC counters and the token streams equal the reference
    server's, and both tenants ran at the test config's widths."""
    ref, ref_out, port, port_out = _served(arch)
    _, pcfg = _cfgs(arch)
    assert [t.tid for t in ref.tenants] == [t.tid for t in port.tenants]
    for r, p in zip(ref.tenants, port.tenants):
        assert dataclasses.asdict(p.cfg) == dataclasses.asdict(pcfg)
        assert p.choices == r.choices, p.tid
        assert ([x.describe() for x in p.plans]
                == [x.describe() for x in r.plans]), p.tid
        assert p.chunks == r.chunks, p.tid
        assert (p.kv_wanted, p.kv_reserved) == (r.kv_wanted, r.kv_reserved)
        rr, pr = ref_out["tenants"][r.tid], port_out["tenants"][p.tid]
        for key in ("tokens", "choices", "prefill_chunks", "lbm_frac"):
            assert pr[key] == rr[key], (p.tid, key)
        np.testing.assert_array_equal(pr["output"], rr["output"],
                                      err_msg=p.tid)
    resident, arrival = port.tenants
    assert sum(arrival.chunks) == ARRIVAL["prompt_len"]
    assert port_out["tenants"][arrival.tid]["output"].shape == (
        1, 1 + ARRIVAL["n_inferences"])
    assert port_out["dram_bytes"] == ref_out["dram_bytes"] > 0
    assert (dataclasses.astuple(port.nec.traffic)
            == dataclasses.astuple(ref.nec.traffic))
    assert port.cache.free_pages == ref.cache.free_pages
