"""The port's device-index epochs (dense, int8 KV, mamba2 and MoE),
batched bucket epoch and program cache against the JAX package's, at
reduced widths on the CPU.

On the card the server captures each decode item and prompt chunk as a
CUDA graph; on the CPU the same entries hold eager closures, so the
cache mechanics (keys, hits, misses, evictions, departures, the AOT key
walk) are held here and graph replay against eager dispatch in
``tests/test_torch_gpu.py``.  Models are the reduced fp32 configs with
the reference's params handed over through ``repro_torch.bridge``;
token streams and scheduling traces must be equal, port against port
bitwise.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as RS
from repro.models import base as rbase
from repro.models import model as RM
from repro.models import transformer as RT
from repro.sim.driver import TenantSpec as RSpec
from repro_torch import bridge
from repro_torch.kernels import counters as kcount
from repro_torch.launch import serve as PS
from repro_torch.models import base as pbase
from repro_torch.models import model as PM
from repro_torch.models import transformer as PT
from repro_torch.sim.driver import TenantSpec as PSpec

B, MAX_LEN, PROMPT, K = 2, 32, 8, 4
CASES = [("yi-9b", "native"), ("yi-9b", "int8"), ("mamba2-370m", "native"),
         ("olmoe-1b-7b", "native")]


@functools.lru_cache(maxsize=None)
def _model(arch, seed=1):
    rcfg = rbase.get_arch(arch).reduced()
    pcfg = pbase.get_arch(arch).reduced()
    rparams = RM.init_params(rcfg, jax.random.PRNGKey(seed))
    pparams = bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, rparams), pcfg, "cpu")
    return rcfg, pcfg, rparams, pparams


def _tokens(cfg, n, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n))


def _kv(kv):
    return None if kv == "native" else kv


def _clone(caches):
    return [{k: v.clone() for k, v in c.items()} for c in caches]


def _caches_equal(a, b):
    return all(x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)
               for x, y in zip(a, b))


# ------------------------------------------------ device-index epochs --
@pytest.mark.parametrize("arch,kv", CASES)
def test_device_index_epoch_matches_reference_epoch(arch, kv):
    """A prompt prefilled at a device position, then two epochs at device
    positions: the greedy tokens equal the reference's ``decode_epoch``
    (its traced int32 index) at every step."""
    rcfg, pcfg, rparams, pparams = _model(arch)
    prompt = _tokens(pcfg, PROMPT, seed=3)
    repoch = jax.jit(RM.make_decode_epoch(rcfg), static_argnames=("plan", "k"))
    rpf = jax.jit(RM.make_prefill_chunk(rcfg))
    rc = RT.init_caches(rparams, rcfg, B, MAX_LEN, kv_dtype=_kv(kv))
    rtok, rc = rpf(rparams, rc, jnp.asarray(prompt, jnp.int32),
                   jnp.int32(0))
    want = [np.asarray(rtok)]
    for i in range(2):
        toks, rc = repoch(rparams, rc, rtok, jnp.int32(PROMPT + i * K), k=K)
        want.append(np.asarray(toks))
        rtok = toks[:, -1:]

    pc = PT.init_caches(pparams, pcfg, B, MAX_LEN, kv_dtype=_kv(kv),
                        device="cpu")
    index = torch.zeros((), dtype=torch.long)
    ptok, _ = PM.make_prefill_chunk(pcfg)(
        pparams, pc, torch.from_numpy(prompt).long(), index)
    index += PROMPT
    got = [ptok.numpy()]
    epoch = PM.make_decode_epoch(pcfg)
    for _ in range(2):
        toks, _ = epoch(pparams, pc, ptok, index, k=K)
        got.append(toks.numpy())
        ptok = toks[:, -1:]
        index += K
    np.testing.assert_array_equal(np.concatenate(got, 1),
                                  np.concatenate(want, 1))


@pytest.mark.parametrize("arch,kv", CASES)
def test_device_index_epoch_matches_steps_bitwise(arch, kv):
    """One epoch at a device position equals k decode steps at host
    positions, tokens and every cache buffer bitwise; the caches are
    written in place (every buffer keeps its address)."""
    _, pcfg, _, pparams = _model(arch)
    prompt = torch.from_numpy(_tokens(pcfg, PROMPT, seed=4)).long()
    pc = PT.init_caches(pparams, pcfg, B, MAX_LEN, kv_dtype=_kv(kv),
                        device="cpu")
    tok, _ = PM.make_prefill_chunk(pcfg)(pparams, pc, prompt, 0)
    steps = _clone(pc)
    ptrs = [[v.data_ptr() for v in c.values()] for c in pc]
    got, _ = PM.make_decode_epoch(pcfg)(
        pparams, pc, tok, torch.tensor(PROMPT), k=K)
    assert [[v.data_ptr() for v in c.values()] for c in pc] == ptrs
    step = PM.make_decode_step(pcfg)
    want, t = [], tok
    for i in range(K):
        nxt, steps = step(pparams, steps, t, PROMPT + i)
        want.append(nxt)
        t = nxt[:, None]
    assert torch.equal(got, torch.stack(want, 1))
    assert _caches_equal(pc, steps)


@pytest.mark.parametrize("arch", ["yi-9b", "mamba2-370m", "olmoe-1b-7b"])
def test_batched_epoch_matches_single_and_reference(arch):
    """Mirrors test_serve_pipeline.py::
    test_bucketed_batched_decode_matches_single: two same-arch tenants
    (different params) in one batched epoch match their own epochs
    bitwise, tokens [n, B, k] and caches, and the reference's vmapped
    bucket in tokens."""
    k = 3
    models = [_model(arch, seed=10 + i) for i in range(2)]
    rcfg, pcfg = models[0][0], models[0][1]
    epoch = PM.make_decode_epoch(pcfg)
    singles = []
    for _, _, _, pp in models:
        c = PT.init_caches(pp, pcfg, 1, 16, device="cpu")
        toks, c = epoch(pp, c, torch.zeros((1, 1), dtype=torch.long),
                        torch.zeros((), dtype=torch.long), k=k)
        singles.append((toks, c))
    caches = [PT.init_caches(m[3], pcfg, 1, 16, device="cpu") for m in models]
    btoks, bcaches = PM.make_decode_epoch_batched(pcfg)(
        [m[3] for m in models], caches,
        torch.zeros((2, 1, 1), dtype=torch.long),
        torch.zeros((2,), dtype=torch.long), k=k)
    assert btoks.shape == (2, 1, k)
    for i, (toks, c) in enumerate(singles):
        assert torch.equal(btoks[i], toks)
        assert _caches_equal(bcaches[i], c)

    stack = lambda *xs: jnp.stack(xs)  # noqa: E731
    sp = jax.tree_util.tree_map(stack, *[m[2] for m in models])
    sc = jax.tree_util.tree_map(
        stack, *[RT.init_caches(m[2], rcfg, 1, 16) for m in models])
    want, _ = jax.jit(RM.make_decode_epoch_batched(rcfg),
                      static_argnames=("plan", "k"))(
        sp, sc, jnp.zeros((2, 1, 1), jnp.int32), jnp.zeros((2,), jnp.int32),
        k=k)
    np.testing.assert_array_equal(btoks.numpy(), np.asarray(want))


# ---------------------------------------------------- program cache --
def test_lru_cache_mechanics():
    """Mirrors test_host_overlap.py::test_lru_cache_mechanics."""
    c = PS._LruCache(2)
    c["a"] = 1
    c["b"] = 2
    assert c.get("a") == 1          # refreshes "a": "b" is now LRU
    c["c"] = 3
    assert "b" not in c
    assert "a" in c and "c" in c
    assert c.evictions == 1
    assert c.hits == 1
    assert c.get("b") is None
    assert c.misses == 1
    assert c.peek("a") == 1 and (c.hits, c.misses) == (1, 1)
    assert c.pop("a") == 1 and c.keys() == ["c"]


def test_launch_counters_roundtrip():
    """kernels/counters.py: a delta added and taken back leaves every
    count as it was; add() moves totals and kinds alike."""
    base = kcount.snapshot()
    bump = {"cache_matmul": 3, "cache_matmul.gemv": 3, "ssd_chunk": 1,
            "ssd_chunk.wgmma": 1}
    kcount.add(bump)
    assert kcount.delta(base) == bump
    kcount.add(bump, -1)
    assert kcount.snapshot() == base


WARM = dict(batch=1, max_len=64, total_pages=128, epoch_len=4, device="cpu")


@pytest.fixture(scope="module")
def warmed_server():
    """A bucket of two yi-9b residents beside a mamba2 one, with one run
    behind it: every program the replay needs is built and cached."""
    srv = PS.MultiTenantServer(["yi-9b", "yi-9b", "mamba2-370m"], **WARM)
    srv.run(8)
    return srv


def test_warm_replay_builds_nothing_new(warmed_server):
    """Mirrors test_host_overlap.py: a warm second run builds no program
    (``epoch_compiles`` all 0), only hits, no evictions."""
    srv = warmed_server
    misses = (srv._fused_jits.misses, srv._prefill_jits.misses)
    hits = srv._fused_jits.hits
    out = srv.run(8)
    h = out["host"]
    assert h["epochs"] > 0
    assert h["epoch_compiles"] == [0] * h["epochs"]
    assert (srv._fused_jits.misses, srv._prefill_jits.misses) == misses
    assert srv._fused_jits.hits > hits
    assert h["jit_cache"]["fused"]["evictions"] == 0
    assert h["captures"] == 0 and h["departure_evictions"] == 0
    kinds = {key[0] for key in srv._fused_jits.keys()}
    assert kinds == {"bucket", "single"}


def test_host_and_device_positions_agree(warmed_server):
    """The host position (scheduling) and the device position (advanced
    by the programs) agree after a run, and the log holds what the run
    reports."""
    out = warmed_server.run(4)
    for t in warmed_server.tenants:
        assert int(t.index_dev) == t.index > 0
        np.testing.assert_array_equal(
            out["tenants"][t.tid]["output"], t.log[:, :t.index].numpy())


def test_departure_evicts_programs_before_freeing_buffers():
    """A tenant that spends its budget departs: every program naming it
    leaves both caches (counted apart from the LRU's evictions) while
    its buffers still exist, and its served tokens survive."""
    srv = PS.MultiTenantServer(
        ["yi-9b"], tenants=[PSpec("yi-9b", arrive_at=2.0, prompt_len=16,
                                  n_inferences=4)], **WARM)
    seen = []
    evict = srv._evict_programs

    def spy(tid):
        t = next(t for t in srv.tenants if t.tid == tid)
        seen.append((tid, t.caches is not None, t.log is not None))
        evict(tid)
    srv._evict_programs = spy
    out = srv.run(16)
    gone = "t1:yi-9b"
    assert seen == [(gone, True, True)]
    t = srv.tenants[1]
    assert t.departed and t.log is None and t.caches is None
    assert out["tenants"][gone]["output"].shape == (1, 5)
    assert not any(gone in key[5] for key in srv._fused_jits.keys())
    assert not any(key[0] == gone for key in srv._prefill_jits.keys())
    assert out["host"]["departure_evictions"] >= 2
    assert out["host"]["jit_cache"]["fused"]["evictions"] == 0


# ------------------------------------------------------------- AOT --
AOT_KW = dict(batch=1, max_len=64, total_pages=128, epoch_len=4)
AOT_RESIDENTS = ["yi-9b", "yi-9b", "mamba2-370m"]
AOT_PROMPT = dict(prompt_len=40, n_inferences=8)


def _strip(epoch_keys):
    """Epoch keys as comparable tuples: plans by ``describe()``, tenant
    ids dropped (the port's items carry them, the reference's do not)."""
    return [tuple((kind, name, plan.describe() if plan is not None else None,
                   k, kv) for kind, name, plan, k, kv, *_ in key)
            for key in epoch_keys]


def test_aot_keys_equal_reference():
    """The port's predicted epoch keys, stripped of tenant ids, equal the
    reference's ``_enumerate_epoch_keys`` on the same scenario (a bucket
    of two residents, a mamba2 resident and a prompt tenant whose prefill
    delays its start), and each item's ids name its tenants."""
    ref = RS.MultiTenantServer(AOT_RESIDENTS, tenants=[
        RSpec("yi-9b", **AOT_PROMPT)], **AOT_KW)
    port = PS.MultiTenantServer(AOT_RESIDENTS, tenants=[
        PSpec("yi-9b", **AOT_PROMPT)], device="cpu", **AOT_KW)
    want = ref._enumerate_epoch_keys(16)
    got = port._enumerate_epoch_keys(16)
    assert len(want) > 1
    assert _strip(got) == _strip(want)
    arch = {t.tid: t.cfg.name for t in port.tenants}
    for key in got:
        for kind, name, _, _, _, tids in key:
            assert {arch[tid] for tid in tids} == {name}
            assert (len(tids) >= 2) == (kind == "bucket")


def test_aot_warmup_leaves_tokens_and_traces_unchanged():
    """``aot_warmup=True`` builds the predicted programs before the first
    epoch (and at an arrival) and changes neither the tokens nor the
    grant trace; its predictions are hits."""
    outs, srvs = [], []
    for aot in (False, True):
        srv = PS.MultiTenantServer(
            AOT_RESIDENTS, tenants=[PSpec("yi-9b", **AOT_PROMPT),
                                    PSpec("yi-9b", arrive_at=4.0,
                                          prompt_len=16, n_inferences=4)],
            device="cpu", aot_warmup=aot, **AOT_KW)
        outs.append(srv.run(12))
        srvs.append(srv)
    plain, aot = outs
    for tid, p in plain["tenants"].items():
        a = aot["tenants"][tid]
        np.testing.assert_array_equal(a["output"], p["output"], err_msg=tid)
        assert a["choices"] == p["choices"] and a["plans"] == p["plans"]
    assert aot["host"]["aot_compiled"] > 0 == plain["host"]["aot_compiled"]
    assert aot["host"]["aot_failed"] == 0
    assert aot["host"]["aot_hits"] > 0 == plain["host"]["aot_hits"]
    assert srvs[1]._fused_jits.misses < srvs[0]._fused_jits.misses
