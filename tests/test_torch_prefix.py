"""Prefix-hash KV dedup in the port's server against the JAX package's.

Mirrors the single-server contracts of tests/test_prefix_cache.py at the
reduced configs (fp32), with the reference's params and prompts injected
(``params_fn`` / ``prompt_fn``):

* a session-replay workload (olmoe-1b-7b, two sessions on one system
  prompt, two turns) served with dedup on and off: the port's grants,
  plans, prefill chunks, ``prefix_hit`` per tenant, ``prefix`` stats and
  token streams equal the reference's, on and off; on vs off is bitwise
  in the port, warm arrivals prefill only their private suffix;
* a full-prompt re-arrival skips prefill (no chunks, nothing computed)
  and decodes the producer's stream bit for bit, on olmoe (the
  reference's test) and on mamba2 (the SSM state adopted whole);
* the same workload on yi-9b with int8 KV (codes and scales seeded);
* ``seed_caches_from_prefix`` against the reference's on caches the
  reference's prefill filled: native, int8 and fp8 KV, and SSM state;
* the session prompt streams: a longer turn extends a shorter one,
  sessions on one system prompt share it, and the probe list and params
  key equal the reference's.

Scheduled at full width without weights (``torch_dry_run``):
``chip_smoke.py``'s ``serve_prefix`` workload, its chunks and its warm
arrivals at the reference's clock rate and at the phase's.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as RS
from repro.models import model as RM
from repro.models import transformer as RT
from repro.models.base import get_arch as ref_arch
from repro.sim.driver import SessionArrivals as RSessions
from repro.sim.driver import TenantSpec as RSpec
from repro_torch.bridge import caches_from_numpy, params_from_numpy
from repro_torch.launch import serve as PS
from repro_torch.models import transformer as PT
from repro_torch.models.base import get_arch as port_arch
from repro_torch.sim.driver import SessionArrivals as PSessions
from repro_torch.sim.driver import TenantSpec as PSpec
from torch_dry_run import dry_server

STEPS = 24
SESSION = dict(n_sessions=2, turns=2, n_prompts=1, prefix_len=256,
               turn_tokens=128, gap_s=4.0, n_inferences=6, seed=0)
SERVER = dict(batch=1, max_len=640, total_pages=128, epoch_len=8,
              steps_per_s=4.0)
_REF_PARAMS = {}


def _ref_cfg(cfg):
    return ref_arch(cfg.name.removesuffix("-smoke")).reduced()


def _ref_params(cfg, pkey):
    key = (cfg.name, pkey)
    if key not in _REF_PARAMS:
        tree = RM.init_params(_ref_cfg(cfg), jax.random.PRNGKey(pkey))
        _REF_PARAMS[key] = jax.tree_util.tree_map(np.asarray, tree)
    return params_from_numpy(_REF_PARAMS[key], cfg, "cpu")


def _ref_prompt(spec, i, cfg, batch):
    """The reference's prompt tokens for a port spec, session fields
    included."""
    rspec = RSpec(spec.model, prompt_len=spec.prompt_len,
                  prompt_seed=spec.prompt_seed, prefix_len=spec.prefix_len,
                  prefix_seed=spec.prefix_seed)
    return RS._prompt_tokens(rspec, i, _ref_cfg(cfg), batch)


def _port(specs, **kw):
    return PS.MultiTenantServer([], tenants=specs, device="cpu",
                                params_fn=_ref_params, prompt_fn=_ref_prompt,
                                **kw)


def _trace(srv):
    return {t.tid: (t.choices, [p.describe() for p in t.plans], t.chunks,
                    t.prefix_hit, t.kv_wanted, t.kv_reserved)
            for t in srv.tenants}


def _outputs(out):
    return {tid: info["output"] for tid, info in out["tenants"].items()}


def _assert_same_tokens(a, b):
    assert set(a) == set(b)
    for tid in a:
        np.testing.assert_array_equal(a[tid], b[tid], err_msg=tid)


# ------------------------------------------------- session replay --
@pytest.fixture(scope="module", params=[("olmoe-1b-7b", "native"),
                                        ("yi-9b", "int8")],
                ids=["olmoe", "yi-int8"])
def sessions(request):
    arch, kv = request.param
    runs = {}
    for on in (True, False):
        ref = RS.MultiTenantServer(
            [], tenants=RSessions(models=[arch], **SESSION).specs(),
            prefix_dedup=on, kv_dtype=kv, **SERVER)
        port = _port(PSessions(models=[arch], **SESSION).specs(),
                     prefix_dedup=on, kv_dtype=kv, **SERVER)
        runs[on] = ((ref, ref.run(STEPS)), (port, port.run(STEPS)))
    return runs


def test_session_trace_equals_reference(sessions):
    for on in (True, False):
        (ref, ref_out), (port, port_out) = sessions[on]
        assert [t.tid for t in port.tenants] == [t.tid for t in ref.tenants]
        assert _trace(port) == _trace(ref)
        assert port_out["prefix"] == ref_out["prefix"]
        assert port_out["prefill_computed"] == ref_out["prefill_computed"]
        assert port.cache.free_pages == ref.cache.free_pages
        for tid, r in ref_out["tenants"].items():
            p = port_out["tenants"][tid]
            for key in ("tokens", "prefix_hit", "prefill_chunks",
                        "prefill_computed", "kv_dtype", "state"):
                assert p[key] == r[key], (tid, key)


def test_session_tokens_equal_reference(sessions):
    for on in (True, False):
        (_, ref_out), (_, port_out) = sessions[on]
        _assert_same_tokens(_outputs(port_out), _outputs(ref_out))


def test_session_dedup_bit_identical_and_saves(sessions):
    """test_prefix_cache.py::test_session_replay_dedup_bit_identical_and
    _saves, on the port."""
    (_, a), (_, b) = sessions[True][1], sessions[False][1]
    _assert_same_tokens(_outputs(a), _outputs(b))
    warm = [tid for tid, i in a["tenants"].items() if i["prefix_hit"] > 0]
    assert len(warm) >= 2, a["prefix"]
    assert a["prefill_computed"] < b["prefill_computed"]
    assert a["prefix"]["hits"] >= 2
    assert b["prefix"]["hits"] == 0 and b["prefix"]["entries"] == 0
    assert a["host"]["snapshot_bytes"] > 0 == b["host"]["snapshot_bytes"]
    for tid in warm:
        ai, bi = a["tenants"][tid], b["tenants"][tid]
        assert ai["prefill_computed"] < bi["prefill_computed"]
        assert sum(ai["prefill_chunks"]) == \
            ai["prompt_len"] - ai["prefix_hit"]


# ----------------------------------------------- full re-arrival --
def _rearrival(spec_cls, arch):
    def spec(at):
        return spec_cls(arch, arrive_at=at, n_inferences=6, prompt_len=256,
                        param_seed=5, prompt_seed=7, prefix_len=256,
                        prefix_seed=3)
    return [spec(0.0), spec(4.0)]


REARRIVAL = dict(batch=1, max_len=512, total_pages=128, epoch_len=8,
                 steps_per_s=4.0)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-370m"])
def test_full_prompt_rearrival_skips_prefill(arch):
    """test_prefix_cache.py::test_full_prompt_rearrival_skips_prefill on
    the port, against the reference's run; mamba2 adopts the stored
    state whole."""
    ref = RS.MultiTenantServer([], tenants=_rearrival(RSpec, arch),
                               prefix_dedup=True, **REARRIVAL)
    port = _port(_rearrival(PSpec, arch), prefix_dedup=True, **REARRIVAL)
    ref_out, out = ref.run(STEPS), port.run(STEPS)
    prod = out["tenants"][f"t0:{arch}"]
    warm = out["tenants"][f"t1:{arch}"]
    assert prod["prefix_hit"] == 0 and sum(prod["prefill_chunks"]) == 256
    assert warm["prefix_hit"] == 256
    assert warm["prefill_chunks"] == []
    assert warm["prefill_computed"] == 0
    assert warm["ttft_s"] is not None
    assert warm["tokens"] == 1 + 6
    np.testing.assert_array_equal(prod["output"], warm["output"])
    assert _trace(port) == _trace(ref)
    assert out["prefix"] == ref_out["prefix"]
    _assert_same_tokens(_outputs(out), _outputs(ref_out))


# --------------------------------------------------- the seeder --
SEED_PROMPT, SEED_LEN = 48, 32


@pytest.mark.parametrize("arch, kv", [("yi-9b", "native"), ("yi-9b", "int8"),
                                      ("yi-9b", "fp8_e4m3"),
                                      ("mamba2-370m", "native")])
def test_seed_caches_from_prefix_equals_reference(arch, kv):
    """Caches the reference's prefill filled, seeded by both packages:
    the port's functional and in-place seeders give the reference's
    result bit for bit (K/V rows below the prefix, zeros and unit scales
    past it; SSM state adopted whole)."""
    rcfg, pcfg = ref_arch(arch).reduced(), port_arch(arch).reduced()
    B, T = 1, 64
    params = RM.init_params(rcfg, jax.random.PRNGKey(0))
    caches = RT.init_caches(params, rcfg, B, T, kv_dtype=kv)
    toks = jax.random.randint(jax.random.PRNGKey(1), (B, SEED_PROMPT), 0,
                              rcfg.vocab_size)
    _, caches = RT.prefill_chunk(params, toks, caches, jnp.int32(0), rcfg,
                                 kv_len=T)
    p = SEED_PROMPT if arch.startswith("mamba") else SEED_LEN
    want = RT.seed_caches_from_prefix(rcfg, B, T, caches, p, kv_dtype=kv)
    np_tree = jax.tree_util.tree_map(np.asarray, caches)
    want = caches_from_numpy(jax.tree_util.tree_map(np.asarray, want), pcfg,
                             "cpu")
    snap = caches_from_numpy(np_tree, pcfg, "cpu")
    got = PT.seed_caches_from_prefix(pcfg, B, T, snap, p, kv_dtype=kv)
    inplace = PT.init_caches(None, pcfg, B, T, kv_dtype=kv, device="cpu")
    assert PT.seed_caches_in_place(pcfg, inplace, snap, p) is inplace
    if arch == "yi-9b":
        # a snapshot cut to the prompt's rows seeds the same
        cut = [{n: leaf[:, :SEED_PROMPT].clone() for n, leaf in layer.items()}
               for layer in snap]
        cut = PT.seed_caches_from_prefix(pcfg, B, T, cut, p, kv_dtype=kv)
    else:
        cut = got
    for g, w, i, c in zip(got, want, inplace, cut):
        assert set(g) == set(w)
        for name in w:
            for x in (g[name], i[name], c[name]):
                assert x.dtype == w[name].dtype and x.shape == w[name].shape
                assert torch.equal(_bits(x), _bits(w[name])), name


def _bits(x):
    return x.contiguous().view(torch.uint8)


# ------------------------------------------------- session prompts --
def test_session_prompts_extend_and_share():
    cfg = port_arch("yi-9b").reduced()
    a = PSpec("yi-9b", prompt_len=384, param_seed=1, prompt_seed=7,
              prefix_len=256, prefix_seed=2)
    b = PSpec("yi-9b", prompt_len=512, param_seed=1, prompt_seed=7,
              prefix_len=256, prefix_seed=2)
    c = PSpec("yi-9b", prompt_len=384, param_seed=1, prompt_seed=8,
              prefix_len=256, prefix_seed=2)
    pa, pb, pc = (PS._prompt_tokens(s, 0, cfg, 2) for s in (a, b, c))
    assert pa.dtype == np.int32 and pa.shape == (2, 384)
    np.testing.assert_array_equal(pb[:, :384], pa)        # turn extends
    np.testing.assert_array_equal(pc[:, :256], pa[:, :256])  # shared prefix
    assert not np.array_equal(pc[:, 256:], pa[:, 256:])
    assert pa.min() >= 0 and pa.max() < cfg.vocab_size
    # legacy specs keep the admission-indexed stream
    legacy = PS._prompt_tokens(PSpec("yi-9b", prompt_len=16), 3, cfg, 2)
    np.testing.assert_array_equal(legacy, np.random.default_rng(7919 + 3)
                                  .integers(0, cfg.vocab_size, (2, 16),
                                            dtype=np.int32))


def test_probe_list_and_params_key_equal_reference():
    prompt = np.arange(2 * 300, dtype=np.int32).reshape(2, 300)
    for align in (128, 256):
        assert (PS._prefix_candidates(prompt, 300, align)
                == RS._prefix_candidates(prompt, 300, align))
    for kv in ("native", "int8", "fp8_e4m3"):
        assert (PS._params_key(PSpec("yi-9b", param_seed=4), kv)
                == RS._params_key(RSpec("yi-9b", param_seed=4), kv))


# ------------------------------------ full width, scheduling only --
def _chip_smoke():
    """chip_smoke.py's phase constants (the module imports no torch at
    load time)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_consts", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_full_width_session_schedule(monkeypatch):
    """chip_smoke.py's ``serve_prefix`` workload, scheduled at full
    width: the grants lower every prompt chunk to 128 tokens, at a
    prefill chunk of 128 and of 256 alike, so a 640-token producer
    prefills in five epochs (so the phase runs only its chunk of 128:
    256 would repeat it); at the reference's 4 steps/s the arrival gaps
    are shorter and one arrival is warm, at the phase's 8 steps/s four
    are.  The pool holds every reservation: nothing is evicted."""
    sp = _chip_smoke().SERVE_PREFIX
    cfg = port_arch(sp["arch"])

    def specs():
        return PSessions(models=[sp["arch"]], **sp["sessions"]).specs()
    pages = sp["headroom"] + sum(PS._kv_reserve_pages(cfg, sp["batch"],
                                                      s.prompt_len)
                                 for s in specs())
    assert pages == sp["headroom"] + 3 * sum(s.prompt_len for s in specs())
    warm, chunks = {}, {}
    for rate in (4.0, sp["steps_per_s"]):
        for chunk in (sp["chunk"], 256):
            srv = dry_server(monkeypatch, specs(), prefix_dedup=True,
                             prefill_chunk=chunk, batch=sp["batch"],
                             max_len=sp["max_len"], total_pages=pages,
                             epoch_len=sp["epoch_len"], steps_per_s=rate,
                             reduced=False)
            out = srv.run(sp["steps"])
            assert out["prefix"]["evictions"] == 0
            warm[rate, chunk] = sum(i["prefix_hit"] > 0
                                    for i in out["tenants"].values())
            chunks[rate, chunk] = [i["prefill_chunks"]
                                   for i in out["tenants"].values()]
            assert {c for cs in chunks[rate, chunk] for c in cs} == {128}
    for chunk in (sp["chunk"], 256):
        assert warm[4.0, chunk] == 1
        assert warm[sp["steps_per_s"], chunk] >= 2
    assert len(set(map(str, chunks.values()))) == 2   # one per rate
