"""The port's MultiTenantServer with hybrid (zamba2-2.7b) tenants against
the JAX package's, at the reduced configs (fp32), the reference's params
and prompts injected (``params_fn`` / ``prompt_fn``).

A hybrid tenant holds both kinds of cache: per group, the recurrent
state of its Mamba2 layers and the K/V of the shared block.  Scenarios:
zamba2 alone (a resident and a 300-token arrival: interior chunk
boundaries on the 128-token lcm(LANE, ssm_chunk) grid), a zamba2
arrival beside a yi-9b resident, ``kv_dtype`` int8 (page scales from
the K/V dicts only) and ``auto``, a full-prompt re-arrival (prefix
dedup) of 64 tokens and of 5, fewer than the reduced config's 8 SSM
heads, and preempt / resume through a checkpoint.  The scheduling side
is the reference's copy, so choices, plans (with their SSD chunk),
prefill chunks, reservations, NEC counters and token streams must be
exactly equal; the port's serial and pipelined loops bit-identical; a
re-arrival and a resumed tenant decode the cold stream bit for bit.
Also the reference's pricing of hybrid tenants: ``_kv_reserve_pages``
(in tests/test_torch_ssm_serve.py), ``_chunk_align``, the KV precision
of an encoder-decoder tenant, and the CLI with ``--archs zamba2-2.7b``.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.launch import serve as RS
from repro.models import model as RM
from repro.models.base import get_arch as ref_arch
from repro.sim import driver as RD
from repro.sim import faults as RF
from repro_torch.bridge import params_from_numpy
from repro_torch.core.runtime import STATE_RESUMED
from repro_torch.launch import serve as PS
from repro_torch.models import transformer as PT
from repro_torch.models.base import get_arch as port_arch
from repro_torch.sim import driver as PD
from repro_torch.sim import faults as PF

ARCH = "zamba2-2.7b"
SERVER = dict(batch=1, max_len=512, epoch_len=4, total_pages=32)
STEPS = 24
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
    rspec = RD.TenantSpec(spec.model, prompt_len=spec.prompt_len,
                          prompt_seed=spec.prompt_seed,
                          prefix_len=spec.prefix_len,
                          prefix_seed=spec.prefix_seed)
    return RS._prompt_tokens(rspec, i, _ref_cfg(cfg), batch)


def _servers(arch_ids, specs, **kw):
    """(reference, port) servers of the same scenario."""
    kw = {**SERVER, **kw}
    ref = RS.MultiTenantServer(arch_ids, tenants=[RD.TenantSpec(a, **t)
                                                  for a, t in specs], **kw)
    port = PS.MultiTenantServer(
        arch_ids, tenants=[PD.TenantSpec(a, **t) for a, t in specs],
        device="cpu", params_fn=_ref_params, prompt_fn=_ref_prompt, **kw)
    return ref, port


def _runs(arch_ids, specs, **kw):
    """(reference, port, port serial): each server with its run."""
    ref, port = _servers(arch_ids, specs, **kw)
    _, serial = _servers(arch_ids, specs, pipeline=False, **kw)
    return ((ref, ref.run(steps=STEPS)), (port, port.run(steps=STEPS)),
            (serial, serial.run(steps=STEPS)))


def _outputs(out):
    return {tid: info["output"] for tid, info in out["tenants"].items()}


def _same_tokens(a, b):
    assert set(a) == set(b)
    for tid in a:
        np.testing.assert_array_equal(a[tid], b[tid], err_msg=tid)


def _assert_same_trace(ref, ref_out, port, port_out):
    assert [t.tid for t in ref.tenants] == [t.tid for t in port.tenants]
    for r, p in zip(ref.tenants, port.tenants):
        assert p.choices == r.choices, p.tid
        assert ([(x.describe(), x.ssm_chunk) for x in p.plans]
                == [(x.describe(), x.ssm_chunk) for x in r.plans]), p.tid
        assert p.chunks == r.chunks, p.tid
        assert (p.kv_dtype, p.kv_wanted, p.kv_reserved) == \
            (r.kv_dtype, r.kv_wanted, r.kv_reserved), p.tid
        rr, pr = ref_out["tenants"][r.tid], port_out["tenants"][p.tid]
        for key in ("tokens", "choices", "prefill_chunks", "lbm_frac",
                    "kv_dtype", "prefill_computed", "departed", "state"):
            assert pr[key] == rr[key], (p.tid, key)
    _same_tokens(_outputs(port_out), _outputs(ref_out))
    assert port_out["dram_bytes"] == ref_out["dram_bytes"] > 0
    assert (dataclasses.astuple(port.nec.traffic)
            == dataclasses.astuple(ref.nec.traffic))
    assert ({k: dataclasses.astuple(v)
             for k, v in port.nec.ledger.per_tenant.items()}
            == {k: dataclasses.astuple(v)
                for k, v in ref.nec.ledger.per_tenant.items()})
    assert port.cache.free_pages == ref.cache.free_pages


def _assert_serial_equals_pipelined(pipe_out, serial_out):
    assert serial_out["mode"] == "serial"
    _same_tokens(_outputs(serial_out), _outputs(pipe_out))


ALONE = [(ARCH, dict(arrive_at=4.0, prompt_len=300, n_inferences=12))]
MIXED = [(ARCH, dict(arrive_at=4.0, prompt_len=200, n_inferences=12)),
         ("yi-9b", dict(arrive_at=8.0, prompt_len=96, n_inferences=8))]


@pytest.fixture(scope="module", params=["alone", "mixed", "int8"])
def runs(request):
    if request.param == "alone":
        return request.param, _runs([ARCH], ALONE)
    if request.param == "mixed":
        return request.param, _runs(["yi-9b"], MIXED, batch=2, max_len=256,
                                    total_pages=64)
    return request.param, _runs([ARCH], ALONE, kv_dtype="int8",
                                total_pages=64)


def test_hybrid_server_equals_reference(runs):
    """Grants, plans and SSD chunks, prefill chunks, reservations, NEC
    counters and token streams equal the reference's."""
    name, ((ref, ref_out), (port, port_out), _) = runs
    _assert_same_trace(ref, ref_out, port, port_out)
    hybrid = [t for t in port.tenants if t.cfg.family == "hybrid"]
    assert hybrid and all(t.tokens_served > 0 for t in port.tenants)
    arrival = next(t for t in hybrid if t.prompt_len)
    assert arrival.kv_wanted == PS._kv_reserve_pages(
        arrival.cfg, port.batch, arrival.prompt_len, arrival.kv_dtype)
    assert arrival.kv_dtype == ("int8" if name == "int8" else "native")
    if name != "mixed":
        # interior chunk boundaries on the lcm(LANE, ssm_chunk) grid
        assert sum(arrival.chunks) == 300
        assert all(c % 128 == 0 for c in arrival.chunks[:-1])
        assert {p.ssm_chunk for p in arrival.plans} == {32}


def test_hybrid_server_serial_and_pipelined_bit_identical(runs):
    _, (_, (_, pipe_out), (_, serial_out)) = runs
    _assert_serial_equals_pipelined(pipe_out, serial_out)


def test_int8_hybrid_page_scales_equal_reference():
    """A live int8 hybrid tenant records per-page dequant scales from its
    K/V dicts only (its Mamba2 dicts carry no scales), as the
    reference's: the same pages, the scales within rtol 2e-3.  The K/V
    rows come out of Mamba2 layers, which the port matches at 2e-3
    (tests/test_torch_hybrid.py::TOL), not of attention-only layers as
    yi-9b's (1e-5 there); measured here: 5.9e-5 at one page of nine."""
    spec = [(ARCH, dict(prompt_len=256, n_inferences=None, param_seed=5))]
    ref, port = _servers([], spec, kv_dtype="int8", total_pages=256)
    ref_out, port_out = ref.run(8), port.run(8)
    _same_tokens(_outputs(port_out), _outputs(ref_out))
    tid = f"t0:{ARCH}#kv"
    got = sorted(port.cache.page_scales_of(tid).items())
    want = sorted(ref.cache.page_scales_of(tid).items())
    assert got and len(got) == len(port.cache.pages_of(tid))
    assert [k for k, _ in got] == [k for k, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=2e-3, atol=0)


def test_auto_downgrades_a_hybrid_arrival_like_reference():
    """``kv_dtype="auto"`` in a pool that holds the zamba2 arrival's fp8
    quote but not its native one: the ladder picks the same rung as the
    reference's (not native: a hybrid's K/V is row-addressed), the same
    trace and tokens."""
    cfg = port_arch(ARCH).reduced()
    pool = PS._kv_reserve_pages(cfg, 1, 300, "fp8_e4m3") + 1
    assert PS._kv_reserve_pages(cfg, 1, 300) > pool
    (ref, ref_out), (port, port_out), _ = _runs([ARCH], ALONE,
                                                kv_dtype="auto",
                                                total_pages=pool)
    _assert_same_trace(ref, ref_out, port, port_out)
    assert port.tenants[1].kv_dtype not in ("native", None)


# ------------------------------------------------------ pricing rules --
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_chunk_align_equals_reference(reduced):
    """A hybrid tenant's prompt chunks align to lcm(LANE, ssm_chunk), as
    an SSM tenant's: 256 at full width, 128 reduced."""
    rcfg, pcfg = ref_arch(ARCH), port_arch(ARCH)
    if reduced:
        rcfg, pcfg = rcfg.reduced(), pcfg.reduced()
    ref = RS.MultiTenantServer([], **SERVER)
    port = PS.MultiTenantServer([], device="cpu", **SERVER)
    assert port._chunk_align(pcfg) == ref._chunk_align(rcfg)
    assert port._chunk_align(pcfg) == (128 if reduced else 256)


@pytest.mark.parametrize("arch", ["whisper-tiny", ARCH, "mamba2-370m"])
def test_choose_kv_dtype_equals_reference(arch):
    """Under ``kv_dtype="int8"`` an encoder-decoder tenant and an SSM
    tenant stay native, a hybrid one takes int8, as the reference's
    method decides."""
    ref = RS.MultiTenantServer([], kv_dtype="int8", **SERVER)
    port = PS.MultiTenantServer([], device="cpu", kv_dtype="int8", **SERVER)
    got = port._choose_kv_dtype(port_arch(arch).reduced(),
                                PD.TenantSpec(arch, prompt_len=16))
    want = ref._choose_kv_dtype(ref_arch(arch).reduced(),
                                RD.TenantSpec(arch, prompt_len=16))
    assert got == want == ("int8" if arch == ARCH else "native")


# ----------------------------------------------------- prefix dedup --
REARRIVAL = dict(batch=1, max_len=256, total_pages=128, epoch_len=8,
                 steps_per_s=4.0)


@pytest.mark.parametrize("prompt_len", [64, 5],
                         ids=["p64", "p5_under_ssm_heads"])
def test_full_prompt_rearrival_equals_reference(prompt_len):
    """tests/test_prefix_cache.py::test_full_prompt_rearrival_skips_prefill
    on a hybrid tenant: the re-arrival hits the producer's full-length
    entry (a hybrid registers no shorter one: its state is cumulative),
    computes nothing and decodes the producer's stream bit for bit, as
    the reference's.  At 5 tokens the prompt is shorter than the 8 SSM
    heads: a snapshot cut to the prompt's rows on every leaf would cut
    the state's head axis."""
    def specs(cls):
        return [cls(ARCH, arrive_at=at, n_inferences=6,
                    prompt_len=prompt_len, param_seed=5, prompt_seed=7,
                    prefix_len=prompt_len, prefix_seed=3)
                for at in (0.0, 4.0)]
    assert port_arch(ARCH).reduced().ssm_heads == 8
    ref = RS.MultiTenantServer([], tenants=specs(RD.TenantSpec),
                               prefix_dedup=True, **REARRIVAL)
    port = PS.MultiTenantServer([], tenants=specs(PD.TenantSpec),
                                prefix_dedup=True, device="cpu",
                                params_fn=_ref_params,
                                prompt_fn=_ref_prompt, **REARRIVAL)
    ref_out, out = ref.run(STEPS), port.run(STEPS)
    prod, warm = (out["tenants"][f"t{i}:{ARCH}"] for i in (0, 1))
    assert prod["prefix_hit"] == 0 and sum(prod["prefill_chunks"]) == \
        prompt_len
    assert warm["prefix_hit"] == prompt_len
    assert warm["prefill_chunks"] == [] and warm["prefill_computed"] == 0
    np.testing.assert_array_equal(prod["output"], warm["output"])
    assert out["prefix"] == ref_out["prefix"]
    assert out["prefix"]["entries"] == 1
    _same_tokens(_outputs(out), _outputs(ref_out))
    (entry,) = port.prefix.entries.values()
    fresh = PT.init_caches(None, port.tenants[0].cfg, 1,
                           REARRIVAL["max_len"], device="cpu")
    for layer, blank in zip(entry.payload["snap"], fresh, strict=True):
        for name, leaf in layer.items():
            want = tuple(blank[name].shape)
            if name in PT.KV_LEAVES:
                want = want[:1] + (prompt_len,) + want[2:]
            assert tuple(leaf.shape) == want, name


# --------------------------------------------------- preempt / resume --
def _preempt_run(pkg, kv, faulted, **kw):
    srv_cls, spec, event, plan = (
        (RS.MultiTenantServer, RD.TenantSpec, RF.FaultEvent, RF.FaultPlan)
        if pkg == "ref" else
        (PS.MultiTenantServer, PD.TenantSpec, PF.FaultEvent, PF.FaultPlan))
    faults = plan([event(step=8, kind="preempt", hold_epochs=2)]) \
        if faulted else None
    extra = {} if pkg == "ref" else dict(device="cpu", params_fn=_ref_params,
                                         prompt_fn=_ref_prompt)
    srv = srv_cls([], total_pages=64, epoch_len=4, max_len=128,
                  faults=faults, kv_dtype=kv, **extra, **kw)
    srv.enqueue([spec(ARCH, prompt_len=32, n_inferences=24)])
    return srv.run(steps=24)


@pytest.mark.parametrize("kv", ["native", "int8"])
def test_preempt_resume_bitwise_and_equals_reference(kv, tmp_path):
    """tests/test_faults.py::test_preempt_resume_is_bit_identical on a
    hybrid tenant: preempted at step 8 through a snapshot checkpoint of
    its K/V and Mamba2 states, resumed two epochs later, it decodes the
    unfaulted run's stream bit for bit, and the run equals the
    reference's (tokens, counters, fault log)."""
    faulted = _preempt_run("port", kv, True, ckpt_dir=str(tmp_path))
    control = _preempt_run("port", kv, False)
    ref = _preempt_run("ref", kv, True)
    (tid, want), = _outputs(control).items()
    np.testing.assert_array_equal(_outputs(faulted)[tid], want)
    info = faulted["tenants"][tid]
    assert info["state"] == STATE_RESUMED and info["preemptions"] == 1
    assert faulted["faults"]["log"][0]["mode"] == "snapshot"
    assert faulted["faults"]["checkpoint_bytes"] > 0
    _same_tokens(_outputs(faulted), _outputs(ref))
    for key in ("tokens", "state", "preemptions", "prefill_chunks",
                "kv_reserved", "kv_wanted", "choices", "plans"):
        assert info[key] == ref["tenants"][tid][key], key
    wall = ("recovery_s", "waited_s")
    assert ([{k: v for k, v in r.items() if k not in wall}
             for r in faulted["faults"]["log"]]
            == [{k: v for k, v in r.items() if k not in wall}
                for r in ref["faults"]["log"]])


# ---------------------------------------------------------------- CLI --
def test_cli_serves_zamba2(capsys):
    """``python -m repro_torch.launch.serve --archs zamba2-2.7b`` on the
    CPU (reduced): one resident and one arrival, the reference's
    ``[serve]`` lines."""
    out = PS.main(["--device", "cpu", "--archs", ARCH, "--steps", "8",
                   "--arrivals", "1", "--prompt-len", "64",
                   "--decode-budget", "4", "--epoch-len", "4"])
    lines = capsys.readouterr().out.splitlines()
    tids = list(out["tenants"])
    assert len(tids) == 2 and all(t.endswith(f":{ARCH}") for t in tids)
    for tid, ln in zip(tids, lines):
        assert ln.startswith(f"[serve] {tid}: ") and " tokens, LBM " in ln
    assert "TTFT" in lines[1] and ", kv " in lines[1]
    assert all(info["tokens"] > 0 for info in out["tenants"].values())
