"""The port's MultiTenantServer with SSM tenants against the JAX
package's, at the reduced configs (fp32), the reference's params and
prompts injected (``params_fn`` / ``prompt_fn``).

Scenarios: a mamba2-370m resident with a mamba2 prompt tenant arriving
mid-run (a 400-token prompt: chunk boundaries on the 128-token
lcm(LANE, ssm_chunk) grid, and a tail segment of 16 tokens inside the
last chunk), and a mixed pool, yi-9b and mamba2 residents with an
arrival of each (the mamba2 prompt of 200 tokens, one chunk).  The
scheduling side is a copy of the reference's, so the traces must be
exactly equal: choices, ``KernelPlan.describe()`` and ``ssm_chunk`` per
plan, prefill chunks, reservations, NEC counters; the token streams
must be equal, and the port's serial and pipelined loops bit-identical.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.launch import serve as RS
from repro.models import model as RM
from repro.models.base import get_arch as ref_arch
from repro.sim.driver import TenantSpec as RSpec
from repro_torch.bridge import params_from_numpy
from repro_torch.core.policy import KV_PRECISION_LADDER
from repro_torch.launch import serve as PS
from repro_torch.models.base import get_arch as port_arch
from repro_torch.models.base import register
from repro_torch.sim.driver import TenantSpec as PSpec

SERVER = dict(batch=1, max_len=256, epoch_len=4, total_pages=32)
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
    return RS._prompt_tokens(RSpec(spec.model, prompt_len=spec.prompt_len), i,
                             _ref_cfg(cfg), batch)


def _port(arch_ids, tenants, **kw):
    return PS.MultiTenantServer(
        arch_ids, tenants=[PSpec(a, **t) for a, t in tenants], device="cpu",
        params_fn=_ref_params, prompt_fn=_ref_prompt, **{**SERVER, **kw})


def _runs(arch_ids, tenants, **kw):
    """(reference, port, port serial): each server with its run."""
    ref = RS.MultiTenantServer(arch_ids,
                               tenants=[RSpec(a, **t) for a, t in tenants],
                               **{**SERVER, **kw})
    port, serial = _port(arch_ids, tenants, **kw), _port(
        arch_ids, tenants, pipeline=False, **kw)
    return ((ref, ref.run(steps=STEPS)), (port, port.run(steps=STEPS)),
            (serial, serial.run(steps=STEPS)))


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
        np.testing.assert_array_equal(pr["output"], rr["output"],
                                      err_msg=p.tid)
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
    for tid, p in pipe_out["tenants"].items():
        s = serial_out["tenants"][tid]
        np.testing.assert_array_equal(s["output"], p["output"], err_msg=tid)
        assert s["tokens"] == p["tokens"]


MAMBA = [("mamba2-370m", dict(arrive_at=4.0, prompt_len=400,
                              n_inferences=16))]
MIXED = [("mamba2-370m", dict(arrive_at=4.0, prompt_len=200, n_inferences=12)),
         ("yi-9b", dict(arrive_at=8.0, prompt_len=96, n_inferences=8))]


@pytest.fixture(scope="module")
def mamba_runs():
    return _runs(["mamba2-370m"], MAMBA, max_len=512)


@pytest.fixture(scope="module")
def mixed_runs():
    return _runs(["yi-9b", "mamba2-370m"], MIXED)


def test_mamba2_server_equals_reference(mamba_runs):
    (ref, ref_out), (port, port_out), _ = mamba_runs
    _assert_same_trace(ref, ref_out, port, port_out)
    resident, arrival = port.tenants
    assert sum(arrival.chunks) == 400 and len(arrival.chunks) > 1
    # interior chunk boundaries on the lcm(LANE, ssm_chunk) grid; the
    # last chunk ends on a tail segment
    assert all(c % 128 == 0 for c in arrival.chunks[:-1])
    assert arrival.chunks[-1] % 32
    assert {p.ssm_chunk for p in arrival.plans} == {32}
    assert port_out["tenants"][arrival.tid]["output"].shape == (1, 17)
    assert port_out["tenants"][resident.tid]["output"].shape == (1, STEPS)
    assert arrival.kv_wanted == PS._kv_reserve_pages(arrival.cfg, 1, 400)


def test_mamba2_server_serial_and_pipelined_bit_identical(mamba_runs):
    _, (_, pipe_out), (_, serial_out) = mamba_runs
    _assert_serial_equals_pipelined(pipe_out, serial_out)


def test_mixed_pool_equals_reference(mixed_runs):
    """yi-9b and mamba2 in one pool schedule as the reference's do: the
    same grants, plans, chunks, reservations and tokens."""
    (ref, ref_out), (port, port_out), _ = mixed_runs
    _assert_same_trace(ref, ref_out, port, port_out)
    families = {t.cfg.family for t in port.tenants}
    assert families == {"dense", "ssm"}
    for t in port.tenants:
        assert t.tokens_served > 0, t.tid


def test_mixed_pool_serial_and_pipelined_bit_identical(mixed_runs):
    _, (_, pipe_out), (_, serial_out) = mixed_runs
    _assert_serial_equals_pipelined(pipe_out, serial_out)


@pytest.mark.parametrize("arch", ["mamba2-370m", "yi-9b"])
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_kv_reserve_pages_equal_reference(arch, reduced):
    rcfg, pcfg = ref_arch(arch), port_arch(arch)
    if reduced:
        rcfg, pcfg = rcfg.reduced(), pcfg.reduced()
    for batch in (1, 2):
        for tokens in (0, 1, 300, 1024):
            for kv in KV_PRECISION_LADDER:
                assert (PS._kv_reserve_pages(pcfg, batch, tokens, kv)
                        == RS._kv_reserve_pages(rcfg, batch, tokens, kv)), \
                    (batch, tokens, kv)
    if arch == "mamba2-370m" and not reduced:
        # O(1) state: 48 layers x 2 rows of conv window and fp32 state
        assert PS._kv_reserve_pages(pcfg, 2, 512) == 3113
        assert PS._kv_reserve_pages(pcfg, 2, 300, "int8") == 3113


def test_auto_keeps_a_mamba2_arrival_native_like_reference():
    """Under ``kv_dtype="auto"``, in a pool that holds the mamba2
    arrival's state and the yi-9b arrival's fp8 quote but not its native
    one, the mamba2 arrival stays native (recurrent state is never
    quantized) and the yi-9b one drops down the ladder, as in the
    reference."""
    yi = port_arch("yi-9b").reduced()
    mamba = port_arch("mamba2-370m").reduced()
    pool = (PS._kv_reserve_pages(mamba, 1, 200)
            + PS._kv_reserve_pages(yi, 1, 96, "fp8_e4m3") + 1)
    (ref, ref_out), (port, port_out), _ = _runs(
        [], MIXED, kv_dtype="auto", total_pages=pool)
    _assert_same_trace(ref, ref_out, port, port_out)
    got = {t.cfg.family: t.kv_dtype for t in port.tenants}
    assert got["ssm"] == "native"
    assert got["dense"] != "native"
    ssm = next(t for t in port.tenants if t.cfg.family == "ssm")
    assert not any("+kv:" in p.describe() for p in ssm.plans)


def test_full_width_mamba2_lowers_lbm_grants():
    """Full-width mamba2 has d_ff = 0.  Its FFN graph is built at
    d_model, and the port lowers its grants at that width too
    (``_lower_width``): an LBM grant lowers to a fused plan with the SSD
    chunk of the grant, where lowering at ``cfg.d_ff`` divides by zero.
    One full-width layer, a pool where LBM is granted, a 300-token prompt
    (one chunk: 256 + a 44-token tail segment)."""
    full = port_arch("mamba2-370m")
    assert full.d_ff == 0
    cfg = register(dataclasses.replace(full, name="mamba2-370m-1layer",
                                       num_layers=1))
    srv = PS.MultiTenantServer(
        [cfg.name], tenants=[PSpec(cfg.name, arrive_at=2.0, prompt_len=300,
                                   n_inferences=4)],
        batch=1, max_len=512, epoch_len=2, total_pages=6500, device="cpu",
        reduced=False)
    out = srv.run(steps=6)
    kinds = {p.kind for t in srv.tenants for p in t.plans}
    assert "LBM" in kinds
    arrival = srv.tenants[1]
    assert arrival.chunks == [300]
    assert {p.ssm_chunk for p in arrival.plans} == {256}
    assert out["tenants"][arrival.tid]["output"].shape == (1, 5)
