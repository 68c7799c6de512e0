"""The port's MultiTenantServer against the JAX package's, on one scenario.

Two reduced yi-9b tenants: one resident, one arriving mid-run with a
192-token prompt and a 16-step budget, in a page pool tight enough that
the grants switch between LBM and LWM.  The port is handed the
reference's params (through ``repro_torch.bridge``) and prompt tokens.
No QoS targets: slack reads the wall clock.

The scheduling side is a copy of the reference's, so its trace must be
exactly equal: per-tenant choices, ``KernelPlan.describe()`` sequences,
prefill chunk lengths, KV reservations and the NEC counters.  The token
streams must be equal too, and the port's serial and pipelined loops
bit-identical.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.core.runtime import TenantModel as RTenantModel
from repro.launch import serve as RS
from repro.models import model as RM
from repro.models.base import get_arch as ref_arch
from repro.sim.driver import TenantSpec as RSpec
from repro_torch.bridge import params_from_numpy
from repro_torch.launch import serve as PS
from repro_torch.models.base import get_arch as port_arch
from repro_torch.sim.driver import TenantSpec as PSpec

PAGES = 32
STEPS = 24
SERVER = dict(batch=1, max_len=256, epoch_len=4, total_pages=PAGES)
ARRIVAL = dict(arrive_at=4.0, prompt_len=192, n_inferences=16)


def _ref_cfg(cfg):
    return ref_arch(cfg.name.removesuffix("-smoke")).reduced()


def _ref_params(cfg, pkey):
    tree = RM.init_params(_ref_cfg(cfg), jax.random.PRNGKey(pkey))
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), cfg,
                             "cpu")


def _ref_prompt(spec, i, cfg, batch):
    return RS._prompt_tokens(RSpec(spec.model, prompt_len=spec.prompt_len), i,
                             _ref_cfg(cfg), batch)


def _port(**kw):
    return PS.MultiTenantServer(["yi-9b"], tenants=[PSpec("yi-9b", **ARRIVAL)],
                                device="cpu", params_fn=_ref_params,
                                prompt_fn=_ref_prompt, **SERVER, **kw)


@pytest.fixture(scope="module")
def runs():
    ref = RS.MultiTenantServer(["yi-9b"], tenants=[RSpec("yi-9b", **ARRIVAL)],
                               **SERVER)
    port, serial = _port(), _port(pipeline=False)
    return ((ref, ref.run(steps=STEPS)), (port, port.run(steps=STEPS)),
            (serial, serial.run(steps=STEPS)))


def test_grant_plan_and_nec_trace_equal_reference(runs):
    (ref, ref_out), (port, port_out), _ = runs
    assert [t.tid for t in ref.tenants] == [t.tid for t in port.tenants]
    kinds = set()
    for r, p in zip(ref.tenants, port.tenants):
        assert p.choices == r.choices
        assert ([x.describe() for x in p.plans]
                == [x.describe() for x in r.plans])
        assert p.chunks == r.chunks
        assert (p.kv_wanted, p.kv_reserved) == (r.kv_wanted, r.kv_reserved)
        kinds |= {x.kind for x in p.plans}
    assert kinds == {"LBM", "LWM"}
    assert (dataclasses.astuple(port.nec.traffic)
            == dataclasses.astuple(ref.nec.traffic))
    assert ({k: dataclasses.astuple(v)
             for k, v in port.nec.ledger.per_tenant.items()}
            == {k: dataclasses.astuple(v)
                for k, v in ref.nec.ledger.per_tenant.items()})
    assert port_out["dram_bytes"] == ref_out["dram_bytes"] > 0
    assert port.cache.free_pages == ref.cache.free_pages


def test_result_keeps_reference_keys_and_values(runs):
    (_, ref_out), (_, port_out), _ = runs
    assert port_out["mode"] == ref_out["mode"] == "pipelined"
    for tid, r in ref_out["tenants"].items():
        p = port_out["tenants"][tid]
        for key in ("tokens", "choices", "prefill_chunks", "lbm_frac"):
            assert p[key] == r[key], key
        assert (p["ttft_s"] is None) == (r["ttft_s"] is None)


def test_token_streams_equal_reference(runs):
    (_, ref_out), (_, port_out), _ = runs
    for tid, r in ref_out["tenants"].items():
        np.testing.assert_array_equal(port_out["tenants"][tid]["output"],
                                      r["output"], err_msg=tid)
    assert port_out["tenants"]["t1:yi-9b"]["output"].shape == (1, 17)


def test_port_serial_and_pipelined_bit_identical(runs):
    """Mirrors test_serve_pipeline.py::
    test_pipelined_outputs_bit_identical_to_serial."""
    _, (_, pipe_out), (_, serial_out) = runs
    assert serial_out["mode"] == "serial"
    for tid, p in pipe_out["tenants"].items():
        s = serial_out["tenants"][tid]
        np.testing.assert_array_equal(s["output"], p["output"], err_msg=tid)
        assert s["tokens"] == p["tokens"]


@pytest.mark.parametrize("option", [
    dict(prefix_dedup=True), dict(lookahead=True), dict(faults=object()), dict(queue_limit=4), dict(queue_deadline_s=1.0),
    dict(kv_dtype="auto", queue_limit=4), dict(device=[object()])])
def test_unported_server_features_raise(option):
    with pytest.raises(NotImplementedError):
        PS.MultiTenantServer(["yi-9b"], **{"device": "cpu", **option})


def test_unported_families_raise():
    with pytest.raises(NotImplementedError):
        PS.MultiTenantServer(["olmoe-1b-7b"], device="cpu")


def _candidates(tm):
    return [[(c.kind, c.p_need, c.dram_bytes, c.usage_limit_bytes)
             for c in mct.lwms + ([mct.lbm] if mct.lbm is not None else [])]
            for mct in tm.mapping.mcts]


@pytest.mark.parametrize("arch", ["yi-9b", "granite-3-8b"])
@pytest.mark.parametrize("seq_block", [2, 256, 1024])
@pytest.mark.parametrize("pages", [64, 1800])
def test_full_width_mapping_equals_reference(arch, seq_block, pages):
    """At full width the port's server maps a tenant's FFN graph as the
    reference's server does (``TenantModel`` with the default
    ``LbmConfig``): the same candidates per layer (kind, p_need, DRAM
    bytes, usage limit) and the same LBM blocks, for the decode graph
    (seq_block = batch) and prompt graphs.  Under the reference's 2 ms
    block cap a full-width FFN block gets no LBM candidate."""
    rcfg, pcfg = ref_arch(arch), port_arch(arch)
    assert rcfg.num_layers == pcfg.num_layers > 4          # full width
    ref = RTenantModel(RS._ffn_graph(arch, rcfg, seq_block),
                       RS._vmem_mapper(pages))
    port = PS._tenant_model(PS._ffn_graph(arch, pcfg, seq_block),
                            PS._vmem_mapper(pages))
    assert _candidates(port) == _candidates(ref)
    assert port.mapping.blocks == ref.mapping.blocks
    assert port.layer_t_est == ref.layer_t_est
    assert {k for layer in _candidates(port) for k, *_ in layer} == {"LWM"}
