"""Predictive grant lookahead in the port's server against the JAX
package's.

Mirrors tests/test_alloc_batch.py::test_lookahead_adjusts_contested_grants
_without_changing_tokens at the reduced yi-9b (fp32), the reference's
params and prompts injected: a resident and two 192-token arrivals one
epoch out, in a pool too small for the resident's preferred grant once
their reservations land.  The port's lookahead fires as often as the
reference's, its grants, plans and NEC counters equal the reference's
with and without lookahead, and the token streams equal the reference's
and each other.  At full width the lookahead prices an arrival's
reservation at the server's width; the CLI's ``--lookahead`` runs.

Scheduled at full width without weights (``torch_dry_run``): the
contested scenario of ``chip_smoke.py``'s ``lookahead`` phase adjusts an
olmoe resident's grant, and the reference's rule never adjusts a yi-9b
resident's.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.launch import serve as RS
from repro.models import model as RM
from repro.models.base import get_arch as ref_arch
from repro.sim.driver import TenantSpec as RSpec
from repro_torch.bridge import params_from_numpy
from repro_torch.core.policy import project_epoch_dram
from repro_torch.core.vmem import PAGE_BYTES
from repro_torch.launch import serve as PS
from repro_torch.models.base import get_arch as port_arch
from repro_torch.sim.driver import TenantSpec as PSpec
from torch_dry_run import dry_server

KW = dict(batch=1, max_len=256, total_pages=36, epoch_len=2)
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
    return RS._prompt_tokens(RSpec(spec.model, prompt_len=spec.prompt_len),
                             i, _ref_cfg(cfg), batch)


def _specs(Spec):
    return [Spec("yi-9b", n_inferences=24),
            Spec("yi-9b", prompt_len=192, n_inferences=8, arrive_at=3.0),
            Spec("yi-9b", prompt_len=192, n_inferences=8, arrive_at=3.25)]


@pytest.fixture(scope="module")
def runs():
    out = {}
    for ahead in (True, False):
        ref = RS.MultiTenantServer([], tenants=_specs(RSpec),
                                   lookahead=ahead, **KW)
        port = PS.MultiTenantServer([], tenants=_specs(PSpec),
                                    lookahead=ahead, device="cpu",
                                    params_fn=_ref_params,
                                    prompt_fn=_ref_prompt, **KW)
        out[ahead] = ((ref, ref.run(STEPS)), (port, port.run(STEPS)))
    return out


def test_lookahead_adjusts_contested_grants_without_changing_tokens(runs):
    (_, out_a), (_, out_b) = runs[True][1], runs[False][1]
    assert out_a["host"]["lookahead_adjusted"] >= 1
    assert out_b["host"]["lookahead_adjusted"] == 0
    for tid in out_b["tenants"]:
        assert (out_a["tenants"][tid]["tokens"]
                == out_b["tenants"][tid]["tokens"])
        np.testing.assert_array_equal(out_a["tenants"][tid]["output"],
                                      out_b["tenants"][tid]["output"])


@pytest.mark.parametrize("ahead", [True, False])
def test_lookahead_trace_and_tokens_equal_reference(runs, ahead):
    (ref, ref_out), (port, port_out) = runs[ahead]
    assert (port_out["host"]["lookahead_adjusted"]
            == ref_out["host"]["lookahead_adjusted"])
    for r, p in zip(ref.tenants, port.tenants):
        assert p.tid == r.tid
        assert p.choices == r.choices
        assert ([x.describe() for x in p.plans]
                == [x.describe() for x in r.plans])
        assert p.chunks == r.chunks
    assert (dataclasses.astuple(port.nec.traffic)
            == dataclasses.astuple(ref.nec.traffic))
    for tid, r in ref_out["tenants"].items():
        np.testing.assert_array_equal(port_out["tenants"][tid]["output"],
                                      r["output"], err_msg=tid)


def test_lookahead_changes_grants(runs):
    """The adjusted run took other grants than the plain one (the
    lookahead steers residency, never numerics)."""
    (pa, _), (pb, _) = runs[True][1], runs[False][1]
    assert [t.choices for t in pa.tenants] != [t.choices for t in pb.tenants]


@pytest.mark.parametrize("reduced", [True, False])
def test_lookahead_prices_at_the_server_width(reduced):
    """The projected pool delta prices a due arrival's reservation at
    the width the server serves (nothing is admitted here, so no
    full-width weights are made)."""
    srv = PS.MultiTenantServer([], device="cpu", reduced=reduced,
                               lookahead=True, **KW)
    srv.enqueue([PSpec("yi-9b", prompt_len=192, n_inferences=8,
                       arrive_at=0.5)])
    arch = port_arch("yi-9b")
    cfg = arch.reduced() if reduced else arch
    want = PS._kv_reserve_pages(cfg, KW["batch"], 192)
    assert srv._upcoming_free_delta() == -want
    if reduced:
        rsrv = RS.MultiTenantServer([], lookahead=True, **KW)
        rsrv.enqueue([RSpec("yi-9b", prompt_len=192, n_inferences=8,
                            arrive_at=0.5)])
        assert rsrv._upcoming_free_delta() == -want


def test_cli_lookahead_runs(capsys):
    out = PS.main(["--device", "cpu", "--archs", "yi-9b", "--steps", "4",
                   "--epoch-len", "2", "--lookahead"])
    assert out["host"]["lookahead_adjusted"] == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("[serve] t0:yi-9b: ")


# ------------------------------------ full width, scheduling only --
def _chip_smoke():
    """chip_smoke.py's phase constants (the module imports no torch at
    load time)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_consts", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _contested(resident, la):
    return [PSpec(resident, n_inferences=la["resident_steps"], param_seed=0)
            ] + [PSpec(la["arrival"], prompt_len=la["prompt_len"],
                       n_inferences=la["n_inferences"], arrive_at=at,
                       param_seed=0) for at in la["arrive_at"]]


def _contested_run(monkeypatch, resident, la, pages, ahead):
    srv = dry_server(monkeypatch, _contested(resident, la), lookahead=ahead,
                     batch=la["batch"], max_len=la["max_len"],
                     total_pages=pages, epoch_len=la["epoch_len"],
                     reduced=False)
    return srv, srv.run(la["steps"])


def test_full_width_chip_scenario_adjusts(monkeypatch):
    """chip_smoke.py's ``lookahead`` phase, scheduled at full width: the
    lookahead adjusts the olmoe resident's grant, and the yi-9b arrivals'
    prefill chunks and plans are the same with and without it (so their
    kernels and tokens may be held equal on the card)."""
    la = _chip_smoke().LOOKAHEAD
    quote = PS._kv_reserve_pages(port_arch(la["arrival"]), la["batch"],
                                 la["prompt_len"])
    pages = len(la["arrive_at"]) * quote + la["spare"]
    (on, out_on), (off, out_off) = (
        _contested_run(monkeypatch, la["resident"], la, pages, ahead)
        for ahead in (True, False))
    assert out_on["host"]["lookahead_adjusted"] >= 1
    assert out_off["host"]["lookahead_adjusted"] == 0
    for a, b in zip(on.tenants[1:], off.tenants[1:]):
        assert a.chunks == b.chunks
        assert ([p.describe() for p in a.plans]
                == [p.describe() for p in b.plans])
    assert on.tenants[0].choices != off.tenants[0].choices


def test_full_width_yi_resident_is_never_adjusted(monkeypatch):
    """At full width the reference's rule never adjusts a yi-9b
    resident's grant, whatever the pool: its NEC-priced DRAM under the
    stable grant exceeds the aggressive grant's by more than the page
    thrash the switch could save (at most its largest grant, 86 pages,
    twice).  This is why chip_smoke.py's contested scenario has an
    olmoe resident."""
    la = _chip_smoke().LOOKAHEAD
    quote = PS._kv_reserve_pages(port_arch("yi-9b"), la["batch"],
                                 la["prompt_len"])
    for spare in (0, 16, 32, 64, 128, 512):
        _, out = _contested_run(monkeypatch, "yi-9b", la,
                                2 * quote + spare, True)
        assert out["host"]["lookahead_adjusted"] == 0, spare
    srv, _ = _contested_run(monkeypatch, "yi-9b", la, 2 * quote + 32, True)
    task = srv.tenants[0].task
    cur = [max(m.lwms, key=lambda c: c.p_need)
           for m in task.model.mapping.mcts]
    need = max(c.p_need for c in cur)
    stable = [s.candidate for s in srv._simulate_block_sels(task, 0.0,
                                                            need - 1)]
    k = la["epoch_len"]
    gap = (project_epoch_dram(task, stable, k)
           - project_epoch_dram(task, cur, k))
    thrash = 2 * need * PAGE_BYTES
    assert need == 86 and gap > 5 * thrash, (gap, thrash)
