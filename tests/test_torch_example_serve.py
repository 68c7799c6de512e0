"""The port's serve example (``python -m
repro_torch.examples.multi_tenant_serve``) against the reference's
servers on the same arguments, on the CPU at the reduced width.

examples/multi_tenant_serve.py is never run by the reference's own tests
(tests/test_integration.py:60 runs quickstart.py), so the comparison is
made against what it builds: ``MultiTenantServer`` (the main pool, then
the contended one at a third of the pages) and, for ``--devices 2``,
``FleetServer`` on a JAX mesh that repeats the one CPU device.  The
reference's params and prompts are injected into the port
(``torch_fleet_pairs``).  Per run: every tenant's grants, plans, LBM
share, prompt chunks, KV reservation, departure and tokens are equal,
and so are the report lines, less their wall-clock figures (TTFT,
tokens/s).
"""
import contextlib
import importlib.util
import io
import re
from pathlib import Path

import numpy as np
import pytest

from repro.launch import serve as RS
from repro.sim.driver import TenantSpec as RSpec
from repro_torch.examples import multi_tenant_serve as EX
from torch_fleet_pairs import ref_mesh, ref_params, ref_prompt

ARGS = ["--steps", "6", "--pages", "24", "--prompt-len", "128",
        "--device", "cpu"]
ROOT = Path(__file__).resolve().parents[1]


def _reference_example():
    spec = importlib.util.spec_from_file_location(
        "ref_multi_tenant_serve", ROOT / "examples" / "multi_tenant_serve.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _arrivals(prompt_len):
    return [RSpec("olmoe-1b-7b", arrive_at=4.0, n_inferences=16,
                  prompt_len=prompt_len),
            RSpec("mamba2-370m", arrive_at=8.0, n_inferences=16,
                  prompt_len=prompt_len)]


ARCHS = ["granite-3-8b", "olmoe-1b-7b", "mamba2-370m"]


def _reference_runs(devices):
    """The reference's servers as its example builds them on ARGS."""
    if devices:
        fleet = RS.FleetServer(mesh=ref_mesh(devices), arch_ids=ARCHS,
                               pages_per_replica=24, max_len=256,
                               tenants=_arrivals(128))
        return [("fleet", fleet.run(6))]
    srv = RS.MultiTenantServer(ARCHS, total_pages=24, max_len=256,
                               tenants=_arrivals(128),
                               admission="interleaved")
    srv2 = RS.MultiTenantServer(
        ARCHS, total_pages=8, max_len=256,
        tenants=[RSpec("olmoe-1b-7b", arrive_at=2.0, n_inferences=8,
                       prompt_len=128)], admission="interleaved")
    return [("serve", srv.run(6)), ("contended", srv2.run(6))]


def _masked(text):
    text = re.sub(r"TTFT (\d+ms|-)", "TTFT _", text)
    return re.sub(r"[\d.]+ tok/s", "_ tok/s", text)


def _report_lines(out):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        EX._report(out)
    return _masked(buf.getvalue())


KEYS = ("tokens", "choices", "plans", "lbm_frac", "prompt_len",
        "prefill_chunks", "kv_wanted", "kv_reserved", "kv_dtype",
        "departed")


@pytest.mark.parametrize("devices", [0, 2])
def test_example_equals_reference_servers(devices):
    argv = ARGS + (["--devices", str(devices)] if devices else [])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = EX.main(argv, params_fn=ref_params, prompt_fn=ref_prompt)
    want = _reference_runs(devices)
    assert [label for label, _ in got] == [label for label, _ in want]
    for (label, g), (_, w) in zip(got, want):
        assert set(g["tenants"]) == set(w["tenants"]), label
        for tid, info in w["tenants"].items():
            mine = g["tenants"][tid]
            assert {k: mine[k] for k in KEYS} == {k: info[k] for k in KEYS}, \
                (label, tid)
            np.testing.assert_array_equal(mine["output"], info["output"],
                                          err_msg=f"{label} {tid}")
        if label == "fleet":
            assert g["routes"] == w["routes"]
            assert [r["tenants"] for r in g["replicas"]] == \
                [r["tenants"] for r in w["replicas"]]
        else:
            assert _report_lines(g) == _report_lines(w)
            assert _report_lines(g) in _masked(buf.getvalue())
    printed = buf.getvalue()
    if devices:
        assert printed.startswith("fleet: 2 replica chips x 24 pages")
        assert "  routed: " in printed
    else:
        assert "contended pool" in printed


def test_reference_report_prints_the_same_lines():
    """The report is the reference example's own formatting: its
    ``_report`` on the reference's main run prints the port's lines."""
    ref = _reference_example()
    (_, out), _ = _reference_runs(0)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ref._report(out)
    assert _masked(buf.getvalue()) == _report_lines(out)
