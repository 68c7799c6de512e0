"""Figs. 8 and 9 from the port's drivers (src/repro_torch/paper/
fig8_scaling.py, fig9_qos.py) against the JAX package's (benchmarks/) on
the CPU: ``run(verbose=False)`` equal to the reference's, and the CSV
line (less the wall time) the reference's.  The two slowest drivers sit
in a file of their own so that the suite's workers share them out.
Every number is the paper's simulated NPU SoC's."""
import functools

import pytest

from torch_sim_pairs import driver_main, driver_pair, plain

NAMES = ["fig8_scaling", "fig9_qos"]


@functools.lru_cache(maxsize=None)
def _results(name):
    port, ref = driver_pair(name)
    return port.run(verbose=False), ref.run(verbose=False)


@pytest.mark.parametrize("name", NAMES)
def test_run_equals_reference(name):
    got, want = _results(name)
    assert plain(got) == plain(want)


@pytest.mark.parametrize("name", NAMES)
def test_main_prints_reference_line(name, capsys):
    port, ref = driver_pair(name)
    got, want = _results(name)
    assert driver_main(port, got, capsys) == driver_main(ref, want, capsys)


def test_fig8_every_cell_cuts_latency_and_traffic():
    """CaMDN below the baseline in every (cache size, tenants) cell."""
    r, _ = _results("fig8_scaling")
    cells = [v for k, v in r.items() if isinstance(k, tuple)]
    assert len(cells) == 9
    assert all(lat > 0 and mem > 0 for lat, mem in cells)
