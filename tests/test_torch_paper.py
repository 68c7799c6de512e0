"""The port's figure drivers (src/repro_torch/paper/) and quickstart
(src/repro_torch/examples/quickstart.py) against the JAX package's
(benchmarks/, examples/quickstart.py) on the CPU: each driver's
``run(verbose=False)`` result is equal to the reference's, its verbose
lines and its CSV line (less the wall time) are the reference's, and
quickstart prints the reference's lines.  Figs. 8 and 9, the slowest,
are in tests/test_torch_paper_scaling.py.  Every number is the paper's
simulated NPU SoC's."""
import functools
import os
import subprocess
import sys

import pytest

from torch_sim_pairs import ROOT, driver_main, driver_pair, plain, untimed

NAMES = ["fig2_contention", "fig3_reuse", "fig7_speedup", "table3_area",
         "arrival_sweep"]


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


@pytest.mark.parametrize("name", ["fig3_reuse", "fig7_speedup",
                                  "table3_area"])
def test_verbose_lines_equal_reference(name, capsys):
    port, ref = driver_pair(name)
    capsys.readouterr()
    got = port.run(verbose=True)
    got_out = capsys.readouterr().out
    want = ref.run(verbose=True)
    assert got_out == capsys.readouterr().out
    assert got_out and plain(got) == plain(want)


def test_fig7_holds_the_reference_bands():
    """ref tests/test_sim.py:118-149: average speedup in [1.5, 2.4], the
    largest at most 3.0, average memory reduction in [0.25, 0.45]."""
    r, _ = _results("fig7_speedup")
    assert 1.5 <= r["avg_full"] <= 2.4 and r["max_full"] <= 3.0
    assert 0.25 <= r["mem_reduction"] <= 0.45


def _python(args):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    proc = subprocess.run([sys.executable] + args, env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.splitlines()


def test_quickstart_prints_reference_lines():
    got = _python(["-m", "repro_torch.examples.quickstart"])
    assert got == _python(["examples/quickstart.py"])
    assert got[-1].startswith("Makespan") and got[-2].startswith("Saved")


@pytest.mark.parametrize("name", ["fig3_reuse", "table3_area"])
def test_module_entry_point_prints_reference_lines(name):
    got = _python(["-m", f"repro_torch.paper.{name}"])
    want = _python([f"benchmarks/{name}.py"])
    assert got[:-1] == want[:-1]
    assert untimed(got[-1]) == untimed(want[-1])
