"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names (``repro_torch`` begins with ``repro``), a model
family imports nothing of the program, and a run without a card prints
no result."""
import ast
import subprocess
import sys

import pytest

from perfbench import families, harness

from conftest import ROOT

RUN_TINY = """
import json, sys, time
sys.path[:0] = [{root!r}, {src!r}]
from perfbench import harness
sys.path.insert(0, {tests!r})
from conftest import tiny_cell
harness.run_cell(tiny_cell("tiny-dense", "tiny-decode"), 5, 1.0, True, "cpu",
                 time.perf_counter())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    for name in ("repro_torch_extra", "jaxtyping", "flaxen.x"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.models", sys)
    assert harness.forbidden_modules() == ["repro.models"]


def test_a_run_loads_no_jax_and_no_reference_package():
    code = RUN_TINY.format(root=str(ROOT), src=str(ROOT / "src"),
                           tests=str(ROOT / "perfbench" / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(__import__("json").loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and "perfbench" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_no_card_no_result(tmp_path):
    out = subprocess.run([sys.executable, str(ROOT / "perfbench" / "run.py"),
                          "--workload", "granite-3-8b.decode", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert "correct" not in out.stdout


FAMILY_IMPORTS = {"torch", "numpy", "math"} | set(sys.stdlib_module_names)


@pytest.mark.parametrize("path", sorted(families.HERE.glob("*.py")),
                         ids=lambda p: p.name)
def test_a_family_imports_torch_numpy_and_the_standard_library(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"{path.name}: a relative import"
            tops.add(node.module.split(".")[0])
    assert tops <= FAMILY_IMPORTS, (path.name, tops - FAMILY_IMPORTS)
