"""The port stands alone: ``src/repro_torch`` and ``chip_smoke.py`` import
neither JAX, nor the JAX package (``repro``), nor ``msgpack`` (the
reference checkpoint's leaf format, absent on the card's machine), and
``chip_smoke.py`` prints no result without a card or without the port
beside it."""
import ast
import importlib
import inspect
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "repro", "msgpack")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_imports_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_kernel_and_the_ssm_slice_are_covered():
    """The sources above include the SSM and MoE slices' modules, the
    serve features' (checkpoint, straggler detector, fault schedule), the
    training slice's, the dry run's and the simulator's with the paper's
    figure drivers, and every CUDA source the build compiles sits beside
    them."""
    from repro_torch.kernels import build
    names = {p.relative_to(PORT).as_posix() for p in SOURCES
             if p.is_relative_to(PORT)}
    assert {"models/ssm.py", "models/moe.py", "kernels/ssd_scan.py",
            "kernels/ops.py", "checkpoint/checkpoint.py",
            "distributed/fault_tolerance.py", "sim/faults.py",
            "optim/adamw.py", "data/pipeline.py", "launch/train.py",
            "distributed/compression.py",
            "examples/train_100m.py", "distributed/sharding.py",
            "distributed/tensor_parallel.py",
            "examples/multi_tenant_serve.py", "launch/dryrun.py",
            "launch/cost_analysis.py", "launch/roofline.py",
            "core/codegen.py", "sim/engine.py", "sim/schedulers.py",
            "sim/workloads.py", "sim/reuse.py", "sim/area.py",
            "sim/driver.py", "paper/common.py", "paper/fig2_contention.py",
            "paper/fig3_reuse.py", "paper/fig7_speedup.py",
            "paper/fig8_scaling.py", "paper/fig9_qos.py",
            "paper/table3_area.py", "paper/arrival_sweep.py",
            "examples/quickstart.py"} <= names
    assert {"ssd_chunk", "ssd_chunk_bwd"} <= set(build.SOURCES)
    for name in build.SOURCES:
        assert (PORT / "csrc" / f"{name}.cu").is_file(), name


@pytest.mark.parametrize("module, name", [
    ("repro_torch.models.model", "init_params"),
    ("repro_torch.models.attention", "init_kv_cache"),
    ("repro_torch.models.ssm", "init_ssm_state"),
    ("repro_torch.bridge", "params_from_numpy"),
    ("repro_torch.bridge", "caches_from_numpy"),
    ("repro_torch.launch.serve", "MultiTenantServer"),
    ("repro_torch.checkpoint.checkpoint", "restore"),
    ("repro_torch.bridge", "opt_state_from_numpy"),
    ("repro_torch.launch.train", "build"),
])
def test_entry_points_run_on_the_card_unless_told(module, name):
    """Every entry point that places tensors defaults to ``"cuda"``: the
    CPU is used only where the caller names it."""
    fn = getattr(importlib.import_module(module), name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_serve_features_keep_the_card_default(tmp_path):
    """A server built with every serve feature's argument (none of them
    names a device) still serves on the card; only the CPU-free parts
    run here (no tenant is admitted)."""
    from repro_torch.distributed.fault_tolerance import StragglerPolicy
    from repro_torch.launch.serve import MultiTenantServer
    from repro_torch.sim.driver import BackoffPolicy
    from repro_torch.sim.faults import FaultEvent, FaultPlan
    srv = MultiTenantServer(
        [], prefix_dedup=True, lookahead=True,
        faults=FaultPlan([FaultEvent(step=4, kind="preempt")]),
        preemption_policy=None, straggler_policy=StragglerPolicy(),
        ckpt_dir=str(tmp_path), queue_limit=4, queue_deadline_s=1.0,
        backoff=BackoffPolicy())
    assert srv.device.type == "cuda"
    params = inspect.signature(MultiTenantServer).parameters
    for name in ("prefix_dedup", "lookahead", "faults", "preemption_policy",
                 "straggler_policy", "ckpt_dir", "queue_limit",
                 "queue_deadline_s", "backoff"):
        assert name in params, name


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    return env


def test_importing_every_port_module_loads_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch, chip_smoke\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n in ('jax', 'repro')"
        " or n.startswith(('jax.', 'repro.')))\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad or len(mods) < 20 else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], env=_env(), cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_prints_no_result_without_a_card():
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          env={**_env(), "CUDA_VISIBLE_DEVICES": ""}, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_chip_smoke_prints_no_result_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                          cwd=tmp_path, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
