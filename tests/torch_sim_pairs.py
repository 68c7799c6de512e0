"""Helpers for holding the port's simulator, codegen and figure drivers
(src/repro_torch/sim/, core/codegen.py, paper/, examples/quickstart.py)
against the JAX package's copies of the same code: a class-free view of
their results, and the copy rule each port file follows."""
import dataclasses
import enum
import importlib
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

# (reference file, port file): each port file is the reference's text
# under a header of comment lines, its imports renamed
COPIES = [
    ("src/repro/core/codegen.py", "core/codegen.py"),
    ("src/repro/sim/engine.py", "sim/engine.py"),
    ("src/repro/sim/workloads.py", "sim/workloads.py"),
    ("src/repro/sim/schedulers.py", "sim/schedulers.py"),
    ("src/repro/sim/reuse.py", "sim/reuse.py"),
    ("src/repro/sim/area.py", "sim/area.py"),
    ("src/repro/sim/driver.py", "sim/driver.py"),
    ("benchmarks/common.py", "paper/common.py"),
    ("benchmarks/fig2_contention.py", "paper/fig2_contention.py"),
    ("benchmarks/fig3_reuse.py", "paper/fig3_reuse.py"),
    ("benchmarks/fig7_speedup.py", "paper/fig7_speedup.py"),
    ("benchmarks/fig8_scaling.py", "paper/fig8_scaling.py"),
    ("benchmarks/fig9_qos.py", "paper/fig9_qos.py"),
    ("benchmarks/table3_area.py", "paper/table3_area.py"),
    ("benchmarks/arrival_sweep.py", "paper/arrival_sweep.py"),
    ("examples/quickstart.py", "examples/quickstart.py"),
]

# the figure drivers, by the reference's module name under benchmarks/
DRIVERS = ["fig2_contention", "fig3_reuse", "fig7_speedup", "fig8_scaling",
           "fig9_qos", "table3_area", "arrival_sweep"]


def copy_parts(ref_rel: str, port_rel: str):
    """(reference text, port text less its header), the port's imports
    renamed back and all whitespace removed, so that two equal results
    mean the port file is the reference's with only its imports
    renamed and re-indented."""
    ref = (ROOT / ref_rel).read_text()
    port = (PORT / port_rel).read_text().split("\n")
    while port and port[0].startswith("#"):
        port.pop(0)
    port = "\n".join(port)
    port = port.replace("repro_torch.paper.common", "benchmarks.common")
    port = port.replace("repro_torch.", "repro.")
    return ref, port


def squeeze(text: str) -> str:
    return re.sub(r"\s+", "", text)


def plain(x):
    """A class-free view of ``x``: a dataclass becomes its class name and
    its fields, an enum member its class name and value, so that equal
    values from the two packages' (distinct) classes compare equal."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                tuple(plain(getattr(x, f.name))
                      for f in dataclasses.fields(x)))
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.value)
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return tuple(plain(v) for v in x)
    return x


def sim_summary(sim, res) -> dict:
    """Everything a ``MultiTenantSim`` run leaves behind that the
    reference's tests and figure drivers read: the ``SimResult`` field by
    field (per task: latencies, inferences, deadlines met, traffic,
    arrival and departure), its derived metrics, the ``TrafficLedger``,
    the DRAM pool's utilization and the pages back in the pool."""
    return {
        "result": plain(res),
        "total_inferences": res.total_inferences,
        "per_task": [(t.task_id, t.inferences, t.dram_per_inference,
                      t.avg_latency, t.sla_rate) for t in res.tasks],
        "avg_latency": res.avg_latency,
        "avg_latency_by_model": res.avg_latency_by_model(),
        "dram_bytes_per_inference": res.dram_bytes_per_inference,
        "throughput": res.throughput,
        "sla_rate": res.sla_rate,
        "hit_rate": res.traffic.hit_rate,
        "ledger_total": plain(sim.nec.ledger.total),
        "ledger_per_tenant": plain(sim.nec.ledger.per_tenant),
        "nec_traffic": plain(sim.nec.traffic),
        "dram_utilization": sim.dram.utilization,
        "free_pages": sim.cache.free_pages,
        "num_pages": sim.cache.config.num_pages,
        "now": sim.engine.now,
    }


def driver_pair(name: str):
    """(the port's ``repro_torch.paper.<name>``, the reference's
    ``benchmarks.<name>``)."""
    return (importlib.import_module(f"repro_torch.paper.{name}"),
            importlib.import_module(f"benchmarks.{name}"))


def untimed(line: str) -> str:
    """A driver's CSV line less its second field, the wall microseconds."""
    name, _, derived = line.split(",", 2)
    return f"{name},{derived}"


def driver_main(mod, result, capsys) -> tuple:
    """``mod.main()`` over an already computed ``run()`` result: its CSV
    line less the time, and its ``RESULTS`` entry less ``us_per_call``."""
    saved = mod.run
    mod.run = lambda verbose=True: result
    try:
        capsys.readouterr()
        mod.main()
        out = capsys.readouterr().out
    finally:
        mod.run = saved
    results = sys.modules[mod.emit.__module__].RESULTS
    entry = dict(results[mod.__name__.rsplit(".", 1)[1]])
    del entry["us_per_call"]
    return [untimed(l) for l in out.splitlines()], entry
