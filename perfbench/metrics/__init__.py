"""Per-layer metric readers, one file each: ``metrics/<name>.py`` holds
``read(run) -> float | None`` for the metric ``<name>`` of
``BENCHMARK.json``.  A reader that finds nothing to read returns None,
and the harness leaves the metric out of the result line.

``run`` is a plain dict:

* ``arch``, ``mix``, ``batch``: the cell's config (``arch``), traffic
  mix and rows per request;
* ``window``: the measured window's ``seconds``, output ``tokens``,
  ``arrivals`` sent, decode ``tenant_steps``, model ``flops`` (from
  shapes, the cell family's ``span_flops``), and the server's counters'
  change across it:
  ``capture_s``, ``captures``, ``sched_s``, ``admit_s`` (the harness's
  own time inside the server's planning, ``hook_s``, taken out of
  ``sched_s``; the profiler's own start and stop, ``profiler_s``, out of
  ``seconds``), and in a traced run on the card ``replay_s``, the
  device seconds of every program replayed in the window;
* ``trace``: None in an untraced run, else the traced slice's
  ``window_s``, ``busy_s``, ``kernel_s`` (device seconds by operation
  name), ``launches`` (the program's launch counters' change across the
  slice), ``tenant_steps`` (decode steps of every tenant in it) and
  ``idle_gaps``.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Any, Dict, Optional

HERE = Path(__file__).resolve().parent


def reader_path(name: str) -> Path:
    return HERE / f"{name}.py"


def read(name: str, run: Dict[str, Any]) -> Optional[float]:
    """The value of metric ``name`` in ``run``, from its reader."""
    path = reader_path(name)
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} at {path}")
    spec = importlib.util.spec_from_file_location(
        "perfbench.metrics._" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    value = mod.read(run)
    return None if value is None else float(value)
