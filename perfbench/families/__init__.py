"""Model families, one file each: a config file's ``"family"`` names
``families/<family>.py``, which the harness loads by path, as it loads a
metric's reader.  A new architecture comes in as a new file here and a
config that names it; no file of the harness changes.

A family module holds everything of the benchmark that depends on the
model's block, and imports nothing but ``torch``, ``numpy``, ``math`` and
the standard library (nothing of the program, nothing of JAX):

``make(arch, seed, instance, device)``
    One weight set, the same for the same ``(seed, instance)``, made on
    ``device`` from a ``torch.Generator`` seeded from both, in a few large
    calls (each kind of leaf for every layer at once), in the served dtype
    ``arch["dtype"]``, and in the program's parameter layout: the nested
    dict of tensors that ``MultiTenantServer``'s ``params_fn`` hands the
    program for this arch.  The program and the reference read the same
    tensors.

``hidden(weights, arch, tokens, quant=None)``
    The plain reference: the final normed hidden states [r, T, d] in
    float32 of token rows ``tokens`` [r, T], each row from position 0,
    causal, one layer at a time with that layer's weights upcast to
    float32 as it runs (so it fits beside the bf16 weight sets), with no
    cache and no kernel or module of the program.  The caller switches
    TF32 off (``reference/compare.py::no_tf32``), so every float32 product
    is a float32 product.

``logits(weights, arch, h, quant=None)``
    Logits over the padded vocabulary (``vocab_size`` rounded up to a
    multiple of 256, the program's table), the padding columns set to a
    large negative number so that no argmax lands there.

``span_flops(arch, start, stop)``
    One row's model operations (multiply-adds x 2) for the tokens at
    positions [start, stop), from shapes alone: every projection, expert
    and head, and attention over each token's causal context.  ``mfu``
    reads its sum over the window.

``quant="fp8"`` is the control's path: every linear layer's weight (per
output column) and input (per row) rounded to float8 e4m3 before a
float32 product.  ``hidden`` and ``logits`` take it alike; the benchmark's
own runs never pass it.

A configuration that holds a share of its experts on one chip (expert
parallelism over many): ``make`` builds only the experts held here, with
the router over all of them; ``hidden`` routes every token over all the
experts, as the published model does, and adds only the part of the
experts held here (the program's output on this chip); ``span_flops``
counts the work this chip does, the held experts' share of the routed
tokens and everything else whole.  The config file states which experts
are held.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path
from types import ModuleType
from typing import Any, Dict

HERE = Path(__file__).resolve().parent


def family_path(name: str) -> Path:
    return HERE / f"{name}.py"


def load(config: Dict[str, Any]) -> ModuleType:
    """The family module that the config file names under ``"family"``."""
    if "family" not in config:
        raise KeyError(f"config {config.get('name')!r} names no \"family\"")
    name = config["family"]
    path = family_path(name)
    if not path.is_file():
        raise FileNotFoundError(f"config {config.get('name')!r} names family "
                                f"{name!r}: no file {path}")
    module = "perfbench.families._" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
