"""The kernels' launch counters, read and moved as one flat dict.

Each kernel wrapper adds one to its module's count (and its tile kind's)
where it launches its kernel.  A captured CUDA graph runs no Python when
it is replayed, so the wrappers count at capture, not at launch.  A
graph's owner therefore takes :func:`delta` of its capture (the launches
the graph holds), takes them back with :func:`add` (capture launches
nothing), and adds them again at every replay: the counts then stay the
launches the device ran, graph or not.

Names are the kernel's (``cache_matmul``, ``block_fused_ffn``,
``flash_attention``, ``flash_attention_quantized``,
``cache_matmul_quant``, ``ssd_chunk``) and ``<kernel>.<kind>`` for each
tile kind (``cache_matmul.gemv``, ``ssd_chunk.wgmma`` ...).
"""
from __future__ import annotations

from typing import Dict, Mapping

from repro_torch.kernels import block_fused_ffn as kffn
from repro_torch.kernels import cache_matmul as kmm
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ssd_scan as kssd

# (name, module, total attribute, by-kind attribute)
_COUNTERS = (
    ("cache_matmul", kmm, "launches", "launches_by_kind"),
    ("block_fused_ffn", kffn, "launches", "launches_by_kind"),
    ("flash_attention", kfa, "launches", "launches_by_kind"),
    ("flash_attention_quantized", kfa, "launches_quantized",
     "launches_quantized_by_kind"),
    ("cache_matmul_quant", kmm, "launches_quant", "launches_quant_by_kind"),
    ("ssd_chunk", kssd, "launches", "launches_by_kind"),
)


def snapshot() -> Dict[str, int]:
    """Every kernel's launch count, and each split by tile kind."""
    out: Dict[str, int] = {}
    for name, mod, total, by_kind in _COUNTERS:
        out[name] = getattr(mod, total)
        out.update({f"{name}.{k}": v
                    for k, v in getattr(mod, by_kind).items()})
    return out


def delta(before: Mapping[str, int]) -> Dict[str, int]:
    """The launches counted since ``before`` (a :func:`snapshot`), only
    the counts that moved."""
    now = snapshot()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


def add(counts: Mapping[str, int], sign: int = 1) -> None:
    """Add ``sign`` times ``counts`` (a :func:`delta`) to the counters."""
    for name, mod, total, by_kind in _COUNTERS:
        if name in counts:
            setattr(mod, total, getattr(mod, total) + sign * counts[name])
        kinds = getattr(mod, by_kind)
        for k in kinds:
            kinds[k] += sign * counts.get(f"{name}.{k}", 0)


def zero() -> None:
    """Set every count to 0."""
    add(snapshot(), -1)
