# Verbatim copy of src/repro/sim/area.py (lines 1-77: the analytic 45 nm
# area model (Table III); NpuAreaConfig :28, npu_area :36, cache_slice_area
# :51, table3 :69); only the package name in its imports differs. It imports
# no framework.
"""Analytic 45 nm area model reproducing paper Table III.

The paper synthesizes CaMDN (Design Compiler, 45 nm, OpenRAM macros).
Without a synthesis flow we reproduce the area *breakdown* with standard
45 nm density figures: dual-port SRAM for NPU-local storage, high-density
single-port SRAM for LLC data arrays, register-file bits for queues, and
a NAND2-equivalent gate size for control logic.  Constants are standard
45 nm planning numbers; the model's outputs are validated against
Table III in tests/test_area.py.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core.cache import CacheConfig

# 45nm planning constants (um^2)
SRAM_DP_PER_BYTE = 24.0      # dual-port (scratchpad-class) SRAM
SRAM_HD_PER_BYTE = 10.4      # high-density single-port (LLC data arrays)
SRAM_TAG_PER_BYTE = 21.0     # tag arrays (wide compare ports)
REGFILE_PER_BYTE = 55.0      # flip-flop based storage (queues, masks)
GATE_NAND2 = 1.06            # one NAND2-equivalent gate
PE_INT8_MAC = 1272.0         # int8 MAC + pipeline regs + weight reg


@dataclasses.dataclass(frozen=True)
class NpuAreaConfig:
    pe_rows: int = 32
    pe_cols: int = 32
    scratchpad_bytes: int = 256 * 2**10
    cpt_entries: int = 512
    cpt_entry_bytes: int = 3


def npu_area(cfg: NpuAreaConfig = NpuAreaConfig()) -> Dict[str, float]:
    """Per-NPU area breakdown (um^2), mirroring Table III left."""
    scratchpad = cfg.scratchpad_bytes * SRAM_DP_PER_BYTE
    pe_array = cfg.pe_rows * cfg.pe_cols * PE_INT8_MAC
    # CPT: SRAM bits + per-entry update/lookup logic (two ports)
    cpt_sram = cfg.cpt_entries * cfg.cpt_entry_bytes * SRAM_DP_PER_BYTE
    cpt_logic = cfg.cpt_entries * 36 * GATE_NAND2  # mux/compare per entry
    cpt = cpt_sram + cpt_logic
    # sequencer, DMA engines, NoC interface
    others = 0.029 * (scratchpad + pe_array + cpt) / (1 - 0.029)
    total = scratchpad + pe_array + cpt + others
    return {"Scratchpad": scratchpad, "PE Array": pe_array, "CPT": cpt,
            "others": others, "NPU": total}


def cache_slice_area(cache: CacheConfig = CacheConfig()) -> Dict[str, float]:
    """Per-cache-slice area breakdown (um^2), mirroring Table III right."""
    slice_bytes = cache.slice_bytes
    data = slice_bytes * SRAM_HD_PER_BYTE
    lines = slice_bytes // cache.line_bytes
    # tag: ~28 bits tag+state per line
    tag = lines * 3.5 * SRAM_TAG_PER_BYTE
    # NEC: dual-interface arbiter + request queues (2 x 8 entries x 32B)
    # + way-mask register + line r/w sequencer + multicast combine table
    nec_queues = 2 * 8 * 32 * REGFILE_PER_BYTE
    nec_logic = 36_000 * GATE_NAND2
    nec = nec_queues + nec_logic
    others = 0.013 * (data + tag + nec) / (1 - 0.013)
    total = data + tag + nec + others
    return {"Data Array": data, "Tag Array": tag, "NEC": nec,
            "others": others, "Cache Slice": total}


def table3() -> Dict[str, Dict[str, float]]:
    npu = npu_area()
    sl = cache_slice_area()
    return {
        "npu": {k: v for k, v in npu.items()},
        "npu_pct": {k: 100.0 * v / npu["NPU"] for k, v in npu.items()},
        "slice": {k: v for k, v in sl.items()},
        "slice_pct": {k: 100.0 * v / sl["Cache Slice"] for k, v in sl.items()},
    }
