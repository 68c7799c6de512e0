# Verbatim copy of src/repro/core/cpt.py (the JAX package's framework-free
# scheduling code); only the package name in imports differs.
"""Cache page table (CPT): per-NPU vcaddr -> pcaddr translation.

Paper Section III-B(3): every NPU holds a hardware CPT of at most
``cache_bytes / page_bytes`` entries (512 for 16 MB / 32 KB), each entry
storing a physical cache page number (pcpn) plus a valid bit in <= 3
bytes.  Tenants address their model-exclusive cache region through an
independent *virtual cache address space*; the scheduler installs /
revokes mappings when pages are granted / reclaimed.

The table is backed by dense numpy arrays (``pcpn`` + valid mask) so the
NEC hot path can validate and translate a whole byte window in one
vectorized check (:meth:`translate_range`) instead of one dict lookup
per 64-byte line.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.core.cache import CacheConfig


class CptFault(Exception):
    """Access through an invalid CPT entry (unmapped vcpn)."""


class CachePageTable:
    """One CPT instance (one per NPU in hardware; one per tenant here —
    the paper assigns a group of NPUs running the same model identical
    CPT contents, which multicast exploits)."""

    def __init__(self, config: CacheConfig):
        self.config = config
        self.max_entries = config.num_pages
        self._pcpn = np.zeros(self.max_entries, dtype=np.int64)
        self._valid = np.zeros(self.max_entries, dtype=bool)

    # ---- scheduler-side management ----------------------------------
    def map(self, vcpn: int, pcpn: int) -> None:
        if not (0 <= vcpn < self.max_entries):
            raise ValueError(f"vcpn {vcpn} out of range (max {self.max_entries})")
        if not (0 <= pcpn < self.config.num_pages):
            raise ValueError(f"pcpn {pcpn} out of range")
        self._pcpn[vcpn] = pcpn
        self._valid[vcpn] = True

    def unmap(self, vcpn: int) -> None:
        if 0 <= vcpn < self.max_entries:
            self._valid[vcpn] = False

    def clear(self) -> None:
        self._valid[:] = False

    def map_pages(self, pcpns: List[int], base_vcpn: int = 0) -> None:
        """Install a contiguous virtual window over ``pcpns``."""
        n = len(pcpns)
        if n == 0:
            return
        if not (0 <= base_vcpn and base_vcpn + n <= self.max_entries):
            raise ValueError(f"vcpn window [{base_vcpn}, {base_vcpn + n}) "
                             f"out of range (max {self.max_entries})")
        if min(pcpns) < 0 or max(pcpns) >= self.config.num_pages:
            raise ValueError("pcpn out of range")
        self._pcpn[base_vcpn:base_vcpn + n] = pcpns
        self._valid[base_vcpn:base_vcpn + n] = True

    @property
    def mapped_vcpns(self) -> List[int]:
        return [int(v) for v in np.flatnonzero(self._valid)]

    @property
    def num_valid(self) -> int:
        return int(np.count_nonzero(self._valid))

    # ---- NPU-side translation (hardware path) ------------------------
    def translate(self, vcaddr: int) -> int:
        page = self.config.page_bytes
        vcpn, offset = divmod(vcaddr, page)
        if not (0 <= vcpn < self.max_entries) or not self._valid[vcpn]:
            raise CptFault(f"vcpn {vcpn} not mapped")
        return int(self._pcpn[vcpn]) * page + offset

    def translate_line(self, vcaddr: int) -> int:
        """Translate and return the pcaddr of the *line* containing vcaddr."""
        pc = self.translate(vcaddr)
        return pc & ~(self.config.line_bytes - 1)

    def translate_range(self, vcaddr: int, nbytes: int) -> np.ndarray:
        """Validate the whole byte window ``[vcaddr, vcaddr + nbytes)`` in
        one vectorized check and return the pcpns of the pages it covers
        (one entry per vcpn, in window order).  Raises :class:`CptFault`
        if ANY covered entry is invalid — the check happens before any
        caller-side mutation, so faults are atomic."""
        if nbytes <= 0:
            return np.empty(0, dtype=np.int64)
        page = self.config.page_bytes
        v0 = vcaddr // page
        v1 = (vcaddr + nbytes - 1) // page + 1
        if v0 < 0 or v1 > self.max_entries:
            raise CptFault(f"vcpn window [{v0}, {v1}) out of range")
        valid = self._valid[v0:v1]
        if not valid.all():
            bad = v0 + int(np.argmin(valid))
            raise CptFault(f"vcpn {bad} not mapped")
        return self._pcpn[v0:v1]

    # ---- hardware cost model (Table III) ------------------------------
    @property
    def sram_bytes(self) -> int:
        """<=3 bytes per entry (pcpn + valid bit), per the paper."""
        return self.max_entries * 3
