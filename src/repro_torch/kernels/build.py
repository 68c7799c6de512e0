"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  A
library's file name carries a hash of its sources and flags, so an edited
source never loads a stale build.  Builds go to ``build/repro_torch_kernels``
at the root of the checkout (``.gitignore`` lists ``build/``) at first
use; :func:`build` compiles several sources at once, one ``nvcc`` process
each, all started together.

Nothing here runs at import: the CPU tests import every module of the
package on machines with no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("cache_matmul", "cache_matmul_quant", "block_fused_ffn",
           "flash_attention", "ssd_chunk")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME, /usr/local/cuda, or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels build "
                           "only where the CUDA toolkit is installed")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Dict[str, object]]:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all running at once.  Returns, per source compiled, the
    seconds until its compiler finished and the compiler's output
    (``-Xptxas -v``: registers and shared memory per kernel).  Raises
    after every compiler has exited if any of them failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    report: Dict[str, Dict[str, object]] = {}
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib


def menu_fields(tile) -> tuple:
    """The ints a C menu describes for one entry: the tile's own
    ``menu_fields()`` where it has them, else its five shape fields and
    its shared-memory bytes."""
    own = getattr(tile, "menu_fields", None)
    if own is not None:
        return tuple(own())
    return dataclasses.astuple(tile) + (tile.smem_bytes,)


def check_menu(describe, tiles: Sequence, name: str) -> None:
    """Hold a kernel module's Python tile menu against the one compiled
    into its library: ``describe(i, out)`` writes entry i's fields (those
    of :func:`menu_fields`) and returns the entry count."""
    out = (ctypes.c_int * 16)()
    n = describe(0, out)
    if n != len(tiles):
        raise RuntimeError(f"{name}: the library has {n} tiles, the Python "
                           f"menu {len(tiles)}")
    for i, t in enumerate(tiles):
        describe(i, out)
        want = menu_fields(t)
        got = tuple(out[:len(want)])
        if got != want:
            raise RuntimeError(f"{name}: tile {i} is {got} in the "
                               f"library, {want} in Python")
