"""Checkpointing of torch tensor trees: atomic, manifest-driven save and
restore (port of src/repro/checkpoint/checkpoint.py: ``save`` :42,
``save_async`` :79, ``latest_step`` :92, ``restore`` :99).

Layout, as the reference's:
  <dir>/step_000123/
      manifest.json        # tree structure, shapes, dtypes, offsets, extra
      arrays.bin           # every leaf's raw bytes, host-gathered
  <dir>/LATEST             # atomic pointer (write tmp + rename)

The leaf file differs.  The reference packs each leaf with ``msgpack``
as numpy bytes; numpy has no bfloat16 or float8 type of its own and the
port needs neither ``msgpack`` nor ``ml_dtypes``.  So each leaf's bytes
are written through a ``uint8`` view of the contiguous tensor, one leaf
after another at 64-byte aligned offsets, and the manifest keeps each
leaf's offset, byte count, shape and torch dtype name (``bfloat16``,
``float8_e4m3fn``, ``int8``, ...).  A restore reinterprets the same
bytes, so every dtype comes back bit for bit.  The reference's msgpack
buffer limit (2**31 bytes) has no counterpart.

Trees are nested dicts, lists and tuples with tensor leaves (a numpy
array is taken as a tensor); :func:`_flatten` is the port's own flatten
(dict keys sorted, as ``jax.tree_util`` orders them).  ``restore``
rebuilds the saved structure, or ``tree_like``'s when one is given (its
containers' own types, a NamedTuple such as the optimizer's
``AdamWState`` included, as the reference's pytree restore does), and
puts the leaves on the device the caller names (the card unless told).
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import tempfile
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_ALIGN = 64


def _flatten(tree: Any) -> Tuple[List[Any], Any]:
    """(leaves, structure): the structure is JSON (``{"dict": {key:
    sub}}``, ``{"list": [...]}``, ``{"tuple": [...]}``, or None for a
    leaf)."""
    if isinstance(tree, dict):
        leaves, subs = [], {}
        for k in sorted(tree):
            got, subs[k] = _flatten(tree[k])
            leaves += got
        return leaves, {"dict": subs}
    if isinstance(tree, (list, tuple)):
        leaves, subs = [], []
        for x in tree:
            got, sub = _flatten(x)
            leaves += got
            subs.append(sub)
        return leaves, {"tuple" if isinstance(tree, tuple) else "list": subs}
    return [tree], None


def _unflatten(structure: Any, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        if "dict" in s:
            return {k: build(v) for k, v in s["dict"].items()}
        if "list" in s:
            return [build(v) for v in s["list"]]
        return tuple(build(v) for v in s["tuple"])
    return build(structure)


def _like(tree: Any, leaves) -> Any:
    """``tree``'s structure, containers of its own types (a NamedTuple
    too), filled from the iterator ``leaves`` in :func:`_flatten`'s
    order."""
    if isinstance(tree, dict):
        got = {k: _like(tree[k], leaves) for k in sorted(tree)}
        return {k: got[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        items = [_like(x, leaves) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return next(leaves)


def _host(leaf: Any) -> torch.Tensor:
    """A leaf as a contiguous CPU tensor (waits for the device)."""
    if isinstance(leaf, np.ndarray):
        leaf = torch.from_numpy(np.ascontiguousarray(leaf))
    return leaf.detach().to("cpu").contiguous()


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def save(ckpt_dir: str | pathlib.Path, step: int, tree: Any,
         extra: Optional[Dict[str, Any]] = None) -> pathlib.Path:
    """Atomic checkpoint write; returns the step directory.  Device
    leaves are copied to the host first, which waits for the work queued
    on them."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    leaves, structure = _flatten(tree)
    leaves = [_host(leaf) for leaf in leaves]
    step_dir = ckpt_dir / f"step_{step:08d}"
    tmp = pathlib.Path(tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_"))
    try:
        metas, offset = [], 0
        with open(tmp / "arrays.bin", "wb") as f:
            for leaf in leaves:
                pad = -offset % _ALIGN
                f.write(b"\0" * pad)
                offset += pad
                raw = leaf.reshape(-1).view(torch.uint8).numpy().tobytes()
                f.write(raw)
                metas.append({"shape": list(leaf.shape),
                              "dtype": _dtype_name(leaf.dtype),
                              "offset": offset, "nbytes": len(raw)})
                offset += len(raw)
        manifest = {"step": step, "structure": structure, "leaves": metas,
                    "extra": extra or {}}
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if step_dir.exists():
            shutil.rmtree(step_dir)
        tmp.rename(step_dir)
        # atomic LATEST pointer
        ptr = ckpt_dir / ".LATEST_tmp"
        ptr.write_text(step_dir.name)
        ptr.rename(ckpt_dir / "LATEST")
        return step_dir
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)


def save_async(ckpt_dir, step: int, tree: Any,
               extra: Optional[Dict[str, Any]] = None) -> threading.Thread:
    """Fire-and-join-later save: the copy to the host happens on the
    caller's thread (ordered after the work queued on the leaves), the
    file writes on a background thread."""
    leaves, structure = _flatten(tree)
    host_tree = _unflatten(structure, [_host(leaf).clone() for leaf in leaves])
    t = threading.Thread(target=save, args=(ckpt_dir, step, host_tree),
                         kwargs={"extra": extra}, daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir) -> Optional[int]:
    ptr = pathlib.Path(ckpt_dir) / "LATEST"
    if not ptr.exists():
        return None
    return int(ptr.read_text().strip().split("_")[-1])


def checkpoint_bytes(step_dir: str | pathlib.Path) -> int:
    """Bytes one step directory holds on disk (manifest and leaves)."""
    return sum(os.path.getsize(p) for p in pathlib.Path(step_dir).iterdir())


def restore(ckpt_dir, tree_like: Any = None, step: Optional[int] = None,
            device: Any = "cuda") -> Tuple[Any, Dict[str, Any]]:
    """Restore a checkpoint (the latest unless ``step`` is given): the
    saved tree (its tuples plain tuples), or ``tree_like``'s structure
    when one is given (its leaf count must match; its dicts, lists,
    tuples and NamedTuples come back as their own types), with every
    leaf on ``device``.  Returns (tree, extra)."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    step_dir = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((step_dir / "manifest.json").read_text())
    structure = manifest["structure"]
    if tree_like is not None:
        leaves_like, _ = _flatten(tree_like)
        if len(manifest["leaves"]) != len(leaves_like):
            raise ValueError(
                f"checkpoint has {len(manifest['leaves'])} leaves, "
                f"target structure has {len(leaves_like)}")
    buf = bytearray((step_dir / "arrays.bin").read_bytes())
    out = []
    for meta in manifest["leaves"]:
        dtype = getattr(torch, meta["dtype"])
        if meta["nbytes"] == 0:
            leaf = torch.empty(meta["shape"], dtype=dtype)
        else:
            leaf = (torch.frombuffer(buf, dtype=torch.uint8,
                                     count=meta["nbytes"],
                                     offset=meta["offset"])
                    .view(dtype).reshape(meta["shape"]))
        # a copy of its own: no leaf keeps the whole file's buffer
        out.append(leaf.to(device, copy=True))
    if tree_like is not None:
        return _like(tree_like, iter(out)), manifest["extra"]
    return _unflatten(structure, out), manifest["extra"]
