"""Serving-fleet meshes (port of src/repro/launch/mesh.py's
``make_serving_mesh``, ``replica_submeshes``, ``replica_devices`` and
``chips``).

Axis roles (the fleet in :mod:`repro_torch.launch.serve`):
  data  — replica axis: each index along 'data' is one serving replica
          (one device, or one tensor-parallel group of devices) running
          its own epoch pipeline with its own CaMDN control stack.
  model — tensor parallelism inside a replica group: the group's
          params split by ``distributed/sharding.py::param_specs``,
          one piece on each of its devices
          (``distributed/tensor_parallel.py``).

A mesh is a :class:`ServingMesh`: an ``(n_replicas, tp)`` numpy object
array of ``torch.device`` and the axis names, so the fleet reads
``mesh.devices.shape`` as the reference reads a JAX ``Mesh``'s, and the
sharding rules read ``shape`` (axis name -> size) and ``axis_names``.  The
same device may appear more than once: replicas then share it, as the
reference's forced host devices share one CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

AXIS_NAMES = ("data", "model")


@dataclasses.dataclass(frozen=True, eq=False)
class ServingMesh:
    """``devices``: an object array of ``torch.device``, one dim per
    axis name (``(n_replicas, tp)`` for a serving mesh)."""
    devices: np.ndarray
    axis_names: Tuple[str, ...] = AXIS_NAMES

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as a JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, self.devices.shape))


def _grid(devices: Sequence[Any], shape: Tuple[int, int]) -> np.ndarray:
    grid = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        grid[i] = torch.device(d)
    return grid.reshape(shape)


def make_serving_mesh(n_replicas: Optional[int] = None, tp: int = 1,
                      devices: Optional[Sequence[Any]] = None
                      ) -> ServingMesh:
    """Serving-fleet mesh: ``(n_replicas, tp)`` over ``('data',
    'model')``.  ``devices`` defaults to every visible CUDA device;
    ``n_replicas`` to as many replicas of ``tp`` devices as they hold."""
    devices = list(devices if devices is not None else
                   [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())])
    assert tp >= 1 and len(devices) >= tp, (tp, len(devices))
    if n_replicas is None:
        n_replicas = len(devices) // tp
    assert n_replicas * tp <= len(devices), \
        f"mesh ({n_replicas}, {tp}) needs {n_replicas * tp} devices, " \
        f"have {len(devices)}"
    return ServingMesh(_grid(devices[:n_replicas * tp], (n_replicas, tp)))


def replica_submeshes(mesh: ServingMesh) -> List[ServingMesh]:
    """Row ``r`` of the 'data' axis as a ``(1, tp)`` mesh with the same
    axis names: one replica's device group."""
    n = mesh.devices.shape[0]
    return [ServingMesh(mesh.devices[r:r + 1], mesh.axis_names)
            for r in range(n)]


def replica_devices(mesh: ServingMesh) -> List[torch.device]:
    """The first device of each replica group: where a tp = 1 replica
    places its tenants' params, caches and buffers."""
    return [mesh.devices[r].flat[0] for r in range(mesh.devices.shape[0])]


def chips(mesh: ServingMesh) -> int:
    return mesh.devices.size
