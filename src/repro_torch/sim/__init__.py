"""Event-driven multi-tenant NPU/cache simulator (paper Section IV),
copied from the JAX package (its exports at src/repro/sim/__init__.py
:2-7), and the arrival vocabulary the serving path shares with it
(``TenantSpec``, ``PoissonArrivals``, ``SessionArrivals``,
``BackoffPolicy``) beside the serving fault schedule (``sim.faults``).
The simulator prices the paper's simulated NPU SoC analytically; it
launches nothing on a device."""
from repro_torch.sim.driver import (BackoffPolicy, MultiTenantSim,
                                    PoissonArrivals, SessionArrivals,
                                    SimConfig, SimResult, TaskResult,
                                    TenantSpec, isolated_latencies)
from repro_torch.sim.engine import CorePool, DramResource, Engine
from repro_torch.sim.schedulers import (SCHEDULERS, TransparentParams,
                                        transparent_layer_dram,
                                        transparent_plan)
from repro_torch.sim.workloads import benchmark_models

__all__ = [
    "MultiTenantSim", "SimConfig", "SimResult", "TaskResult",
    "isolated_latencies", "Engine", "DramResource", "CorePool",
    "SCHEDULERS", "TransparentParams", "transparent_plan",
    "transparent_layer_dram", "benchmark_models",
    "BackoffPolicy", "PoissonArrivals", "SessionArrivals", "TenantSpec",
]
