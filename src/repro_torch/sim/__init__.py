"""The arrival vocabulary shared with the JAX package's simulator
(``TenantSpec``, ``PoissonArrivals``, ``SessionArrivals``,
``BackoffPolicy``) and the serving fault schedule (``sim.faults``)."""
from repro_torch.sim.driver import (BackoffPolicy, PoissonArrivals,
                                    SessionArrivals, TenantSpec)

__all__ = ["BackoffPolicy", "PoissonArrivals", "SessionArrivals",
           "TenantSpec"]
