"""The arrival vocabulary shared with the JAX package's simulator
(``TenantSpec``, ``PoissonArrivals``)."""
from repro_torch.sim.driver import PoissonArrivals, TenantSpec

__all__ = ["PoissonArrivals", "TenantSpec"]
