"""Scheduling-only runs of the port's server, for tests of what its
scheduler decides at full width, where no weights can be made here.

``dry_server`` builds a :class:`repro_torch.launch.serve.MultiTenantServer`
on the CPU whose tenants get no weights and one-element-wide cache
leaves, and whose prompt-chunk and decode-item programs are empty: the
server's own epoch dispatch runs (``_dispatch_epoch_inner``,
``_dispatch_prefill``, the first-token, prefix-registration and
departure paths), and only the model's device work is left out.
Grants, plans, prefill chunks, prefix hits, lookahead adjustments and
fault decisions are the server's own (they never read a device value);
tokens are not computed.  The chip run (``chip_smoke.py``) executes
the same schedules.
"""
import torch

from repro_torch.launch import serve as PS
from repro_torch.models.transformer import num_groups


def _tiny_caches(params, cfg, batch, max_len, kv_dtype=None, device=None):
    return [{"k": torch.zeros((batch, max_len, 1, 1))}
            for _ in range(num_groups(cfg))]


def dry_server(monkeypatch, specs, **kw):
    """A scheduling-only server of ``specs`` (pytest's ``monkeypatch``
    scopes the cache stub to the test)."""
    monkeypatch.setattr(PS, "init_caches", _tiny_caches)
    srv = PS.MultiTenantServer([], tenants=specs, device="cpu",
                               params_fn=lambda cfg, seed: None, **kw)
    srv._prefill_fn = lambda *args: (lambda: None)
    srv._fused_epoch_fn = lambda item: (lambda: None)
    return srv


def dry_fleet(monkeypatch, specs, **kw):
    """A scheduling-only :class:`repro_torch.launch.serve.FleetServer` on
    the CPU: every replica as ``dry_server``'s."""
    monkeypatch.setattr(PS, "init_caches", _tiny_caches)
    fleet = PS.FleetServer(tenants=specs, params_fn=lambda cfg, seed: None,
                           **kw)
    for srv in fleet.replicas:
        srv._prefill_fn = lambda *args: (lambda: None)
        srv._fused_epoch_fn = lambda item: (lambda: None)
    return fleet
