"""Async gateway: overlapped drains, multi-graph tenancy, witness
streaming (the port's copy of the JAX package's ``repro.gateway``,
whose docstring holds the design notes).

One process, many independent graphs/streams.  The gateway layers over
``api.Session`` / ``stream.StreamingSession`` and decides only WHEN work
runs, so its counts are bit-identical to solo ``estimate()`` runs:

* **Overlapped execution** (``scheduler.FairScheduler``): intake, emit
  and drains on separate threads; tenants served round-robin; a tenant
  past its pending quota is shed as ``overloaded``.
* **Multi-graph tenancy** (``state.GatewayState``): ``open_tenant`` /
  ``close_tenant``, idle-LRU eviction, per-tenant WAL paths derived from
  the server's ``wal_dir`` (recovered on reopen).
* **Witness streaming**: a request with ``witnesses=n`` emits one
  progress line per checkpoint window before its final response.

The wire loop (``python -m repro_torch.launch.estimate --serve
--gateway``) or directly::

    import io
    from repro_torch.api import EstimateConfig
    from repro_torch.gateway import gateway_serve_loop

    lines = "\\n".join([
        '{"cmd": "open_tenant", "tenant": "fin",'
        ' "graph": "fintxn:n_accounts=500,n_events=4000,seed=5"}',
        '{"tenant": "fin", "id": 1, "motif": "M5-3", "delta": 4000,'
        ' "k": 16384, "witnesses": 5}',
        '{"cmd": "quit"}',
    ]) + "\\n"
    out = io.StringIO()
    gateway_serve_loop(EstimateConfig(device="cpu"),
                       infile=io.StringIO(lines), outfile=out)

Every tenant runs on the config's ``device`` ("cuda" by default).
"""
from .io import Emitter, LineSource
from .scheduler import FairScheduler, SchedulerStats, Work
from .serve import gateway_serve_loop
from .state import GatewayState, Tenant, TenantStats

__all__ = [
    "Emitter", "LineSource",
    "FairScheduler", "SchedulerStats", "Work",
    "gateway_serve_loop",
    "GatewayState", "Tenant", "TenantStats",
]
