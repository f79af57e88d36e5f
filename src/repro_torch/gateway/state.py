"""Multi-graph tenancy: many independent graphs/streams in one process
(the port's copy of the JAX package's ``repro.gateway.state``).

A :class:`Tenant` is one resident workload — either a frozen graph
behind an ``api.Session`` ("graph" mode) or a live edge stream behind a
``stream.StreamingSession`` ("stream" mode) — plus its serving
counters.  :class:`GatewayState` pools them under the wire names
``open_tenant``/``close_tenant`` route on.  Every tenant runs on the
gateway config's ``device``; its graph and Weights live there until the
tenant closes.  A gateway ``mesh`` is shared by every tenant's session.

Eviction: ``open_tenant`` past ``max_tenants`` evicts the
least-recently-active IDLE tenant (no queued or in-flight work).  A
stream tenant opened with ``wal=True`` survives eviction durably: its
WAL lives at a path derived from the gateway's ``wal_dir`` and the
(validated) tenant name, and reopening recovers the store from it
bit-identically.  Wire requests never name WAL paths: an untrusted
request line must not control server-side files.

Graph tenants accept SYNTHETIC generator specs only
(``powerlaw:...``/``er:...``/``fintxn:...``): a wire line must not
reach into the server's filesystem for edge lists either.
"""
from __future__ import annotations

import os
import re
from collections import OrderedDict
from dataclasses import dataclass, field

from .. import obs
from ..api.config import EstimateConfig
from ..api.session import Session
from ..core.engine import shard_devices
from ..resilience import BadRequestError, OverloadedError

#: wire tenant names: path-safe, no traversal, bounded length
_NAME_RE = re.compile(r"[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")


@dataclass
class TenantStats:
    """Per-tenant serving counters (the ``stats``/``health`` block)."""

    served: int = 0            # responses answered (errors included)
    degraded: int = 0          # deadline/ladder partials answered
    overloaded: int = 0        # requests shed at admission (quota full)
    errors: int = 0            # ok:false responses (overloads excluded)
    # summed engine.STATS deltas for work executed on behalf of this
    # tenant — exact, because the dispatcher serializes all execution
    engine: dict = field(default_factory=dict)

    def add_engine_delta(self, delta: dict) -> None:
        for k, v in delta.items():
            self.engine[k] = self.engine.get(k, 0) + v


class Tenant:
    """One pooled workload: session or stream + serving counters.

    The work queue lives in the scheduler (keyed by NAME, so intake can
    enqueue for a tenant whose ``open_tenant`` is still in flight);
    this object is the dispatch-time resolution target.
    """

    def __init__(self, name: str, mode: str, *, session: Session = None,
                 stream=None, wal_path: str = None):
        self.name = name
        self.mode = mode                   # "graph" | "stream"
        self.session = session
        self.stream = stream
        self.wal_path = wal_path
        self.stats = TenantStats()
        self.opened_t = obs.monotonic()
        self.last_active = self.opened_t

    def cur_session(self) -> Session | None:
        """The tenant's CURRENT estimation session (epoch-swapped in
        stream mode; None before a stream's first advance)."""
        return self.session if self.mode == "graph" else self.stream.session

    def touch(self) -> None:
        self.last_active = obs.monotonic()

    def close(self) -> None:
        if self.mode == "graph":
            self.session.close()
        else:
            self.stream.close()

    def describe(self, pending: int = 0) -> dict:
        """The per-tenant ``stats``/``health`` block.  Read-only over
        counters (no drain; ``pending`` comes from the scheduler):
        probes must never wait on — or force — estimation work, so
        concurrent readers see the instant they asked, exactly like the
        single-tenant ``health`` verb."""
        d = dict(mode=self.mode, pending=pending,
                 served=self.stats.served, degraded=self.stats.degraded,
                 overloaded=self.stats.overloaded, errors=self.stats.errors,
                 engine=dict(self.stats.engine))
        if self.mode == "stream":
            st = self.stream.store
            d.update(epoch=st.epoch, buffered=st.buffered,
                     subscriptions=len(self.stream.queries))
            wal = st.wal
            if wal is not None:
                d.update(wal=dict(path=wal.path, records=wal.records,
                                  offset=wal.offset))
        return d


class GatewayState:
    """The tenant pool + LRU eviction policy.

    All mutation (open/close/evict) happens on the dispatcher thread —
    the scheduler routes ``open_tenant``/``close_tenant`` work items
    there — so tenant lifecycle never races estimation work.  Intake
    threads only *read* (name lookup for routing, counter snapshots for
    ``health``/``stats``), which the GIL keeps coherent.
    """

    def __init__(self, config: EstimateConfig = None, *,
                 max_tenants: int = 8, wal_dir: str = None, mesh=None):
        self.config = (config or EstimateConfig()).resolve()
        shard_devices(mesh, self.config.device)    # checked once, here
        # every tenant's session (a stream's every epoch) shards over it
        self.mesh = mesh
        self.max_tenants = max(1, int(max_tenants))
        self.wal_dir = wal_dir
        self.tenants: OrderedDict[str, Tenant] = OrderedDict()
        self.evictions = 0
        # pending-work probe, wired to FairScheduler.pending by the
        # serve loop (a tenant with queued/in-flight work is not idle
        # and must never be evicted); standalone GatewayState use — the
        # in-process scripting path — has no queues, so everything idles
        self.pending_of = lambda name: 0

    # -- lookups (intake-safe) -------------------------------------------
    def get(self, name) -> Tenant:
        tenant = self.tenants.get(name)
        if tenant is None:
            raise BadRequestError(
                f"unknown tenant {name!r}: open_tenant it first "
                f"(open: {sorted(self.tenants)})")
        return tenant

    # -- lifecycle (dispatcher-only) -------------------------------------
    def open_tenant(self, name: str, *, graph: str = None,
                    stream: bool = False, horizon: int = None,
                    wal: bool = False) -> Tenant:
        """Build and pool a tenant; evicts an idle one at capacity.

        ``graph`` is a synthetic generator spec (``kind:k=v,...`` —
        file paths are rejected: wire lines must not read server files).
        ``stream=True`` opens a live-stream tenant instead; ``wal=True``
        attaches a crash-safe WAL at a server-derived path (requires the
        gateway to have been started with a ``wal_dir``) and RECOVERS
        from it when one exists — a re-opened tenant resumes its stream
        bit-identically.
        """
        if not isinstance(name, str) or not _NAME_RE.match(name):
            raise BadRequestError(
                f"bad tenant name {name!r}: want [A-Za-z0-9][A-Za-z0-9._-]*"
                " (<= 64 chars)")
        if name in self.tenants:
            raise BadRequestError(f"tenant {name!r} is already open")
        if (graph is None) == (not stream):
            raise BadRequestError(
                'open_tenant needs exactly one of "graph": "<spec>" or '
                '"stream": true')
        if len(self.tenants) >= self.max_tenants:
            self._evict_one()
        if stream:
            # imported here: repro_torch.stream imports the api package,
            # whose serve loop imports this package
            from ..stream import StreamingSession, StreamStore
            wal_path = None
            if wal:
                if self.wal_dir is None:
                    raise BadRequestError(
                        '"wal": true needs the gateway started with '
                        "--wal-dir (WAL paths are server-side only)")
                os.makedirs(self.wal_dir, exist_ok=True)
                wal_path = os.path.join(self.wal_dir, f"{name}.wal")
                store = StreamStore.recover(wal_path, horizon=horizon)
            else:
                store = StreamStore(horizon=horizon)
            tenant = Tenant(name, "stream", wal_path=wal_path,
                            stream=StreamingSession(store=store,
                                                    config=self.config,
                                                    mesh=self.mesh))
        else:
            if ":" not in str(graph):
                raise BadRequestError(
                    f"graph spec {graph!r}: only synthetic generator "
                    "specs (kind:k=v,...) are accepted on the wire — "
                    "server-side files stay CLI-only")
            from ..launch.estimate import parse_graph
            try:
                g = parse_graph(str(graph))
            except SystemExit as e:
                # the CLI's exit for an unknown kind (the reference's
                # parse_graph raises a KeyError): answered bad_request,
                # never a dead dispatcher thread
                raise BadRequestError(str(e)) from None
            tenant = Tenant(name, "graph",
                            session=Session(g, self.config, mesh=self.mesh))
        self.tenants[name] = tenant
        return tenant

    def close_tenant(self, name: str) -> Tenant:
        tenant = self.get(name)
        del self.tenants[name]
        tenant.close()
        return tenant

    def _evict_one(self) -> None:
        """Drop the least-recently-active IDLE tenant; refuse (shed the
        open) when every pooled tenant still has work in flight."""
        victim = None
        for tenant in self.tenants.values():
            if self.pending_of(tenant.name) == 0 and (
                    victim is None
                    or tenant.last_active < victim.last_active):
                victim = tenant
        if victim is None:
            raise OverloadedError(
                f"tenant pool full ({len(self.tenants)}/{self.max_tenants})"
                " and no tenant is idle — retry after pending work drains")
        del self.tenants[victim.name]
        victim.close()
        self.evictions += 1

    def close_all(self) -> None:
        for name in list(self.tenants):
            self.close_tenant(name)
