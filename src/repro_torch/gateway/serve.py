"""Gateway NDJSON loop: multi-tenant serving with overlapped drains
(the port's copy of the JAX package's ``repro.gateway.serve``, with its
wire verbs and payloads).

``launch/estimate.py --serve --gateway`` exposes one process that pools
MANY independent graphs/streams (tenants) and overlaps request intake,
response emit and engine drains — the multi-tenant big sibling of
``api.serve.serve_loop``.

Threads (see ``gateway.scheduler`` for why exactly these three):

* **intake** (the calling thread): parses lines, answers ``health`` /
  ``stats`` inline without draining anyone, enqueues everything else.
  A malformed line answers an error and touches no tenant state, so one
  broken client line never affects other tenants' handles.
* **dispatcher**: executes all tenant work serialized + round-robin
  fair; consecutive requests for one tenant fuse into one coalescing
  window (one engine plan).  Every CUDA call of every tenant (uploads,
  the weight DP, the windows) and the profiler's start and stop happen
  on this thread.
* **emitter**: writes responses; a stalled client blocks only this
  thread (``gateway.io.Emitter``).

Wire verbs (one JSON object per line; all tenant-touching lines carry
``"tenant": <name>``)::

    {"cmd": "open_tenant", "tenant": "fin", "graph": "fintxn:n=1000,..."}
    {"cmd": "open_tenant", "tenant": "soc", "stream": true,
     "horizon": 100000, "wal": true}
    {"tenant": "fin", "id": 1, "motif": "M5-3", "delta": 4000,
     "k": 65536, "witnesses": 5}
    {"cmd": "subscribe", "tenant": "soc", "motif": "M5-3",
     "delta": 4000, "k": 16384, "witnesses": 5}
    {"cmd": "ingest", "tenant": "soc", "edges": [[0, 1, 17], ...]}
    {"cmd": "advance", "tenant": "soc"}
    {"cmd": "close_tenant", "tenant": "fin"}
    {"cmd": "health"}   {"cmd": "stats"}   {"cmd": "quit"}
    {"cmd": "metrics"}  {"cmd": "trace"}   {"cmd": "profile", "windows": 2}

Telemetry (see ``repro_torch.obs``): every tenant-touching wire line is
an intake point — at the ``trace`` level it mints a trace id that rides
the :class:`~repro_torch.gateway.scheduler.Work`
item across the intake -> dispatcher -> emitter thread boundaries, so
one request's span chain (``gateway.intake`` -> ``queue_wait`` ->
``session.drain`` -> ``engine.dispatch`` -> ``gateway.emit``) shares one
id in the flight recorder.  Per-tenant end-to-end latency lands in the
``repro_tenant_request_seconds{tenant=...}`` /
``repro_tenant_advance_seconds{tenant=...}`` histograms (enqueue ->
response handoff).  ``metrics`` answers the full registry as Prometheus
text, ``trace`` exports the flight recorder, ``profile`` arms the
``torch.profiler`` seam around the next N engine windows (requires the
server to have been started with ``--profile-dir``) — all answered
inline, never waiting on a drain.

Backpressure: each tenant holds at most ``quota`` pending work items;
a submit past the quota answers ``{"ok": false, "error_kind":
"overloaded"}`` IMMEDIATELY (the resilience taxonomy) while every other
tenant keeps draining — load is shed loudly, never stalled silently.

Witness streaming: a request (or standing query) with ``witnesses > 0``
emits one ``{"progress": true, "window": w, ..., "witnesses": [...]}``
line per completed checkpoint window — the running top-n accepted
full-match edge tuples — before its final response line, which carries
the finished reservoir.

Determinism: the gateway decides only WHEN work executes.  Counts (and
witnesses) for any tenant interleaving are bit-identical to solo
synchronous ``estimate()`` runs at the same seed/budget, and equal to
the reference gateway's per ``(tenant, id)``.
"""
from __future__ import annotations

import json
import sys
from typing import IO

from .. import obs
from ..api.config import EstimateConfig
from ..resilience import OVERLOADED, OverloadedError, error_payload
from ..resilience.retry import STATS as RSTATS
from .io import Emitter, LineSource
from .scheduler import FairScheduler, Work
from .state import GatewayState, Tenant

#: engine.STATS counters summed per tenant (ints only — ratios are
#: recomputed, never delta'd)
_ENGINE_COUNTERS = ("dispatches", "fused_dispatches", "job_windows",
                    "tree_cohorts", "samples_shared", "witness_dispatches")

_OPEN_FIELDS = frozenset(("cmd", "tenant", "graph", "stream", "horizon",
                          "wal"))

#: per-tenant end-to-end latency: intake enqueue -> response handoff to
#: the emitter queue (the client-visible service time minus the final
#: write itself, which the ``emit`` stage histogram covers)
_TENANT_REQ = obs.REGISTRY.histogram(
    "repro_tenant_request_seconds",
    "gateway request latency per tenant (enqueue to response handoff)",
    labels=("tenant",))
_TENANT_ADV = obs.REGISTRY.histogram(
    "repro_tenant_advance_seconds",
    "gateway advance latency per tenant (enqueue to epoch responses)",
    labels=("tenant",))


def _engine_snapshot() -> dict:
    from ..core.engine import STATS as ESTATS
    return {k: int(getattr(ESTATS, k)) for k in _ENGINE_COUNTERS}


def _progress_line(rid, tenant: str, p) -> dict:
    """One per-checkpoint-window witness line (emitted before the final
    response, oldest window first)."""
    import math
    return dict(id=rid, tenant=tenant, progress=True, window=p.window,
                k_done=p.k_done, estimate=p.estimate,
                rse=None if math.isinf(p.rse) else p.rse,
                witnesses=[dict(edges=[list(e) for e in w["edges"]],
                                cnt=w["cnt"]) for w in (p.witnesses or ())])


class _Gateway:
    """The serving wires: owns state + scheduler + emitter + counters."""

    def __init__(self, config: EstimateConfig, out: IO, *,
                 max_tenants: int, quota: int, wal_dir: str | None, mesh):
        self.state = GatewayState(config, max_tenants=max_tenants,
                                  wal_dir=wal_dir, mesh=mesh)
        self.emitter = Emitter(out)
        self.sched = FairScheduler(self._execute, quota=quota)
        # the eviction policy asks the scheduler what is idle
        self.state.pending_of = self.sched.pending
        self.served = 0

    def emit(self, obj: dict) -> None:
        self.emitter.emit(obj)

    # -- dispatcher side (all tenant mutation happens here) --------------
    def _execute(self, unit) -> None:
        if obs.enabled():
            # how long each item sat queued behind other tenants' turns
            now = obs.monotonic()
            for w in (unit if isinstance(unit, list) else (unit,)):
                obs.observe_stage("queue_wait", now - w.t_enq,
                                  trace=w.trace)
        if isinstance(unit, list):
            self._do_requests(unit)
            return
        do = {"open_tenant": self._do_open, "close_tenant": self._do_close,
              "ingest": self._do_ingest, "advance": self._do_advance,
              "subscribe": self._do_subscribe,
              "unsubscribe": self._do_unsubscribe}[unit.kind]
        do(unit)

    def _do_requests(self, batch: list[Work]) -> None:
        """One fused coalescing window for one tenant's request burst."""
        from ..api.serve import _parse_request, _response
        from ..core.motif import get_motif

        tenant = self.state.tenants.get(batch[0].tenant)
        before = _engine_snapshot()
        jobs = []                       # (rid, Handle, Work) in arrival order
        session = tenant.cur_session() if tenant is not None else None
        for w in batch:
            rid = w.obj.get("id")
            try:
                if tenant is None:
                    raise ValueError(
                        f"tenant {batch[0].tenant!r} closed before its "
                        "queued request executed")
                req = _parse_request(
                    {k: v for k, v in w.obj.items() if k != "tenant"})
                if isinstance(req.motif, str):
                    get_motif(req.motif)   # fail THIS line, not the window
                if session is None:
                    raise RuntimeError(
                        "no epoch materialized yet — send ingest + advance "
                        "first")
                # submit inside the work item's trace context so the
                # Handle (and its engine jobs) inherit the wire trace
                with obs.trace_context(w.trace):
                    jobs.append((rid, session.submit(req), w))
            except Exception as e:       # noqa: BLE001 — per-line answer
                self._err(dict(id=rid, tenant=batch[0].tenant),
                          error_payload(e), tenant)
        if session is not None and jobs:
            try:
                session.flush()
            except Exception as e:       # noqa: BLE001 — handles carry it
                RSTATS.drain_failures += 1
                sys.stderr.write(f"gateway: drain failed for tenant "
                                 f"{tenant.name!r}: {error_payload(e)}\n")
        for rid, h, w in jobs:
            try:
                with obs.trace_context(w.trace):
                    if h.request.witnesses:
                        for p in h._progress:
                            self.emit(_progress_line(rid, tenant.name, p))
                    d = _response(rid, h)   # carries the final witnesses
                    d["tenant"] = tenant.name
                    if d.get("degraded"):
                        tenant.stats.degraded += 1
                    self.emit(d)
                if obs.enabled():
                    _TENANT_REQ.labels(tenant=tenant.name).observe(
                        obs.monotonic() - w.t_enq)
                tenant.stats.served += 1
                self.served += 1
            except Exception as e:       # noqa: BLE001 — server stays up
                self._err(dict(id=rid, tenant=tenant.name),
                          error_payload(e), tenant)
        if tenant is not None:
            after = _engine_snapshot()
            tenant.stats.add_engine_delta(
                {k: after[k] - before[k] for k in after})
            tenant.touch()

    def _do_open(self, w: Work) -> None:
        obj, name = w.obj, w.obj.get("tenant")
        try:
            unknown = set(obj) - _OPEN_FIELDS
            if unknown:
                raise ValueError(
                    f"unknown open_tenant field(s) {sorted(unknown)}; "
                    f"accepted: {sorted(_OPEN_FIELDS)}")
            tenant = self.state.open_tenant(
                str(name), graph=obj.get("graph"),
                stream=bool(obj.get("stream")),
                horizon=(None if obj.get("horizon") is None
                         else int(obj["horizon"])),
                wal=bool(obj.get("wal")))
            d = dict(ok=True, cmd="open_tenant", tenant=tenant.name,
                     mode=tenant.mode, pool_size=len(self.state.tenants))
            if tenant.mode == "stream":
                st = tenant.stream.store
                # a WAL-recovered tenant resumes mid-history: epoch > 0
                # or edges already buffered at open
                d.update(epoch=st.epoch, buffered=st.buffered,
                         recovered=st.buffered > 0 or st.epoch > 0)
            self.emit(d)
        except Exception as e:           # noqa: BLE001 — per-line answer
            self._err(dict(cmd="open_tenant", tenant=name),
                      error_payload(e))

    def _do_close(self, w: Work) -> None:
        name = w.obj.get("tenant")
        try:
            tenant = self.state.close_tenant(name)
            self.emit(dict(ok=True, cmd="close_tenant", tenant=name,
                           served=tenant.stats.served,
                           pool_size=len(self.state.tenants)))
        except Exception as e:           # noqa: BLE001
            self._err(dict(cmd="close_tenant", tenant=name),
                      error_payload(e))

    def _stream_of(self, w: Work):
        tenant = self.state.get(w.obj.get("tenant"))
        if tenant.mode != "stream":
            raise ValueError(f"tenant {tenant.name!r} is a graph tenant; "
                             f"cmd {w.kind!r} needs a stream tenant")
        tenant.touch()
        return tenant

    def _do_ingest(self, w: Work) -> None:
        from ..api.serve import _parse_ingest
        try:
            tenant = self._stream_of(w)
            src, dst, t = _parse_ingest(
                {k: v for k, v in w.obj.items() if k != "tenant"})
            n_in = tenant.stream.ingest(src, dst, t)
            self.emit(dict(ok=True, cmd="ingest", tenant=tenant.name,
                           ingested=n_in, dropped=len(src) - n_in,
                           buffered=tenant.stream.store.buffered))
        except Exception as e:           # noqa: BLE001
            self._err(dict(cmd="ingest", tenant=w.obj.get("tenant")),
                      error_payload(e))

    def _do_advance(self, w: Work) -> None:
        from ..api.serve import _sub_response
        name = w.obj.get("tenant")
        try:
            tenant = self._stream_of(w)
            before = _engine_snapshot()
            with obs.trace_context(w.trace):
                er = tenant.stream.advance()
                queries = tenant.stream.queries
                for qid in sorted(er.results):
                    res, q = er.results[qid], queries[qid]
                    # a standing query's witnesses stream per epoch — the
                    # reservoir rides its subscription line (_sub_response)
                    d = _sub_response(qid, q, er.epoch.index, res)
                    d["tenant"] = tenant.name
                    self.emit(d)
                    tenant.stats.served += 1
                    self.served += 1
                ep = er.epoch
                self.emit(dict(ok=True, cmd="advance", tenant=tenant.name,
                               epoch=ep.index, m=ep.m_real, n=ep.n_real,
                               t_lo=ep.t_lo, t_hi=ep.t_hi,
                               evicted=ep.evicted, buckets=list(ep.buckets),
                               queries=len(er.results),
                               advance_s=round(er.advance_s, 6)))
            if obs.enabled():
                _TENANT_ADV.labels(tenant=tenant.name).observe(
                    obs.monotonic() - w.t_enq)
            after = _engine_snapshot()
            tenant.stats.add_engine_delta(
                {k: after[k] - before[k] for k in after})
        except Exception as e:           # noqa: BLE001
            self._err(dict(cmd="advance", tenant=name), error_payload(e))

    def _do_subscribe(self, w: Work) -> None:
        from ..api.serve import _SUBSCRIBE_FIELDS, _parse_subscribe
        obj, name = w.obj, w.obj.get("tenant")
        try:
            tenant = self._stream_of(w)
            allowed = _SUBSCRIBE_FIELDS | {"tenant"}
            unknown = set(obj) - allowed
            if unknown:
                raise ValueError(
                    f"unknown subscribe field(s) {sorted(unknown)}; "
                    f"accepted: {sorted(allowed)}")
            q = _parse_subscribe(
                {k: v for k, v in obj.items() if k != "tenant"})
            self.emit(dict(ok=True, cmd="subscribe", tenant=tenant.name,
                           sub=tenant.stream.subscribe(q), name=q.label))
        except Exception as e:           # noqa: BLE001
            self._err(dict(cmd="subscribe", tenant=name),
                      error_payload(e))

    def _do_unsubscribe(self, w: Work) -> None:
        name = w.obj.get("tenant")
        try:
            tenant = self._stream_of(w)
            q = tenant.stream.unsubscribe(int(w.obj["sub"]))
            self.emit(dict(ok=True, cmd="unsubscribe", tenant=tenant.name,
                           sub=int(w.obj["sub"]), name=q.label))
        except Exception as e:           # noqa: BLE001
            self._err(dict(cmd="unsubscribe", tenant=name),
                      error_payload(e))

    # -- intake side (inline answers; never drains) ----------------------
    def _err(self, head: dict, payload: dict,
             tenant: Tenant | None = None) -> None:
        """Emit one structured failure line (``payload`` comes from
        ``error_payload`` at the catch site, keeping the taxonomy call
        visible where the exception is swallowed)."""
        if tenant is not None and payload.get("error_kind") != OVERLOADED:
            tenant.stats.errors += 1
        self.emit(dict(**head, ok=False, **payload))

    def health(self) -> dict:
        s = self.sched.stats
        return dict(
            ok=True, cmd="health", mode="gateway", served=self.served,
            tenants={n: t.describe(self.sched.pending(n))
                     for n, t in self.state.tenants.items()},
            scheduler=dict(turns=s.turns, batched=s.batched, shed=s.shed,
                           max_overlap=s.max_overlap,
                           exec_failures=s.exec_failures,
                           quota=self.sched.quota),
            evictions=self.state.evictions,
            resilience=RSTATS.as_dict(), engine=self._engine_block(),
            obs=obs.summary())

    def stats(self) -> dict:
        d = self.health()
        d["cmd"] = "stats"
        d["max_tenants"] = self.state.max_tenants
        return d

    def _engine_block(self) -> dict:
        from ..api.serve import _engine_stats
        return _engine_stats()


def gateway_serve_loop(config: EstimateConfig | None = None,
                       infile: IO = None, outfile: IO = None, *,
                       max_tenants: int = 8, quota: int = 16,
                       wal_dir: str | None = None, mesh=None,
                       profile_dir: str | None = None) -> int:
    """Run the gateway NDJSON loop until EOF or ``quit``.

    Returns the number of estimation responses served (standing-query
    epoch responses included).  ``config`` applies to every tenant
    opened; ``quota`` is the per-tenant pending-work cap (the
    backpressure quota); ``wal_dir`` enables ``"wal": true`` stream
    tenants (WAL file paths derive from it server-side — never from the
    wire); ``mesh`` (a data mesh of the config's device type) shards
    every tenant's windows; ``profile_dir`` enables the ``profile`` verb
    (profiler output paths are server-side only, like WAL paths).
    """
    from ..api.serve import _metrics, _profile, _trace_export
    cfg = (config or EstimateConfig()).resolve()
    src = LineSource(sys.stdin if infile is None else infile)
    gw = _Gateway(cfg, sys.stdout if outfile is None else outfile,
                  max_tenants=max_tenants, quota=quota, wal_dir=wal_dir,
                  mesh=mesh)
    try:
        while True:
            line = src.readline(None)
            if line == "":                       # EOF: drain-all, exit
                gw.sched.barrier()
                break
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
                if not isinstance(obj, dict):
                    raise ValueError("request line must be a JSON object")
            except ValueError as e:
                # malformed line: answered here, no tenant touched
                gw.emit(dict(ok=False, error=f"bad json: {e}"))
                continue
            cmd = obj.get("cmd")
            if cmd == "quit":
                gw.sched.barrier()               # every queued item answers
                gw.emit(dict(ok=True, cmd="quit", served=gw.served))
                break
            elif cmd in ("health", "stats"):
                # inline: a probe never waits on — or forces — a drain
                gw.emit(gw.health() if cmd == "health" else gw.stats())
            elif cmd == "metrics":
                gw.emit(_metrics())
            elif cmd == "trace":
                gw.emit(_trace_export())
            elif cmd == "profile":
                gw.emit(_profile(obj, profile_dir))
            elif cmd == "open_tenant":
                tid = obs.new_trace() if obs.enabled(obs.TRACE) else None
                with obs.trace_context(tid), \
                        obs.span("gateway.intake", stage="intake",
                                 tenant=obj.get("tenant"), cmd=cmd):
                    gw.sched.submit_control(Work("open_tenant", obj))
            elif cmd in ("close_tenant", "ingest", "advance", "subscribe",
                         "unsubscribe") or cmd is None:
                kind = cmd or "request"
                name = obj.get("tenant")
                head = dict(cmd=cmd) if cmd else dict(id=obj.get("id"))
                head["tenant"] = name
                if not isinstance(name, str):
                    gw._err(head, error_payload(ValueError(
                        'tenant-touching lines need "tenant": "<name>"')))
                    continue
                # every tenant-touching line is an intake point: mint a
                # trace id here so the Work item carries it across the
                # dispatcher/emitter thread boundaries
                tid = obs.new_trace() if obs.enabled(obs.TRACE) else None
                with obs.trace_context(tid), \
                        obs.span("gateway.intake", stage="intake",
                                 tenant=name, id=obj.get("id")):
                    try:
                        # by NAME, unresolved: the open_tenant this may be
                        # racing sits in the control queue, which the
                        # dispatcher always serves first
                        gw.sched.submit(name, Work(kind, obj, tenant=name))
                    except OverloadedError as e:
                        # quota shed: answered inline, dispatcher untouched
                        t = gw.state.tenants.get(name)
                        if t is not None:
                            t.stats.overloaded += 1
                        gw._err(head, error_payload(e))
            else:
                gw.emit(dict(ok=False, error=f"unknown cmd {cmd!r}"))
    finally:
        gw.sched.stop()
        gw.state.close_all()
        gw.emitter.close()
    return gw.served
