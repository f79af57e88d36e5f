"""Line-delimited-JSON serving loop over a :class:`Session`.

Torch counterpart of ``repro.api.serve`` with the same wire format:
one JSON object per line on stdin, one JSON response per line on stdout
(stderr carries logs).  ``launch/estimate.py --serve`` runs it.

Request lines::

    {"id": 1, "motif": "M5-3", "delta": 4000, "k": 65536}
    {"id": 2, "motif": "0-1,1-2,2-0", "delta": 4000, "k": 65536,
     "seed": 7}
    {"id": 3, "motif": "M4-2", "delta": 2000, "k": 4096,
     "target_rse": 0.1, "k_max": 1048576}

Optional fields: ``id`` (echoed back), ``seed``, ``target_rse``/``k_max``
(adaptive budgets), ``deadline_ms`` (an expired request answers ``ok:
true`` with ``degraded: true``), ``witnesses`` (up to that many accepted
full-match edge tuples, answered as ``"witnesses": [{"edges": [[src,
dst, t], ...], "cnt": ...}, ...]``).  Unknown fields are rejected
(``checkpoint_path`` stays CLI/library-only: a request line must not
name server-side files to overwrite).

Control lines: ``{"cmd": "stats"}`` (session counters plus the
``engine`` block of process-wide tree-cohort counters and the ``obs``
block), ``{"cmd": "health"}`` (answered at once, without draining: mode,
pending/served counts, the process-wide ``resilience`` counters, the
same ``engine`` and ``obs`` blocks, and in stream mode the current epoch
and the WAL position), ``{"cmd": "quit"}`` (drain + exit; EOF does the
same).

Telemetry verbs (``repro_torch.obs``): ``{"cmd": "metrics"}`` answers
the registry as Prometheus text in the ``text`` field; ``{"cmd":
"trace"}`` exports the flight recorder (host-side spans, recorded at
the ``trace`` level) as a ``spans`` list; ``{"cmd": "profile",
"windows": n}`` arms a one-shot ``torch.profiler`` capture around the
next n engine windows (the server started with ``--profile-dir``: the
wire names no server path).  Each request line mints a trace id at
intake (``serve.intake``); the session drain, engine dispatches and the
response emit (``serve.emit``) record spans under it.

Streaming verbs (``--serve --stream``; ``serve_loop(None,
stream=...)``), the reference's::

    {"cmd": "subscribe", "motif": "M5-3", "delta": 4000, "k": 16384}
    {"cmd": "ingest", "edges": [[0, 1, 17], [1, 2, 403], ...]}
    {"cmd": "advance"}
    {"cmd": "unsubscribe", "sub": 0}

``advance`` answers one line per subscription (``{"sub": N, "epoch": e,
"ok": true, "estimate": ...}``, in subscription order) and then an
epoch summary line; each standing estimate equals a cold ``estimate()``
on that epoch's snapshot.  One-shot request lines are served against
the current epoch (an error until the first ``advance``).  In plain
mode the stream verbs answer "needs stream mode".

Responses (one line each, in request order within a window)::

    {"id": 1, "ok": true, "estimate": 4636.58, "W": 412857, "k": 65536,
     "valid": 27210, "rse": 0.18, "motif": "M5-3", "delta": 4000,
     "sampler_backend": "cuda", "fallback_reason": "", "fused_jobs": 2,
     "windows": 8}

Malformed or failing requests answer ``{"id": ..., "ok": false,
"error": "...", "error_kind": "retryable" | "fatal" | "bad_request"}``
(``resilience.errors``) and never kill the server.

Coalescing: the loop blocks for the first request, then keeps reading
until the session's coalescing window closes, drains, and emits the
whole window's responses; concurrent requests sharing a plan key fuse
into one tree cohort.

The mesh is the handed session's (``Session(..., mesh=...)``; in stream
mode the ``StreamingSession``'s): every drain shards over it and the
answers are the meshless ones.
"""
from __future__ import annotations

import json
import math
import sys
from typing import IO

import numpy as np

from .. import obs
from ..gateway.io import LineSource
from ..resilience import STATS as RSTATS
from ..resilience import classify, error_payload, fire
from .session import Handle, Request, Session


def _wire_witnesses(res) -> list:
    return [dict(edges=[list(e) for e in w["edges"]], cnt=w["cnt"])
            for w in res.witnesses]


def _response(rid, handle: Handle) -> dict:
    res = handle.result()
    rse = handle.rse
    d = dict(
        id=rid, ok=True, estimate=res.estimate, W=res.W, k=res.k,
        valid=res.valid, rse=None if math.isinf(rse) else rse,
        motif=res.motif, delta=res.delta,
        sampler_backend=res.sampler_backend,
        fallback_reason=res.fallback_reason, fused_jobs=res.fused_jobs,
        windows=handle.windows)
    if res.degraded:
        d.update(degraded=True, degrade_reason=res.degrade_reason,
                 k_done=res.k)
    if res.witnesses is not None:
        d.update(witnesses=_wire_witnesses(res))
    return d


_REQUEST_FIELDS = frozenset(
    ("id", "motif", "delta", "k", "seed", "target_rse", "k_max",
     "deadline_ms", "witnesses"))

_STREAM_VERBS = ("ingest", "advance", "subscribe", "unsubscribe")


def _parse_request(obj: dict) -> Request:
    for k in ("motif", "delta", "k"):
        if k not in obj:
            raise ValueError(f"request missing required field {k!r}")
    unknown = set(obj) - _REQUEST_FIELDS
    if unknown:
        raise ValueError(f"unknown request field(s) {sorted(unknown)}; "
                         f"accepted: {sorted(_REQUEST_FIELDS)}")
    return Request(
        motif=str(obj["motif"]), delta=int(obj["delta"]), k=int(obj["k"]),
        seed=None if obj.get("seed") is None else int(obj["seed"]),
        target_rse=(None if obj.get("target_rse") is None
                    else float(obj["target_rse"])),
        k_max=None if obj.get("k_max") is None else int(obj["k_max"]),
        deadline_s=(None if obj.get("deadline_ms") is None
                    else float(obj["deadline_ms"]) / 1000.0),
        witnesses=int(obj.get("witnesses") or 0))


def _engine_stats() -> dict:
    """Process-wide ``engine.STATS`` as a wire dict (tree-cohort fan-out)."""
    from ..core.engine import STATS as ESTATS
    return dict(dispatches=ESTATS.dispatches,
                fused_dispatches=ESTATS.fused_dispatches,
                job_windows=ESTATS.job_windows,
                tree_cohorts=ESTATS.tree_cohorts,
                motifs_per_cohort=round(ESTATS.motifs_per_cohort, 3),
                samples_shared=ESTATS.samples_shared,
                witness_dispatches=ESTATS.witness_dispatches)


def _metrics() -> dict:
    """The ``metrics`` verb: the registry as Prometheus text exposition
    (one NDJSON response; scrapers unwrap the ``text`` field)."""
    return dict(ok=True, cmd="metrics",
                content_type="text/plain; version=0.0.4",
                text=obs.REGISTRY.prometheus_text())


def _trace_export() -> dict:
    """The ``trace`` verb: the flight recorder's span ring, oldest first
    (each entry is one NDJSON record of the ``--trace-out`` export)."""
    recs = obs.RECORDER.records()
    return dict(ok=True, cmd="trace", level=obs.level_name(),
                count=len(recs), recorded=obs.RECORDER.recorded,
                ring=obs.RECORDER.capacity, spans=recs)


def _profile(obj: dict, profile_dir: str | None) -> dict:
    """The ``profile`` verb: arm a ``torch.profiler`` capture around the
    next N engine windows.  The capture directory comes from the
    server's ``--profile-dir``: the wire never names server paths."""
    if profile_dir is None:
        return dict(ok=False, cmd="profile",
                    error="server started without --profile-dir")
    try:
        st = obs.arm_profile(int(obj.get("windows") or 1), profile_dir)
    except (ValueError, RuntimeError, TypeError) as e:
        return dict(ok=False, cmd="profile", error=str(e))
    return dict(ok=True, cmd="profile", **st)


def _stats(session: Session | None, stream=None) -> dict:
    d = dict(ok=True, cmd="stats")
    if session is not None:
        s = session.stats
        d.update(submitted=s.submitted, completed=s.completed,
                 drains=s.drains, dispatches=s.dispatches,
                 adaptive_rounds=s.adaptive_rounds,
                 preprocess_calls=session.planner.preprocess_calls,
                 preprocess_hits=session.planner.preprocess_hits)
    if stream is not None:
        st, ss = stream.store.stats, stream.stats
        d.update(epochs=ss.epochs, subscriptions=len(stream.queries),
                 queries_run=ss.queries_run, ingested=st.ingested,
                 buffered=stream.store.buffered, evicted=st.evicted,
                 dropped=st.dropped, compactions=st.compactions)
    d.update(engine=_engine_stats(), obs=obs.summary())
    return d


def _health(stream, n_pending: int, served: int) -> dict:
    """The ``health`` verb's payload, answered without draining."""
    d = dict(ok=True, cmd="health",
             mode="plain" if stream is None else "stream",
             pending=n_pending, served=served,
             resilience=RSTATS.as_dict(),
             engine=_engine_stats(), obs=obs.summary())
    if stream is not None:
        st = stream.store
        d.update(epoch=st.epoch, buffered=st.buffered)
        wal = st.wal
        if wal is not None:
            d.update(wal=dict(path=wal.path, records=wal.records,
                              offset=wal.offset))
    return d


_SUBSCRIBE_FIELDS = frozenset(
    ("cmd", "motif", "delta", "k", "seed", "target_rse", "k_max", "name",
     "witnesses"))


def _parse_ingest(obj: dict):
    edges = obj.get("edges")
    if not isinstance(edges, list) or not edges:
        raise ValueError('ingest needs "edges": [[src, dst, t], ...]')
    a = np.asarray(edges, dtype=np.int64)
    if a.ndim != 2 or a.shape[1] != 3:
        raise ValueError(f"edges must be [N, 3] int triples, got "
                         f"shape {a.shape}")
    return a[:, 0], a[:, 1], a[:, 2]


def _parse_subscribe(obj: dict):
    unknown = set(obj) - _SUBSCRIBE_FIELDS
    if unknown:
        raise ValueError(f"unknown subscribe field(s) {sorted(unknown)}; "
                         f"accepted: {sorted(_SUBSCRIBE_FIELDS)}")
    from ..stream import StandingQuery
    return StandingQuery(
        motif=str(obj["motif"]), delta=int(obj["delta"]), k=int(obj["k"]),
        seed=int(obj.get("seed") or 0),
        target_rse=(None if obj.get("target_rse") is None
                    else float(obj["target_rse"])),
        k_max=None if obj.get("k_max") is None else int(obj["k_max"]),
        name=None if obj.get("name") is None else str(obj["name"]),
        witnesses=int(obj.get("witnesses") or 0))


def _sub_response(qid: int, query, epoch_idx: int, res) -> dict:
    rse = res.rse
    d = dict(sub=qid, epoch=epoch_idx, ok=True, name=query.label,
             estimate=res.estimate, W=res.W, k=res.k, valid=res.valid,
             rse=None if rse is None or math.isinf(rse) else rse,
             motif=res.motif, delta=res.delta,
             sampler_backend=res.sampler_backend,
             fused_jobs=res.fused_jobs)
    if res.witnesses is not None:
        d.update(witnesses=_wire_witnesses(res))
    return d


def serve_loop(session: Session | None, infile: IO = None,
               outfile: IO = None, stream=None,
               profile_dir: str | None = None) -> int:
    """Run the NDJSON request/response loop until EOF or ``quit``.

    ``stream`` (a ``repro_torch.stream.StreamingSession``) enables the
    streaming verbs; the resident session is then the stream's current
    epoch's (swapped on every ``advance``) and ``session`` must be None.
    ``profile_dir`` enables the ``profile`` verb (the capture directory,
    CLI ``--profile-dir``).  Returns the number of estimation requests
    answered (standing-query epoch responses included).
    """
    if (session is None) == (stream is None):
        raise ValueError("serve_loop needs exactly one of session/stream")
    cfg = session.config if stream is None else stream.config
    src = LineSource(sys.stdin if infile is None else infile)
    out = sys.stdout if outfile is None else outfile
    pending: list[tuple] = []          # (id, Handle)
    served = 0

    def cur_session() -> Session | None:
        return session if stream is None else stream.session

    def emit(obj: dict) -> None:
        try:
            fire("serve.write")
            with obs.span("serve.emit", stage="emit"):
                out.write(json.dumps(obj) + "\n")
                out.flush()
        except Exception as e:
            # a client that hung up mid-response must not kill the server
            RSTATS.emit_failures += 1
            sys.stderr.write(f"serve: response write failed "
                             f"({classify(e)}): {e}\n")

    def drain() -> None:
        nonlocal served
        s = cur_session()
        try:
            if s is not None:
                s.flush()
        except Exception as e:   # the server stays up; each failed
            # handle answers ok:false below with the classified kind
            RSTATS.drain_failures += 1
            sys.stderr.write(f"serve: window drain failed "
                             f"({classify(e)}): {e}\n")
        for rid, h in pending:
            # the response emit belongs to the request's trace
            with obs.trace_context(h._trace):
                try:
                    emit(_response(rid, h))
                except Exception as e:   # noqa: BLE001 — server stays up
                    emit(dict(id=rid, ok=False, **error_payload(e)))
            served += 1
        pending.clear()

    def do_advance() -> None:
        # drain first: pending handles belong to the OLD epoch's session
        nonlocal served
        drain()
        try:
            er = stream.advance()
        except Exception as e:           # noqa: BLE001 — e.g. empty stream
            emit(dict(ok=False, cmd="advance", **error_payload(e)))
            return
        for qid in sorted(er.results):
            emit(_sub_response(qid, stream.queries[qid], er.epoch.index,
                               er.results[qid]))
            served += 1
        ep = er.epoch
        emit(dict(ok=True, cmd="advance", epoch=ep.index, m=ep.m_real,
                  n=ep.n_real, t_lo=ep.t_lo, t_hi=ep.t_hi,
                  evicted=ep.evicted, buckets=list(ep.buckets),
                  queries=len(er.results),
                  advance_s=round(er.advance_s, 6)))

    def do_stream_verb(cmd: str, obj: dict) -> None:
        try:
            if cmd == "ingest":
                esrc, edst, et = _parse_ingest(obj)
                n_in = stream.ingest(esrc, edst, et)
                emit(dict(ok=True, cmd="ingest", ingested=n_in,
                          dropped=len(esrc) - n_in,
                          buffered=stream.store.buffered))
            elif cmd == "subscribe":
                q = _parse_subscribe(obj)
                emit(dict(ok=True, cmd="subscribe",
                          sub=stream.subscribe(q), name=q.label))
            else:
                q = stream.unsubscribe(int(obj["sub"]))
                emit(dict(ok=True, cmd="unsubscribe", sub=int(obj["sub"]),
                          name=q.label))
        except Exception as e:           # noqa: BLE001 — server stays up
            emit(dict(ok=False, cmd=cmd, **error_payload(e)))

    quit_seen = False
    while not quit_seen:
        # block for the window's first request; afterwards poll with the
        # window's remaining lifetime so a quiet client closes it
        s = cur_session()
        age = s.window_age() if s is not None else None
        if pending and age is None:     # session auto-drained (count-closed)
            drain()
            continue
        timeout = (None if not pending
                   else max(0.0, cfg.coalesce_window_s - age))
        line = src.readline(timeout)
        if line is None or (line == "" and pending):   # window expired/EOF
            drain()
            if line == "":
                break
            continue
        if line == "":                  # EOF with nothing pending
            break
        line = line.strip()
        if not line:                    # blank line: skip, keep serving
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError as e:
            emit(dict(ok=False, error=f"bad json: {e}"))
            continue
        cmd = obj.get("cmd")
        if cmd == "quit":
            drain()
            emit(dict(ok=True, cmd="quit", served=served))
            quit_seen = True
        elif cmd == "stats":
            drain()                     # deterministic ordering
            emit(_stats(cur_session(), stream))
        elif cmd == "health":
            emit(_health(stream, len(pending), served))
        elif cmd == "metrics":
            emit(_metrics())
        elif cmd == "trace":
            emit(_trace_export())
        elif cmd == "profile":
            emit(_profile(obj, profile_dir))
        elif cmd in _STREAM_VERBS and stream is None:
            emit(dict(ok=False, error=f"cmd {cmd!r} needs stream mode "
                                      "(--serve --stream)"))
        elif cmd == "advance":
            do_advance()
        elif cmd in _STREAM_VERBS:
            do_stream_verb(cmd, obj)
        elif cmd is not None:
            emit(dict(ok=False, error=f"unknown cmd {cmd!r}"))
        else:
            rid = obj.get("id")
            # one trace id per request wire line, minted at intake; the
            # handle inherits it (ambient context) and every downstream
            # span (drain, dispatch, emit) reports it
            tid = obs.new_trace() if obs.enabled(obs.TRACE) else None
            try:
                with obs.trace_context(tid), \
                        obs.span("serve.intake", stage="intake", id=rid):
                    req = _parse_request(obj)
                    # validate the motif before it reaches the drain, so
                    # the error answers THIS line instead of poisoning
                    # the window
                    if isinstance(req.motif, str):
                        from ..core.motif import get_motif
                        get_motif(req.motif)
                    s = cur_session()
                    if s is None:
                        raise RuntimeError("no epoch materialized yet — "
                                           "send ingest + advance first")
                    pending.append((rid, s.submit(req)))
                if s.window_age() is None:          # count-closed mid-add
                    drain()
            except Exception as e:       # noqa: BLE001
                emit(dict(id=rid, ok=False, **error_payload(e)))
    if pending:
        drain()
    return served
