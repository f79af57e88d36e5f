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
true`` with ``degraded: true``), ``witnesses`` (refused with ``error_kind
bad_request`` until the port's witnesses slice).  Unknown fields are
rejected (``checkpoint_path`` stays CLI/library-only: a request line
must not name server-side files to overwrite).

Control lines: ``{"cmd": "stats"}`` (session counters plus the
``engine`` block of process-wide tree-cohort counters), ``{"cmd":
"health"}`` (answered at once, without draining: mode, pending/served
counts and the same ``engine`` block), ``{"cmd": "quit"}`` (drain +
exit; EOF does the same).  The streaming verbs (``ingest``,
``advance``, ``subscribe``, ``unsubscribe``) answer the reference's
"needs stream mode" error: the port has no stream mode yet.  The
telemetry verbs ``metrics``, ``trace`` and ``profile`` answer ``unknown
cmd`` until the port's obs slice; ``health`` and ``stats`` carry no
``obs`` or ``resilience`` block until then.

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
"""
from __future__ import annotations

import json
import math
import sys
from typing import IO

from ..gateway.io import LineSource
from ..resilience import classify, error_payload
from .session import Handle, Request, Session


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


def _stats(session: Session) -> dict:
    s = session.stats
    return dict(ok=True, cmd="stats", submitted=s.submitted,
                completed=s.completed, drains=s.drains,
                dispatches=s.dispatches, adaptive_rounds=s.adaptive_rounds,
                preprocess_calls=session.planner.preprocess_calls,
                preprocess_hits=session.planner.preprocess_hits,
                engine=_engine_stats())


def _health(n_pending: int, served: int) -> dict:
    """The ``health`` verb's payload, answered without draining."""
    return dict(ok=True, cmd="health", mode="plain", pending=n_pending,
                served=served, engine=_engine_stats())


def serve_loop(session: Session, infile: IO = None,
               outfile: IO = None) -> int:
    """Run the NDJSON request/response loop until EOF or ``quit``.

    Returns the number of estimation requests answered.
    """
    cfg = session.config
    src = LineSource(sys.stdin if infile is None else infile)
    out = sys.stdout if outfile is None else outfile
    pending: list[tuple] = []          # (id, Handle)
    served = 0

    def emit(obj: dict) -> None:
        try:
            out.write(json.dumps(obj) + "\n")
            out.flush()
        except Exception as e:
            # a client that hung up mid-response must not kill the server
            sys.stderr.write(f"serve: response write failed "
                             f"({classify(e)}): {e}\n")

    def drain() -> None:
        nonlocal served
        try:
            session.flush()
        except Exception as e:   # the server stays up; each failed
            # handle answers ok:false below with the classified kind
            sys.stderr.write(f"serve: window drain failed "
                             f"({classify(e)}): {e}\n")
        for rid, h in pending:
            try:
                emit(_response(rid, h))
            except Exception as e:   # noqa: BLE001 — server stays up
                emit(dict(id=rid, ok=False, **error_payload(e)))
            served += 1
        pending.clear()

    quit_seen = False
    while not quit_seen:
        # block for the window's first request; afterwards poll with the
        # window's remaining lifetime so a quiet client closes it
        age = session.window_age()
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
            emit(_stats(session))
        elif cmd == "health":
            emit(_health(len(pending), served))
        elif cmd in _STREAM_VERBS:
            emit(dict(ok=False, error=f"cmd {cmd!r} needs stream mode "
                                      "(--serve --stream)"))
        elif cmd is not None:
            emit(dict(ok=False, error=f"unknown cmd {cmd!r}"))
        else:
            rid = obj.get("id")
            try:
                req = _parse_request(obj)
                # validate the motif before it reaches the drain, so the
                # error answers THIS line instead of poisoning the window
                if isinstance(req.motif, str):
                    from ..core.motif import get_motif
                    get_motif(req.motif)
                pending.append((rid, session.submit(req)))
                if session.window_age() is None:    # count-closed mid-add
                    drain()
            except Exception as e:       # noqa: BLE001
                emit(dict(id=rid, ok=False, **error_payload(e)))
    if pending:
        drain()
    return served
