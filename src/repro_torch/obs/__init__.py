"""Process-wide observability of the port: tracing, metrics, the flight
recorder and profiling (the port's copy of the JAX package's
``repro.obs``, whose docstring is the layer's design guide).

Three facilities, gated by one level (:func:`set_level`: ``off`` |
``metrics`` | ``trace``; the CLI's ``--obs``, default ``off``):

**Tracing** (``trace``) — :func:`span` opens a host-side span; a trace
id is minted at intake (a wire line, ``Session.submit``,
``StreamingSession.advance``) and propagated intake → scheduler ``Work``
→ session drain → engine cohort dispatch → emitter, explicitly across
threads and ambiently within one.  Closed spans land in the bounded
flight recorder (:data:`RECORDER`, :func:`set_ring`; the CLI's
``--obs-ring``, default 4096), exported as NDJSON by the ``{"cmd":
"trace"}`` verb or ``--trace-out PATH``.  One gateway request yields
the chain ``gateway.intake`` → ``stage.queue_wait`` → ``session.drain``
→ ``engine.dispatch`` (×W, each with its ``engine.device``) →
``gateway.emit`` under one id.  Every record at ``trace`` also carries
``ts_ns``, its start on the profiler's clock (Unix-epoch ns, the clock
``torch.profiler`` stamps its events with; :mod:`.clock` anchors
``perf_counter`` to it when the level becomes ``trace`` and when a
profile capture starts), so spans and a profiler trace line up without
a guessed offset; durations stay on ``perf_counter``.

Spans below ``engine.device``, one set per chunk of the window, at
``trace`` only (:func:`device_stages`, :func:`stage`), each with attr
``chunk``: ``sampler.draw`` (the tree-sampler launch) and
``validate.lane`` (one per count lane, attrs ``lane`` and ``motif``).
On a card each also records two CUDA timing events and its record gains
``device_ms``, read after the window's host copy (no sync added).
Their cost: 1 + M spans and 2(1 + M) event records a chunk of an M-lane
cohort (the events are pooled, not made anew), each span a few tens of
microseconds of host time against a chunk of tens of milliseconds of
device time; below ``trace`` the window opens none and creates no
event.  Outside the window: ``planner.weights`` (one per weight-DP
candidate the planner resolves: attrs ``signature``, ``delta``,
``hit``, and on a miss ``W``, ``dep_sums`` and ``bytes``) and
``kernels.build`` (one per ``nvcc`` batch, attr ``names``).

**Metrics** (``metrics``) — the typed registry (:mod:`.registry`):
per-stage latency (``repro_stage_seconds{stage=...}``), per-tenant
request/advance histograms, the WAL's fsync latency.  ``engine.STATS``
and ``resilience.STATS`` are :class:`~.registry.CounterBlock` facades
over the same registry, so every counter is a Prometheus series too,
scraped by the ``{"cmd": "metrics"}`` verb and summarised in
``health`` / ``stats``.

**Profiling** — ``{"cmd": "profile", "windows": n}`` arms a one-shot
``torch.profiler`` capture around the next n engine windows (the server
started with ``--profile-dir``); on a card the hand-written kernels,
which launch through ``ctypes`` and are no torch ops, appear as CUDA
kernel events recorded through CUPTI.

Contracts (the reference's): estimates are bit-identical at every level
(spans are host-side, ids come from a counter); ``off`` records
nothing; counters are monotonic (``reset`` is a test seam); all timing
of the serving layers goes through :mod:`.clock`.

**Series the port cannot have.**  The reference's
``repro_engine_window_lru_total{cache, event}`` counts hits and misses
of its LRU of compiled window programs (``repro.core.engine``); the
port compiles nothing and caches no program, so it has no such series
and no stand-in for it.  The port adds three series of its own:
``repro_engine_witness_chunks_total`` (chunks re-drawn by witness
windows), ``repro_engine_witness_seconds_total`` (their wall time,
device synced) and ``repro_engine_samples_drawn_total`` (samples the
count windows drew, one per stream row, counted at every level; its
``rate()`` is the sampler's samples/s).
"""
from __future__ import annotations

from .clock import monotonic, perf_counter, profiler_ns, set_anchor
from .registry import (BUCKET_BOUNDS, N_BUCKETS, REGISTRY, Counter,
                       CounterBlock, Family, Gauge, Histogram, Registry)
from .trace import (METRICS, OFF, RECORDER, TRACE, FlightRecorder, Span,
                    arm_profile, current_trace, device_stages, enabled,
                    event, level, level_name, new_trace, observe_stage,
                    profile_armed, profile_status, profile_window_end,
                    profile_window_start, set_level, set_ring, span,
                    stage, stages_at, summary, trace_context)

__all__ = [
    "monotonic", "perf_counter", "profiler_ns", "set_anchor",
    "BUCKET_BOUNDS", "N_BUCKETS", "REGISTRY", "Counter", "CounterBlock",
    "Family", "Gauge", "Histogram", "Registry",
    "METRICS", "OFF", "RECORDER", "TRACE", "FlightRecorder", "Span",
    "arm_profile", "current_trace", "device_stages", "enabled", "event",
    "level", "level_name", "new_trace", "observe_stage", "profile_armed",
    "profile_status", "profile_window_end", "profile_window_start",
    "set_level", "set_ring", "span", "stage", "stages_at", "summary",
    "trace_context",
]
