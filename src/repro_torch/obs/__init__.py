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
``gateway.emit`` under one id.

**Metrics** (``metrics``) — the typed registry (:mod:`.registry`):
per-stage latency (``repro_stage_seconds{stage=...}``), per-tenant
request/advance histograms, the sampler's samples/s, the WAL's fsync
latency.  ``engine.STATS`` and ``resilience.STATS`` are
:class:`~.registry.CounterBlock` facades over the same registry, so
every counter is a Prometheus series too, scraped by the ``{"cmd":
"metrics"}`` verb and summarised in ``health`` / ``stats``.

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
and no stand-in for it.  The port adds two series of its own:
``repro_engine_witness_chunks_total`` (chunks re-drawn by witness
windows) and ``repro_engine_witness_seconds_total`` (their wall time,
device synced).
"""
from __future__ import annotations

from .clock import monotonic, perf_counter
from .registry import (BUCKET_BOUNDS, N_BUCKETS, REGISTRY, Counter,
                       CounterBlock, Family, Gauge, Histogram, Registry)
from .trace import (METRICS, OFF, RECORDER, TRACE, FlightRecorder, Span,
                    arm_profile, current_trace, enabled, event, level,
                    level_name, new_trace, observe_stage, profile_armed,
                    profile_status, profile_window_end,
                    profile_window_start, set_level, set_ring, span,
                    summary, trace_context)

__all__ = [
    "monotonic", "perf_counter",
    "BUCKET_BOUNDS", "N_BUCKETS", "REGISTRY", "Counter", "CounterBlock",
    "Family", "Gauge", "Histogram", "Registry",
    "METRICS", "OFF", "RECORDER", "TRACE", "FlightRecorder", "Span",
    "arm_profile", "current_trace", "enabled", "event", "level",
    "level_name", "new_trace", "observe_stage", "profile_armed",
    "profile_status", "profile_window_end", "profile_window_start",
    "set_level", "set_ring", "span", "summary", "trace_context",
]
