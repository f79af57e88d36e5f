"""Sanctioned wall-clock reads: the ONE module of the port's serving
layers allowed to touch ``time.monotonic`` / ``time.perf_counter``
(the port's copy of the JAX package's ``repro.obs.clock``).

The gateway, the engine, the session, the serve loop and the stream
time themselves through the span/histogram API or these two accessors:
wall-clock values are host-side observability metadata and never enter
a sampling key.

``monotonic`` is for deadline math (comparable across threads);
``perf_counter`` is for durations.  Both are re-exported from
``repro.obs``.

**The profiler's clock.**  ``torch.profiler`` (Kineto) stamps its
events in Unix-epoch nanoseconds, the clock of ``time.time_ns``.
:func:`set_anchor` reads ``(perf_counter_ns, time_ns)`` back to back,
keeping the tightest of a few tries, and :func:`profiler_ns` maps a
``perf_counter`` reading onto that clock through it.  The anchor is
taken whenever the obs level becomes ``trace`` (``trace.set_level``)
and again when a profile capture starts (``trace.profile_window_start``),
since ``time_ns`` may be slewed or stepped while a server runs;
every record made at that level carries its start as ``ts_ns``, so a
span and a profiler event compare without a guessed offset.  Durations
stay on ``perf_counter``.
"""
from __future__ import annotations

import time

monotonic = time.monotonic
perf_counter = time.perf_counter

#: ``[perf_counter_ns, time_ns]`` of the last :func:`set_anchor`
_ANCHOR: list = []
#: back-to-back reads an anchor keeps the tightest of
_ANCHOR_TRIES = 5


def set_anchor() -> tuple:
    """Pair ``perf_counter`` with the profiler's clock: of a few
    back-to-back reads ``perf_counter_ns, time_ns, perf_counter_ns``,
    keep the one whose two ``perf_counter`` reads lie closest, with
    ``time_ns`` taken at their midpoint.  Returns ``(perf_ns,
    unix_ns)``."""
    best = None
    for _ in range(_ANCHOR_TRIES):
        a = time.perf_counter_ns()
        unix = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, unix)
    _ANCHOR[:] = best[1:]
    return tuple(_ANCHOR)


def offset_ns() -> int:
    """Profiler ns minus ``perf_counter`` ns (anchored on first use)."""
    if not _ANCHOR:
        set_anchor()
    return _ANCHOR[1] - _ANCHOR[0]


def profiler_ns(t: float) -> int:
    """The ``perf_counter`` reading ``t`` (seconds) on the profiler's
    clock: Unix-epoch nanoseconds."""
    return round(t * 1e9) + offset_ns()
