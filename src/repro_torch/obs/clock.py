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
"""
from __future__ import annotations

import time

monotonic = time.monotonic
perf_counter = time.perf_counter
