"""Capped exponential backoff with deterministic jitter + retry counters
(the port's copy of the JAX package's ``repro.resilience.retry``).

The jitter is a pure function of ``(seed, attempt)`` via splitmix64 —
never wall-clock or host RNG — so a chaos run under a fixed fault
schedule sleeps the exact same sequence every time.  The jitter still
de-synchronizes *distinct* seeds (callers pass a per-dispatch seed).

``STATS`` is the process-wide counter block the serve loop's ``health``
verb reports; the engine's ladder, the serve drain/emit guards and the
WAL all increment it.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..obs.registry import CounterBlock


@dataclass(frozen=True)
class RetryPolicy:
    """Frozen backoff schedule: ``max_attempts`` tries total; the sleep
    after failed attempt ``a`` is ``min(cap_s, base_s * multiplier**a)``
    scaled into ``[1 - jitter, 1]`` by the deterministic hash."""

    max_attempts: int = 3
    base_s: float = 0.01
    cap_s: float = 0.25
    multiplier: float = 2.0
    jitter: float = 0.5


#: the engine's per-dispatch policy (small sleeps: a transient device
#: fault either clears in tens of ms or the ladder halves the window)
DISPATCH_POLICY = RetryPolicy()


def _splitmix64(x: int) -> int:
    """The splitmix64 finalizer: a bijective 64-bit integer hash."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def _unit_hash(seed: int, attempt: int) -> float:
    """Deterministic u in [0, 1) from (seed, attempt)."""
    return _splitmix64(_splitmix64(seed) ^ (attempt + 1)) / 2.0 ** 64


def backoff_delay(policy: RetryPolicy, attempt: int, seed: int = 0) -> float:
    """Sleep after failed attempt ``attempt`` (0-based), jittered."""
    raw = min(policy.cap_s, policy.base_s * policy.multiplier ** attempt)
    u = _unit_hash(seed, attempt)
    return raw * (1.0 - policy.jitter + policy.jitter * u)


def backoff_delays(policy: RetryPolicy, seed: int = 0) -> list:
    """The full deterministic sleep schedule: one entry per retry (so
    ``max_attempts - 1`` entries — no sleep after the final failure,
    which escalates to the caller)."""
    return [backoff_delay(policy, a, seed)
            for a in range(max(0, policy.max_attempts - 1))]


class ResilienceStats(CounterBlock):
    """Process-wide resilience counters (the ``health`` verb's payload),
    a :class:`repro_torch.obs.registry.CounterBlock` facade — each field
    is a registry counter (``repro_resilience_*_total``) that also
    appears in the ``{"cmd": "metrics"}`` scrape.  Counters are
    monotonic; ``reset()`` is a test-only seam.

    ``retries``           transient dispatch failures retried in place
    ``ladder_steps``      degradations taken (window halvings; the
                          reference's backend swap has no counterpart)
    ``deadline_degraded`` requests answered as deadline partials
    ``drain_failures``    serve-loop drains that raised (server stayed up)
    ``emit_failures``     response write/flush failures swallowed
    ``wal_records``       WAL records appended this process
    ``wal_replayed``      WAL records replayed by recovery
    """

    _PREFIX = "repro_resilience"
    _FIELDS = ("retries", "ladder_steps", "deadline_degraded",
               "drain_failures", "emit_failures", "wal_records",
               "wal_replayed")
    _DOCS = {
        "retries": "transient dispatch failures retried in place",
        "ladder_steps": "degradations taken (backend swap or halving)",
        "deadline_degraded": "requests answered as deadline partials",
        "drain_failures": "serve-loop drains that raised",
        "emit_failures": "response write/flush failures swallowed",
        "wal_records": "WAL records appended this process",
        "wal_replayed": "WAL records replayed by recovery",
    }


STATS = ResilienceStats()
