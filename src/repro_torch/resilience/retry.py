"""Resilience counters and the splitmix64 hash (the port's copy of the
JAX package's ``repro.resilience.retry``, less the retry ladder).

``STATS`` is the process-wide counter block the serve loop's ``health``
verb reports, with the reference's field names.  The reference backs it
with its telemetry registry; the port has no telemetry layer yet, so it
is a plain dataclass with the same ``as_dict`` / ``reset``.  The retry
policy and backoff (``RetryPolicy``, ``backoff_delay``) come with the
port's retry-ladder slice; until then only the WAL counts into
``wal_records`` / ``wal_replayed`` and the serve loop into
``drain_failures`` / ``emit_failures``.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, fields


def _splitmix64(x: int) -> int:
    """The splitmix64 finalizer: a bijective 64-bit integer hash."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


@dataclass
class ResilienceStats:
    """Process-wide resilience counters (the ``health`` verb's payload).

    ``retries``           transient dispatch failures retried in place
    ``ladder_steps``      degradations taken (backend swap or halving)
    ``deadline_degraded`` requests answered as deadline partials
    ``drain_failures``    serve-loop drains that raised (server stayed up)
    ``emit_failures``     response write/flush failures swallowed
    ``wal_records``       WAL records appended this process
    ``wal_replayed``      WAL records replayed by recovery
    """

    retries: int = 0
    ladder_steps: int = 0
    deadline_degraded: int = 0
    drain_failures: int = 0
    emit_failures: int = 0
    wal_records: int = 0
    wal_replayed: int = 0

    def as_dict(self) -> dict:
        return asdict(self)

    def reset(self) -> None:
        for f in fields(self):
            setattr(self, f.name, 0)


STATS = ResilienceStats()
