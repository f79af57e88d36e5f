"""Crash-safe writes, the failure taxonomy, fault injection and the
resilience counters (own copies of the JAX package's
``repro.resilience.atomic``, ``errors``, ``faultinject`` and the
``STATS`` block of ``retry``).

Not here yet: the retry ladder (``RetryPolicy``, backoff), which comes
with the port's retry-ladder slice."""
from .atomic import atomic_write_json
from .errors import (BAD_REQUEST, FATAL, OVERLOADED, RETRYABLE,
                     BadRequestError, FatalError, OverloadedError,
                     TransientError, classify, error_payload, is_retryable)
from .faultinject import FaultInjector, FaultSpec, fire, seeded_hits
from .retry import STATS, ResilienceStats

__all__ = ["BAD_REQUEST", "BadRequestError", "FATAL", "FatalError",
           "FaultInjector", "FaultSpec", "OVERLOADED", "OverloadedError",
           "RETRYABLE", "ResilienceStats", "STATS", "TransientError",
           "atomic_write_json", "classify", "error_payload", "fire",
           "is_retryable", "seeded_hits"]
