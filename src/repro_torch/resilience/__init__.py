"""Resilience layer: error taxonomy, retry ladder, fault injection
(the port's copy of the JAX package's ``repro.resilience``, whose
docstring holds the design notes).

``errors``
    The failure taxonomy: :func:`classify` maps any exception to
    ``"retryable"`` / ``"fatal"`` / ``"bad_request"`` /
    ``"overloaded"`` (the card's out-of-memory and kernel launch errors
    included), and :func:`error_payload` is the ONE wire encoding of a
    failure.
``retry``
    Capped exponential backoff with deterministic jitter,
    :class:`RetryPolicy`, and the process-wide :data:`STATS` counters
    (a ``repro_torch.obs`` ``CounterBlock``).
``faultinject``
    Named ``fire()`` sites (``engine.dispatch``, ``engine.witness``,
    ``sampler.call``, ``wal.fsync``, ``serve.write``,
    ``checkpoint.write``) that are no-ops until a test installs a
    :class:`FaultInjector`.
``atomic``
    Crash-safe file writes with an injection point mid-write.

Layering: this package imports only the stdlib and ``repro_torch.obs``.
The engine's ladder built on it (retry, then halve the window, then
raise) is execution-only: chunk ``j`` always draws ``fold_in(base_key,
j)``, so every rung is bit-identical.
"""
from .atomic import atomic_write_json
from .errors import (BAD_REQUEST, FATAL, OVERLOADED, RETRYABLE,
                     BadRequestError, CudaLaunchError, FatalError,
                     OverloadedError, TransientError, classify,
                     error_payload, is_retryable)
from .faultinject import FaultInjector, FaultSpec, fire, seeded_hits
from .retry import STATS, ResilienceStats, RetryPolicy, backoff_delays

__all__ = ["BAD_REQUEST", "BadRequestError", "CudaLaunchError", "FATAL",
           "FatalError", "FaultInjector", "FaultSpec", "OVERLOADED",
           "OverloadedError", "RETRYABLE", "ResilienceStats", "RetryPolicy",
           "STATS", "TransientError", "atomic_write_json", "backoff_delays",
           "classify", "error_payload", "fire", "is_retryable",
           "seeded_hits"]
