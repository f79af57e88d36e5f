"""Crash-safe writes and the failure taxonomy (own copies of the JAX
package's ``repro.resilience.atomic`` and ``repro.resilience.errors``).

Not here yet: the fault-injection hook ``fire``, the retry ladder and
its ``STATS`` (they come with the port's resilience slice)."""
from .atomic import atomic_write_json
from .errors import (BAD_REQUEST, FATAL, OVERLOADED, RETRYABLE,
                     BadRequestError, FatalError, OverloadedError,
                     TransientError, classify, error_payload, is_retryable)

__all__ = ["BAD_REQUEST", "BadRequestError", "FATAL", "FatalError",
           "OVERLOADED", "OverloadedError", "RETRYABLE", "TransientError",
           "atomic_write_json", "classify", "error_payload", "is_retryable"]
