"""Failure taxonomy: every fault in the serving stack gets ONE kind.

Three kinds, chosen for what the caller should *do* next:

* ``retryable`` — transient device/host conditions (device OOM,
  connection resets, timeouts): worth retrying with backoff.
* ``bad_request`` — the input is wrong (unknown motif, malformed
  fields): retrying is useless, but the server stays up and answers
  ``ok: false``.
* ``fatal`` — everything else (logic errors, assertion failures):
  never retried; surfaces to the caller.
* ``overloaded`` — admission control shed the request before executing
  it (a bounded per-tenant quota was full — the gateway's backpressure
  seam).  The client backs off and resubmits; the server never retries
  shed work itself, which is what distinguishes it from ``retryable``.

The port's own copy of ``repro.resilience.errors``: :func:`classify`
is the single decision point the engine's retry ladder and the serve
loops consult, and it gives the same kind as the JAX package's for every
exception both can meet.  It also knows the card's faults, which the
reference (matching XLA's error types) cannot see:

* ``torch.cuda.OutOfMemoryError`` (matched by type name, no torch
  import) is ``retryable``, as the reference's ``RESOURCE_EXHAUSTED``;
* a kernel launch that returned a ``cudaError`` raises
  :class:`CudaLaunchError` (``kernels._build.check``), which carries the
  number: ``cudaErrorMemoryAllocation`` (2) is ``retryable``; every
  other code is ``fatal``, the sticky ones (an illegal address, a
  device-side assert, a launch failure) above all, because they poison
  the CUDA context and a retry can only fail again.
"""
from __future__ import annotations


RETRYABLE = "retryable"
FATAL = "fatal"
BAD_REQUEST = "bad_request"
OVERLOADED = "overloaded"


class TransientError(RuntimeError):
    """Marker: a fault the raiser already knows is worth retrying."""


class OverloadedError(RuntimeError):
    """Marker: the server shed this request at admission (a bounded
    per-tenant quota was full — the gateway's backpressure seam).  The
    request was never executed; the client should back off and resubmit,
    but unlike ``retryable`` the *server* will not retry on its behalf.
    """


class FatalError(RuntimeError):
    """Marker: a fault the raiser already knows must NOT be retried."""


class BadRequestError(ValueError):
    """Marker: the request itself is invalid (never retried)."""


#: ``cudaErrorMemoryAllocation``: the one launch error worth a retry
#: (the sticky ones, 700 illegal address, 710 device-side assert, 719
#: launch failure, and every other code are fatal)
CUDA_ERROR_MEMORY_ALLOCATION = 2


class CudaLaunchError(RuntimeError):
    """A hand-written kernel's launch returned ``cudaError`` ``code``
    (``kernels._build.check``).  Only an allocation failure is worth
    retrying."""

    def __init__(self, name: str, code: int):
        super().__init__(f"{name}: CUDA launch failed with cudaError "
                         f"{code}")
        self.kernel = name
        self.code = int(code)


# host-side exception types that model transient conditions
_TRANSIENT_TYPES = (ConnectionError, TimeoutError, InterruptedError,
                    MemoryError)

# type names (checked against the MRO) whose message text carries the
# real status
_DEVICE_ERROR_NAMES = ("XlaRuntimeError", "JaxRuntimeError")

# the card's out-of-memory error (torch.cuda.OutOfMemoryError), by name
_DEVICE_OOM_NAMES = ("OutOfMemoryError",)

# transient gRPC/XLA status markers inside a device error message
_TRANSIENT_STATUS = ("RESOURCE_EXHAUSTED", "UNAVAILABLE",
                     "DEADLINE_EXCEEDED", "ABORTED", "CANCELLED",
                     "OUT OF MEMORY", "OOM")


def classify(exc: BaseException) -> str:
    """Map an exception to ``retryable`` / ``fatal`` / ``bad_request`` /
    ``overloaded``."""
    if isinstance(exc, OverloadedError):
        return OVERLOADED
    if isinstance(exc, BadRequestError):
        return BAD_REQUEST
    if isinstance(exc, FatalError):
        return FATAL
    if isinstance(exc, TransientError) or isinstance(exc, _TRANSIENT_TYPES):
        return RETRYABLE
    if isinstance(exc, CudaLaunchError):
        return (RETRYABLE if exc.code == CUDA_ERROR_MEMORY_ALLOCATION
                else FATAL)
    mro_names = {c.__name__ for c in type(exc).__mro__}
    if mro_names & set(_DEVICE_OOM_NAMES):
        return RETRYABLE
    if mro_names & set(_DEVICE_ERROR_NAMES):
        msg = str(exc).upper()
        if any(status in msg for status in _TRANSIENT_STATUS):
            return RETRYABLE
        return FATAL
    if isinstance(exc, (ValueError, TypeError, KeyError)):
        return BAD_REQUEST
    return FATAL


def is_retryable(exc: BaseException) -> bool:
    return classify(exc) == RETRYABLE


def error_payload(exc: BaseException) -> dict:
    """The wire encoding of a failure: ``{"error": ..., "error_kind": ...}``.

    Every ``ok: false`` response the serve loop emits goes through here,
    so clients can branch on ``error_kind`` instead of parsing message
    strings.
    """
    return dict(error=f"{type(exc).__name__}: {exc}",
                error_kind=classify(exc))
