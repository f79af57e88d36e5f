"""Deterministic fault injection: named sites, explicit hit schedules
(the port's copy of the JAX package's ``repro.resilience.faultinject``).

Production code calls :func:`fire` at its failure-prone seams, the
reference's five, its witness site and the port's shard site::

    fire("engine.dispatch", tag=device)    # before every window dispatch
    fire("engine.shard",    tag=f"{device}:{d}")   # shard d's first chunk
                                           # of every dispatch attempt
    fire("engine.witness",  tag=device)    # before every witness window
    fire("sampler.call",    tag=device)    # window function construction
    fire("wal.fsync")                      # before the WAL durability sync
    fire("serve.write")                    # before each response write
    fire("checkpoint.write", tag=path)     # MID checkpoint temp-file write

The port's ``tag`` for the engine sites is the device type the window
runs on (``"cuda"`` or ``"cpu"``), where the reference names its
sampler backend.

With no injector installed this is a None check.  Tests
install a :class:`FaultInjector` whose :class:`FaultSpec` schedule says
exactly which *hit indices* of which site fail with which exception.
Schedules are explicit tuples or :func:`seeded_hits` plans (splitmix64
over an explicit seed) — never wall-clock or host RNG — so every chaos
run replays bit-identically.

Only one injector may be active at a time (they are process-global, as
the sites are), and installation is a context manager::

    with FaultInjector([FaultSpec("engine.dispatch", hits=(0, 1))]):
        ...   # the first two matching dispatches raise TransientError
"""
from __future__ import annotations

from dataclasses import dataclass

from .errors import TransientError
from .retry import _splitmix64


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: fail hits ``hits`` of calls matching
    ``site`` (exact) + ``tag`` (substring; "" matches every tag).

    ``hits`` are 0-based indices into THIS spec's matched-call counter;
    ``hits=None`` fails every matched call.  ``exc`` is the exception
    *class* raised (a fresh instance per firing, carrying ``message``).
    """

    site: str
    hits: tuple | None = (0,)
    exc: type = TransientError
    message: str = ""
    tag: str = ""

    def matches(self, site: str, tag: str) -> bool:
        return site == self.site and (not self.tag or self.tag in tag)


class FaultInjector:
    """A replayable fault plan over the named sites.

    ``log`` records every matched call as ``(site, tag, hit, fired)``
    tuples, so a test can assert the plan executed exactly as scheduled.
    """

    def __init__(self, specs):
        self.specs = list(specs)
        self._counts = [0] * len(self.specs)
        self.log: list = []

    def fire(self, site: str, tag: str = "") -> None:
        for i, spec in enumerate(self.specs):
            if not spec.matches(site, tag):
                continue
            hit = self._counts[i]
            self._counts[i] += 1
            fired = spec.hits is None or hit in spec.hits
            self.log.append((site, tag, hit, fired))
            if fired:
                raise spec.exc(
                    spec.message
                    or f"injected fault at {site} (tag={tag!r}, hit={hit})")

    # -- installation ----------------------------------------------------
    def __enter__(self) -> "FaultInjector":
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("a FaultInjector is already installed")
        _ACTIVE = self
        return self

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        _ACTIVE = None


_ACTIVE: FaultInjector | None = None


def fire(site: str, tag: str = "") -> None:
    """Production seam: no-op unless a :class:`FaultInjector` is active."""
    inj = _ACTIVE
    if inj is not None:
        inj.fire(site, tag)


def seeded_hits(seed: int, n_calls: int, rate: float) -> tuple:
    """Deterministic hit schedule: of ``n_calls`` opportunities, fail
    those whose splitmix64 draw lands under ``rate``.  A pure function
    of ``seed`` — the replayable alternative to random chaos."""
    if not 0.0 <= rate <= 1.0:
        raise ValueError(f"rate must be in [0, 1], got {rate}")
    return tuple(i for i in range(n_calls)
                 if _splitmix64(_splitmix64(seed) ^ i) / 2.0 ** 64 < rate)
