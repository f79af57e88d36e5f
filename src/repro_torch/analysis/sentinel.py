"""Runtime rebuild sentinel: fail when a warm path builds or loads a
kernel (the port's counterpart of the reference's ``no_retrace``).

The reference's hazard is a jit cache that grows on a warm path.  The
port compiles nothing at run time but its CUDA kernels
(``kernels/_build.py``: ``nvcc`` on first use, then ``ctypes`` loads
the library once per process), so its warm-path hazard is a build or a
load inside a region that should find every kernel ready -- a second
build costs seconds of ``nvcc``, and a load on a serving thread stalls
it.  ``no_rebuild()`` wraps such a region and raises
:class:`RebuildError` if ``_build`` compiled or loaded anything inside
it:

    with no_rebuild() as probe:
        session.submit_many(requests)          # warm path
    assert probe.builds == probe.loads == 0    # (it raised otherwise)

``allow_new=True`` permits first loads of kernels not yet loaded in
this process (a first touch) while still forbidding a rebuild or a
second load of one already loaded.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass


class RebuildError(AssertionError):
    """A region declared build-free built or loaded a kernel."""


@dataclass
class RebuildProbe:
    """What the region did, filled on exit."""

    builds: int = 0              # nvcc compiles
    loads: int = 0               # ctypes loads
    loaded: tuple = ()           # kernels first loaded in the region


@contextmanager
def no_rebuild(allow_new: bool = False):
    """Raise :class:`RebuildError` if ``kernels._build`` compiled a
    kernel inside the region, or loaded one (with ``allow_new``, only a
    kernel that was already loaded on entry counts)."""
    from ..kernels import _build

    before = dict(_build.COUNTS)
    loaded0 = set(_build.loaded())
    probe = RebuildProbe()
    yield probe
    probe.builds = _build.COUNTS["builds"] - before["builds"]
    probe.loads = _build.COUNTS["loads"] - before["loads"]
    probe.loaded = tuple(sorted(set(_build.loaded()) - loaded0))
    failures = []
    if probe.builds:
        failures.append(f"{probe.builds} kernel build(s) (nvcc)")
    if probe.loads and not (allow_new and probe.loads == len(probe.loaded)):
        failures.append(f"{probe.loads} kernel load(s): "
                        f"{list(probe.loaded)}")
    if failures:
        raise RebuildError("no_rebuild region built or loaded kernels: "
                           + "; ".join(failures))
