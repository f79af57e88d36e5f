"""Shared fixtures: the retrace sentinel as a pytest fixture.

``no_retrace`` yields the context manager from ``repro.analysis.sentinel``
so warm-path tests write::

    def test_warm_path(no_retrace):
        cold_call()                      # compiles
        with no_retrace() as probe:
            warm_call()                  # must reuse compiled programs
        assert probe.dispatches > 0

and fail with :class:`repro.analysis.RetraceError` if any compiled
window program (or explicitly ``watch``-ed jitted fn) recompiles inside
the region.
"""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


@pytest.fixture
def no_retrace():
    from repro.analysis import no_retrace as _no_retrace
    return _no_retrace


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU with nvcc (the port's CUDA "
        "kernels); skips without one")
