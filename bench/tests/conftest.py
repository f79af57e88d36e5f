"""The harness's own tests: CPU at small sizes; cases that need the card
carry the ``cuda`` marker and skip without one."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU with nvcc (the port's CUDA "
        "kernels); skips without one")


@pytest.fixture(autouse=True)
def one_cpu_thread():
    """Run each harness test on one CPU thread: its many small torch ops
    gain nothing from a thread pool, and a pool's barriers stall when
    the test runner's other workers hold the cores."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)
