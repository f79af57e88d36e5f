"""On the card: a small copy of each cell runs traced through the
harness, correct, with its per-layer metrics read from the profiled
slice (``python -m pytest -m cuda bench/tests`` on a machine with an
H100)."""
import pytest
import torch

from bench import run as harness
from bench.tests import small


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(small.CELLS))
def test_small_cell_traced_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg, mix = small.CELLS[cell]
    out = harness.run(cell, 2**31 + 17, 1.0, True, device="cuda",
                      config=small.config(cfg, 400_000),
                      traffic=small.traffic(mix, chunk=8192, k=16384),
                      forbid=())
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
    assert {"device_idle.samples", "kernels_per_lane_chunk.samples",
            "jobs_per_cohort.samples"} <= set(out["metrics"])
    assert 0 < out["metrics"]["tree_sampler_roofline.samples"]["value"] <= 105
