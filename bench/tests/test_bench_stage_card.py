"""On the card: a small copy of each cell runs traced through the
harness, correct, and reports the readers of the program's stage spans
(``python -m pytest -m cuda bench/tests`` on a machine with an H100)."""
import pytest
import torch

from bench import run as harness
from bench.tests import small

STAGE_METRICS = ("sampler_device_ms_per_chunk.samples",
                 "validate_device_ms_per_lane_chunk.samples",
                 "validate_idle.samples", "weights_dp_s")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(small.CELLS))
def test_small_cell_reports_its_stage_metrics_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg, mix = small.CELLS[cell]
    out = harness.run(cell, 2**31 + 19, 1.0, True, device="cuda",
                      config=small.config(cfg, 400_000),
                      traffic=small.traffic(mix, chunk=8192, k=16384),
                      forbid=())
    assert out["correct"], out["checks"]
    got = {n: out["metrics"][n]["value"] for n in STAGE_METRICS}
    assert got["sampler_device_ms_per_chunk.samples"] > 0
    assert got["validate_device_ms_per_lane_chunk.samples"] > 0
    assert 0 <= got["validate_idle.samples"] <= 100
    assert got["weights_dp_s"] > 0
