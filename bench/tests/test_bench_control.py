"""The control of ``correct``: the reference with float32 weights in the
program's place fails the comparison, at a size a test run holds (the
cells' own size is run on the card: ``bench/control.py``)."""
import pytest

from bench.control import control
from bench.tests import small


#: small graphs and windows whose W passes 2^24, where float32 rounds
SIZES = {"wikitalk.census": (9000, 300000),
         "aml-hi-small.screen": (4000, 400000)}


@pytest.mark.parametrize("cell", sorted(small.CELLS))
def test_float32_weights_fail_the_comparison(cell):
    cfg, mix = small.CELLS[cell]
    edges, delta = SIZES[cell]
    got = control(cell, 2**31 + 21, device="cpu",
                  config=small.config(cfg, edges),
                  traffic=small.traffic(mix, delta=delta))
    assert max(got["W_exact"]) > 2**24
    assert got["plans"] + got["sums"] + got["estimates"] > 0
