"""``repro_torch.estimate`` refuses what the reference refuses: k < 1 and
delta < 0 with the reference's ``ValueError`` messages, and delta = 0
with C3 on fails in both (the window stride is delta)."""
from __future__ import annotations

import pytest

from repro.core.estimator import estimate as ref_estimate
from repro.core.motif import get_motif as rget
from repro.graphs import powerlaw_temporal_graph as rgraph
from repro_torch import estimate, get_motif, powerlaw_temporal_graph

GRAPH = dict(n=150, m=2000, time_span=40000, seed=11)


def _raised(fn, *args, **kw) -> BaseException:
    with pytest.raises(Exception) as info:
        fn(*args, **kw)
    return info.value


@pytest.mark.parametrize("delta,k", [(3000, 0), (3000, -5), (-1, 512)])
def test_bad_k_and_delta_raise_the_reference_value_error(delta, k):
    kw = dict(seed=3, chunk=256)
    want = _raised(ref_estimate, rgraph(**GRAPH), rget("M4-2"), delta, k,
                   **kw)
    got = _raised(estimate, powerlaw_temporal_graph(**GRAPH),
                  get_motif("M4-2"), delta, k, device="cpu", **kw)
    assert type(want) is ValueError and type(got) is ValueError
    assert str(got) == str(want)


def test_zero_delta_with_c3_fails_in_both():
    kw = dict(seed=3, chunk=256)
    want = _raised(ref_estimate, rgraph(**GRAPH), rget("M4-2"), 0, 512,
                   **kw)
    got = _raised(estimate, powerlaw_temporal_graph(**GRAPH),
                  get_motif("M4-2"), 0, 512, device="cpu", **kw)
    assert type(want) is ZeroDivisionError
    assert type(got) is ZeroDivisionError
