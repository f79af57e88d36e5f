"""Padded epoch snapshots: the port's ``pad_snapshot`` against the
reference's, array for array, and the bucketed ``Weights`` of a
``pad_windows`` snapshot against ``repro.core.weights.preprocess``.

The samplers must never select a pad edge, so an estimate on a padded
snapshot equals the unpadded graph's, bit for bit, on the port as on
the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import repro.core.weights as rw
from repro.core.estimator import estimate as rest
from repro.core.graph import next_pow2 as rnext_pow2
from repro.core.graph import pad_bucket as rpad_bucket
from repro.core.graph import pad_snapshot as rpad
from repro.core.motif import get_motif as rget
from repro.core.spanning_tree import candidate_trees as rcands
from repro.graphs import powerlaw_temporal_graph as rgraph
from repro_torch import estimate
from repro_torch.core import weights as tw
from repro_torch.core.graph import next_pow2, pad_bucket, pad_snapshot
from repro_torch.core.motif import get_motif as tget
from repro_torch.core.spanning_tree import candidate_trees as tcands
from repro_torch.graphs import powerlaw_temporal_graph as tgraph

GRAPH = dict(n=150, m=2000, time_span=40000, seed=11)
# (m_floor, n_floor, p_floor) and explicit buckets: no floor, the
# stream store's floors, a floor that makes most edges pads, and
# buckets given outright
PADS = {"natural": dict(),
        "store-floors": dict(m_floor=1024, n_floor=64, p_floor=256),
        "mostly-pads": dict(m_floor=4096, n_floor=512, p_floor=4096),
        "explicit": dict(m_bucket=2048, n_bucket=256, p_bucket=1024),
        "windows-unpadded": dict(m_floor=4096, pad_windows=False)}
INT_FIELDS = ("estimate", "W", "k", "cnt2_sum", "valid", "fail_vmap",
              "fail_delta", "fail_order", "overflow", "tree_edges")


@pytest.fixture(scope="module")
def graphs():
    return rgraph(**GRAPH), tgraph(**GRAPH)


def _same_graph(got, want) -> None:
    assert ({f.name for f in dataclasses.fields(got)}
            == {f.name for f in dataclasses.fields(want)})
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("pad", sorted(PADS))
def test_pad_snapshot_equals_reference(graphs, pad):
    rg, tg = graphs
    want = rpad(rg, **PADS[pad])
    got = pad_snapshot(tg, **PADS[pad])
    _same_graph(got, want)
    assert (got.live_m, got.live_n, got.p_real) == (tg.m, tg.n,
                                                    tg.num_pairs)
    assert got.m >= got.live_m and got.max_multiplicity(3000) == \
        want.max_multiplicity(3000) == tg.max_multiplicity(3000)
    with pytest.raises(ValueError, match="already padded"):
        pad_snapshot(got)


def test_buckets_and_refusals_as_the_reference(graphs):
    for x in (0, 1, 2, 3, 1023, 1024, 1025, 2 ** 20 + 1):
        assert next_pow2(x) == rnext_pow2(x)
        for floor in (1, 64, 1000):
            assert pad_bucket(x, floor) == rpad_bucket(x, floor)
    rg, tg = graphs
    for bad in (dict(n_bucket=tg.n + 1), dict(m_bucket=tg.m - 1),
                dict(p_bucket=tg.num_pairs)):
        with pytest.raises(ValueError) as want:
            rpad(rg, **bad)
        with pytest.raises(ValueError) as got:
            pad_snapshot(tg, **bad)
        assert str(got.value) == str(want.value)


def test_pad_pair_is_not_the_graphs_multiplicity():
    """Many pad edges share one pair and one timestamp: ``max_multiplicity``
    stops at ``p_real``, as the reference's."""
    small = dict(n=30, m=60, time_span=5000, seed=2)
    rp = rpad(rgraph(**small), m_floor=1024)
    tp = pad_snapshot(tgraph(**small), m_floor=1024)
    for delta in (0, 100, 5000):
        assert tp.max_multiplicity(delta) == rp.max_multiplicity(delta)
        assert tp.max_multiplicity(delta) < tp.m - tp.live_m


@pytest.mark.parametrize("delta", [3000, 700])
@pytest.mark.parametrize("motif", ["M5-3", "M4-2"])
def test_bucketed_weights_equal_reference(graphs, motif, delta):
    """``pad_windows`` snapshots bucket ``ps_win`` and the window bounds
    to ``q_pad = pad_bucket(q)`` slots, ``W_i = 0`` past ``q``."""
    rg, tg = graphs
    rp = rpad(rg, m_floor=4096)
    tp = pad_snapshot(tg, m_floor=4096)
    rtree, ttree = rcands(rget(motif))[0], tcands(tget(motif))[0]
    want = rw.preprocess(rp, rtree, delta, backend="xla")
    got = tw.preprocess(tp, ttree, delta, device="cpu")
    assert got.q == int(want.q) and got.q_pad == want.q_pad
    assert got.q_pad == pad_bucket(got.q) > got.q
    for f in tw.ARRAY_FIELDS:
        a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert a.shape == b.shape and np.array_equal(a, b), f
    assert not got.W_win[got.q:].any()
    plain = tw.preprocess(tg, ttree, delta, device="cpu")
    assert int(got.W_total) == int(plain.W_total)
    assert np.array_equal(got.ps_win[:got.q + 1].numpy(),
                          plain.ps_win.numpy())


@pytest.mark.parametrize("motif,delta,k,seed", [("M5-3", 3000, 1024, 0),
                                                ("M4-2", 3000, 512, 3),
                                                ("M4-1", 40000, 512, 1)])
def test_estimate_on_padded_snapshot_equals_unpadded(graphs, motif, delta,
                                                     k, seed):
    """More than half the edges are pads, the windows are bucketed, and
    the estimate equals the reference's on the unpadded graph."""
    rg, tg = graphs
    tp = pad_snapshot(tg, m_floor=4096)
    got = estimate(tp, tget(motif), delta, k, seed=seed, chunk=256,
                   device="cpu")
    plain = estimate(tg, tget(motif), delta, k, seed=seed, chunk=256,
                     device="cpu")
    want = rest(rg, rget(motif), delta, k, seed=seed, chunk=256)
    for f in INT_FIELDS:
        assert getattr(got, f) == getattr(plain, f) == getattr(want, f), f
