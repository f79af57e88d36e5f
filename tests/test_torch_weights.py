"""The port's weight DP against ``repro.core.weights.preprocess`` (exact
int64 ``xla`` dep-sum backend): every ``Weights`` array, bit for bit."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import repro.core.weights as rw
from repro.core.graph import pad_snapshot
from repro.core.motif import get_motif as rget
from repro.core.spanning_tree import candidate_trees as rcands
from repro.graphs import powerlaw_temporal_graph as rgraph
from repro_torch.core import weights as tw
from repro_torch.core.graph import TemporalGraph
from repro_torch.core.motif import get_motif as tget
from repro_torch.core.spanning_tree import candidate_trees as tcands
from repro_torch.graphs import powerlaw_temporal_graph as tgraph

GRAPH = dict(n=150, m=2000, time_span=40000, seed=11)
DELTA = 3000
VARIANTS = {"default": dict(use_c2=True, use_c3=True),
            "c2-off": dict(use_c2=False, use_c3=True),
            "c3-off": dict(use_c2=True, use_c3=False)}


@pytest.fixture(scope="module")
def graphs():
    return rgraph(**GRAPH), tgraph(**GRAPH)


def _assert_same(got: tw.Weights, want) -> None:
    assert (got.delta, got.wd, got.q, got.use_c2) == \
        (want.delta, want.wd, int(want.q), want.use_c2)
    for f in tw.ARRAY_FIELDS:
        a = getattr(got, f).numpy()
        b = np.asarray(getattr(want, f))
        # weights and prefixes are int64 on both sides; the window edge
        # ids are int32 in the reference and int64 in the port
        assert a.dtype == np.int64, f
        assert b.dtype == (np.int32 if f.startswith("win_") else np.int64)
        assert a.shape == b.shape and np.array_equal(a, b), f


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("motif", ["M5-3", "M4-2"])
def test_weights_match_reference(graphs, motif, variant):
    rg, tg = graphs
    kw = VARIANTS[variant]
    dev = tg.device_arrays("cpu")
    for rtree, ttree in list(zip(rcands(rget(motif)),
                                 tcands(tget(motif))))[:2]:
        want = rw.preprocess(rg, rtree, DELTA, backend="xla", **kw)
        got = tw.preprocess(tg, ttree, DELTA, dev=dev, **kw)
        _assert_same(got, want)
        assert int(got.W_total) > 0


def test_padded_graph_masks_pad_edges(graphs):
    """``m_real`` zeroes pad-edge weights: a graph padded with a suffix
    of pad edges (the reference's ``pad_snapshot``, windows unpadded)
    gives the reference's padded arrays and the unpadded graph's ``W``."""
    rg, tg = graphs
    rp = pad_snapshot(rg, pad_windows=False)
    tp = TemporalGraph(**{f.name: getattr(rp, f.name)
                          for f in dataclasses.fields(TemporalGraph)})
    assert tp.m > tp.live_m
    rtree, ttree = rcands(rget("M5-3"))[0], tcands(tget("M5-3"))[0]
    want = rw.preprocess(rp, rtree, DELTA, backend="xla")
    got = tw.preprocess(tp, ttree, DELTA, device="cpu")
    _assert_same(got, want)
    plain = tw.preprocess(tg, ttree, DELTA, device="cpu")
    assert int(got.W_total) == int(plain.W_total)


def test_weights_from_numpy_carries_the_reference_state(graphs):
    rg, tg = graphs
    rtree, ttree = rcands(rget("M4-2"))[0], tcands(tget("M4-2"))[0]
    want = rw.preprocess(rg, rtree, DELTA, backend="xla")
    got = tw.weights_from_numpy(
        ttree, want.delta, want.wd, int(want.q), want.use_c2,
        {f: np.asarray(getattr(want, f)) for f in tw.ARRAY_FIELDS}, "cpu")
    _assert_same(got, want)
    assert got.tree is ttree


def test_num_windows_and_access_alpha():
    for span, wd in [(0, 5), (39999, 3000), (40000, 40001), (10, 3)]:
        assert tw.num_windows(span, wd) == rw.num_windows(span, wd)
    for rt, tt in zip(rcands(rget("M5-3")), tcands(tget("M5-3"))):
        assert tw.access_alpha(tt) == rw.access_alpha(rt)
