"""The port's own copies of the graph build, generators, motif catalog
and spanning trees give exactly the JAX package's."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import repro.core.weights  # noqa: F401  (turns on jax x64, as the reference runs)
import repro.graphs as rgraphs
from repro.core import motif as rmotif
from repro.core import spanning_tree as rst
from repro_torch import graphs as tgraphs
from repro_torch.core import motif as tmotif
from repro_torch.core import spanning_tree as tst
from repro_torch.core.graph import TemporalGraph

GENERATORS = [
    ("powerlaw_temporal_graph", dict(n=150, m=2000, time_span=40000,
                                     seed=11)),
    ("powerlaw_temporal_graph", dict(n=300, m=3000, alpha=2.1,
                                     time_span=100000, seed=0)),
    ("er_temporal_graph", dict(n=100, m=1500, time_span=20000, seed=4)),
    ("fintxn_temporal_graph", dict(n_accounts=120, m=1500,
                                   time_span=50000, seed=2)),
]


def _fields_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("name,kw", GENERATORS,
                         ids=[f"{g[0]}-{i}" for i, g in enumerate(GENERATORS)])
def test_generators_and_host_build_match(name, kw):
    ref = getattr(rgraphs, name)(**kw)
    got = getattr(tgraphs, name)(**kw)
    # the port's fields are the reference's, and every one is equal
    assert ({f.name for f in dataclasses.fields(got)}
            == {f.name for f in dataclasses.fields(ref)})
    _fields_equal(got, ref)


def test_from_edges_dedups_and_relabels_like_the_reference():
    r = np.random.default_rng(3)
    src = r.integers(0, 40, 500) * 7 + 100
    dst = r.integers(0, 40, 500) * 7 + 101
    t = r.integers(5, 400, 500)
    src[:20], dst[:20], t[:20] = src[20:40], dst[20:40], t[20:40]  # dups
    from repro.core.graph import TemporalGraph as RG
    _fields_equal(TemporalGraph.from_edges(src, dst, t),
                  RG.from_edges(src, dst, t))


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("dups", [0, 1, 40])
def test_from_edges_equals_reference_on_unsorted_batches(seed, dups):
    """Unsorted edges with no, one or many repeated (src, dst, t) tuples,
    as a stream store hands them over: the port's duplicate test and the
    reference's row-unique count agree, and so do the graphs."""
    from repro.core.graph import TemporalGraph as RG
    r = np.random.default_rng(seed)
    src, dst = r.integers(0, 30, 400), r.integers(0, 30, 400)
    src = np.where(src == dst, (dst + 1) % 30, src)
    t = r.integers(0, 50, 400) * 1000 + 7
    pick = r.integers(0, 400, dups)
    src, dst, t = (np.concatenate([a, a[pick]]) for a in (src, dst, t))
    _fields_equal(TemporalGraph.from_edges(src, dst, t),
                  RG.from_edges(src, dst, t))


def test_device_arrays_dtypes_match_the_reference():
    kw = GENERATORS[0][1]
    ref = rgraphs.powerlaw_temporal_graph(**kw).device_arrays()
    got = tgraphs.powerlaw_temporal_graph(**kw).device_arrays("cpu")
    assert set(got) == set(ref)
    for k in ref:
        want = np.asarray(ref[k])
        have = got[k].numpy()
        assert str(want.dtype) == str(have.dtype), k
        assert np.array_equal(have, want), k
    assert int(got["m_real"]) == got["t"].shape[0]


def test_motif_catalog_matches():
    assert sorted(tmotif.MOTIFS) == sorted(rmotif.MOTIFS)
    for name, m in rmotif.MOTIFS.items():
        t = tmotif.get_motif(name)
        assert (t.num_vertices, t.edges) == (m.num_vertices, m.edges)
    spec = "0-1,1-2,2-0,0-3"
    assert tmotif.get_motif(spec).edges == rmotif.get_motif(spec).edges


def _tree_key(tree):
    return (tree.edge_ids, tree.root, tree.parent,
            tuple(tuple((d.child, d.meet_end, d.alpha, d.beta,
                         d.child_far_end) for d in ds) for ds in tree.deps),
            tree.height, tree.topo_down, tree.vertex_source)


@pytest.mark.parametrize("name", sorted(rmotif.MOTIFS))
def test_catalog_trees_match(name):
    rm, tm = rmotif.get_motif(name), tmotif.get_motif(name)
    for fn in ("candidate_trees", "all_rooted_trees"):
        want = [_tree_key(t) for t in getattr(rst, fn)(rm)]
        got = [_tree_key(t) for t in getattr(tst, fn)(tm)]
        assert got == want, fn
    for a, b in zip(tst.candidate_trees(tm), rst.candidate_trees(rm)):
        sa, sb = tst.tree_signature(a), rst.tree_signature(b)
        assert sa[:3] == sb[:3] and sa[4:] == sb[4:]
        assert tst.constraint_looseness(tm, a.edge_ids) == \
            rst.constraint_looseness(rm, b.edge_ids)


def test_device_arrays_land_on_the_requested_device():
    g = tgraphs.powerlaw_temporal_graph(n=50, m=300, time_span=3000, seed=1)
    dev = g.device_arrays(torch.device("cpu"))
    assert all(v.device.type == "cpu" for v in dev.values())
