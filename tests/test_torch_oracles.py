"""The port's numpy oracles against the live JAX reference's.

``count_exact`` for every registered motif on three smoke graphs and
``list_exact`` on a tiny one, the IS / PRESTO / ES baselines at the same
seeds, and edge-list files written by either package and read by the
other.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro.core import baselines as rbase
from repro.core.exact import count_exact as ref_count_exact
from repro.core.exact import count_exact_from_edge as ref_from_edge
from repro.core.exact import list_exact as ref_list_exact
from repro.core.exact import list_matches_window as ref_window
from repro.core.motif import get_motif as rget
from repro.graphs import er_temporal_graph as r_er
from repro.graphs import fintxn_temporal_graph as r_fintxn
from repro.graphs import load_edge_list as ref_load
from repro.graphs import powerlaw_temporal_graph as r_powerlaw
from repro.graphs import save_edge_list as ref_save
from repro.graphs.loader import iter_edge_batches as ref_batches
from repro_torch import MOTIFS, get_motif
from repro_torch.core import baselines as tbase
from repro_torch.core.exact import (count_exact, count_exact_from_edge,
                                    list_exact, list_matches_window)
from repro_torch.graphs import (er_temporal_graph, fintxn_temporal_graph,
                                iter_edge_batches, load_edge_list,
                                powerlaw_temporal_graph, save_edge_list)

# (name, (reference generator, port generator), kwargs, delta)
GRAPHS = {
    "powerlaw": ((r_powerlaw, powerlaw_temporal_graph),
                 dict(n=60, m=400, time_span=5000, seed=1), 300),
    "er": ((r_er, er_temporal_graph),
           dict(n=40, m=500, time_span=5000, seed=3), 400),
    "fintxn": ((r_fintxn, fintxn_temporal_graph),
               dict(n_accounts=60, m=400, time_span=20000, seed=2), 1000),
}
TINY = dict(n=10, m=24, time_span=300, seed=4)


def _graphs(name):
    (rfn, tfn), kw, delta = GRAPHS[name]
    return rfn(**kw), tfn(**kw), delta


@pytest.fixture(scope="module")
def graphs():
    return {name: _graphs(name) for name in GRAPHS}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("motif", sorted(MOTIFS))
def test_count_exact_equals_reference(graphs, graph, motif):
    rg, tg, delta = graphs[graph]
    got = count_exact(tg, get_motif(motif), delta)
    assert got == ref_count_exact(rg, rget(motif), delta)


def test_count_exact_finds_matches(graphs):
    rg, tg, delta = graphs["powerlaw"]
    assert count_exact(tg, get_motif("M5-3"), delta) > 0


@pytest.mark.parametrize("motif", sorted(MOTIFS))
def test_list_exact_equals_reference(motif):
    rg, tg = r_er(**TINY), er_temporal_graph(**TINY)
    got = list_exact(tg, get_motif(motif), 100)
    assert got == ref_list_exact(rg, rget(motif), 100)
    assert len(got) == count_exact(tg, get_motif(motif), 100)


@pytest.mark.parametrize("motif", ["wedge", "triangle", "M4-2"])
def test_edge_and_window_subroutines_equal_reference(graphs, motif):
    rg, tg, delta = graphs["er"]
    for e in range(0, tg.m, 37):
        assert count_exact_from_edge(tg, get_motif(motif), delta, e) == \
            ref_from_edge(rg, rget(motif), delta, e)
    assert list_matches_window(tg, get_motif(motif), delta, 1000, 2500) == \
        ref_window(rg, rget(motif), delta, 1000, 2500)


BASELINES = [("is_estimate", dict(c=10.0, p=0.5)),
             ("presto_estimate", dict(variant="A", r=12)),
             ("presto_estimate", dict(variant="E", r=12)),
             ("es_estimate", dict(p=0.3))]


@pytest.mark.parametrize("fn,kw", BASELINES,
                         ids=["IS", "PRESTO-A", "PRESTO-E", "ES"])
@pytest.mark.parametrize("motif", ["wedge", "triangle", "M4-2"])
@pytest.mark.parametrize("seed", [0, 5])
def test_baselines_equal_reference_at_the_same_seed(graphs, fn, kw, motif,
                                                    seed):
    rg, tg, delta = graphs["er"]
    got = getattr(tbase, fn)(tg, get_motif(motif), delta, seed=seed, **kw)
    want = getattr(rbase, fn)(rg, rget(motif), delta, seed=seed, **kw)
    assert (got.name, got.estimate, got.windows) == \
        (want.name, want.estimate, want.windows)


def _assert_same_graph(got, want):
    """Every field of ``got``'s graph type (the reference's type has a
    few more, for padded stream snapshots) equals ``want``'s."""
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert np.array_equal(a, b) and a.dtype == b.dtype, f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("suffix", [".txt", ".txt.gz", ".npz"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_edge_list_files_cross_packages(tmp_path, suffix, writer):
    """A file saved by one package's ``save_edge_list`` loads in the
    other (and in itself) to equal arrays, and streams in equal
    batches."""
    rg, tg, _ = _graphs("fintxn")
    path = str(tmp_path / f"edges{suffix}")
    if writer == "reference":
        ref_save(rg, path)
    else:
        save_edge_list(tg, path)
    got, want = load_edge_list(path, cache=False), ref_load(path, cache=False)
    _assert_same_graph(got, want)
    _assert_same_graph(got, tg)
    for a, b in zip(iter_edge_batches(path, 97), ref_batches(path, 97),
                    strict=True):
        for x, y in zip(a, b):
            assert np.array_equal(x, y) and x.dtype == y.dtype


def test_text_load_caches_an_npz_the_reference_reads(tmp_path):
    rg, tg, _ = _graphs("er")
    path = str(tmp_path / "edges.txt")
    save_edge_list(tg, path)
    load_edge_list(path)                       # writes edges.txt.npz
    _assert_same_graph(ref_load(path + ".npz"), rg)


def test_edge_batches_refuse_what_the_reference_refuses(tmp_path):
    path = tmp_path / "bad.txt"
    path.write_text("# comment\n0 1 5\n\n1 2\n")
    for reader in (iter_edge_batches, ref_batches):
        with pytest.raises(ValueError, match="need 'src dst t' columns"):
            list(reader(str(path)))
        with pytest.raises(ValueError, match="batch_size must be >= 1"):
            list(reader(str(path), 0))
