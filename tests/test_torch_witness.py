"""Witness capture: the port against the reference.

``splitmix64`` and ``witness_priority`` give the reference's uint64
bits (seeds near 2^63 included); a chunk's witness reservoir, a witness
window and the witness entries of M5-3 and M4-2 equal the reference's;
the same witnesses come out of a solo request, a tree cohort and an
adaptive request at the same final budget; every witness satisfies its
motif on the host, and none is a pad edge of a padded snapshot.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.api  # noqa: F401  (turns on jax x64 and loads the engine)
from repro.api import EstimateConfig as RConfig
from repro.api import Request as RRequest
from repro.api import Session as RSession
from repro.core import engine as rengine
from repro.core import sampler as rsampler
from repro.core.batch import BatchPlanner as RPlanner
from repro.core.motif import get_motif as rget
from repro.graphs import powerlaw_temporal_graph as rgraph
from repro.resilience.retry import _splitmix64 as host_splitmix64
from repro_torch import BatchPlanner, get_motif, powerlaw_temporal_graph
from repro_torch.api import EstimateConfig, Request, Session
from repro_torch.core import engine, rng, sampler
from repro_torch.core.graph import pad_snapshot
from repro_torch.testing import witness_edge_ids

GRAPH = dict(n=150, m=2000, time_span=40000, seed=11)
CFG = dict(chunk=256, checkpoint_every=2)
CASES = [("M5-3", 3000, 1024, 0), ("M4-2", 3000, 512, 3)]
U64 = [0, 1, 2, 12345, 2 ** 32 - 1, 2 ** 32, 2 ** 62 + 11, 2 ** 63 - 2,
       2 ** 63 - 1, 2 ** 63, 2 ** 63 + 1, 2 ** 64 - 1,
       0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9]


@pytest.fixture(scope="module")
def graphs():
    return rgraph(**GRAPH), powerlaw_temporal_graph(**GRAPH)


def _bits(values) -> torch.Tensor:
    return torch.tensor([v - 2 ** 64 if v >= 2 ** 63 else v
                         for v in values], dtype=torch.int64)


def test_splitmix64_equals_reference_bits():
    r = np.random.default_rng(0)
    values = U64 + [int(x) for x in r.integers(0, 2 ** 63, 500)] + \
        [int(x) + 2 ** 63 for x in r.integers(0, 2 ** 63, 500)]
    got = sampler.splitmix64(_bits(values)).numpy().view(np.uint64)
    want = np.asarray(rsampler.splitmix64(jnp.asarray(
        np.array(values, dtype=np.uint64))))
    assert np.array_equal(got, want)
    assert [int(x) for x in got[:len(U64)]] == [host_splitmix64(v)
                                                for v in U64]


@pytest.mark.parametrize("seed", [0, 3, 2 ** 31, 2 ** 63 - 1, 2 ** 63,
                                  2 ** 63 + 7, 2 ** 64 - 1])
@pytest.mark.parametrize("j", [0, 5, 2 ** 32 + 1])
def test_witness_priority_equals_reference(seed, j):
    got = sampler.witness_priority(seed, j, 1000).numpy()
    want = np.asarray(rsampler.witness_priority(seed, j, 1000))
    assert got.dtype == want.dtype == np.int64
    assert np.array_equal(got, want)
    assert 0 <= got.min() and got.max() < sampler.WITNESS_SENTINEL


def _planned(graphs, motif, delta):
    rg, tg = graphs
    rtree, rwts = RPlanner(rg).plan(rget(motif), delta)
    planner = BatchPlanner(tg, device="cpu")
    ttree, twts = planner.plan(get_motif(motif), delta)
    return (rtree, rwts, rg.device_arrays()), (ttree, twts, planner.dev)


@pytest.mark.parametrize("motif,delta,k,seed", CASES)
def test_chunk_reservoir_and_window_equal_reference(graphs, motif, delta, k,
                                                    seed):
    """``make_witness_fn`` on one chunk key and the witness window over
    three chunks (width 8) give the reference's rows, sentinels and
    their stable order included."""
    (rtree, rwts, rdev), (ttree, twts, tdev) = _planned(graphs, motif, delta)
    key = rng.fold_in(rng.PRNGKey(seed), 2)
    rkey = jax.random.fold_in(jax.random.PRNGKey(seed), 2)
    want = rsampler.make_witness_fn(rtree, 256, n_wit=8)(rdev, rwts, rkey,
                                                          2, seed)
    got = sampler.make_witness_fn(ttree, 256, "cpu", n_wit=8)(
        tdev, twts, key, 2, seed)
    wwin = rengine.make_witness_window_fn(rtree, 256, n_wit=8)(
        rdev, rwts, jax.random.PRNGKey(seed), 1, 3, seed)
    gwin = engine.make_witness_window_fn(ttree, 256, 16, 8, "cpu")(
        tdev, twts, rng.PRNGKey(seed), 1, 3, seed)
    for a, b in ((got, want), (gwin, wwin)):
        for f in engine._WIT_KEYS:
            assert np.array_equal(a[f].numpy(), np.asarray(b[f])), f
    assert (gwin["prio"] < sampler.WITNESS_SENTINEL).any()


def _results(session_cls, config_cls, request_cls, g, requests, **cfg):
    s = session_cls(g, config_cls(**CFG, **cfg))
    handles = s.submit_many([request_cls(**r) for r in requests])
    return [h.result() for h in handles], handles


@pytest.mark.parametrize("motif,delta,k,seed", CASES)
def test_witness_entries_equal_reference(graphs, motif, delta, k, seed):
    rg, tg = graphs
    req = [dict(motif=motif, delta=delta, k=k, seed=seed, witnesses=8)]
    (want,), (rh,) = _results(RSession, RConfig, RRequest, rg, req)
    (got,), (th,) = _results(Session, EstimateConfig, Request, tg, req,
                             device="cpu")
    assert got.witnesses == want.witnesses and len(got.witnesses) == 8
    assert (got.cnt2_sum, got.valid) == (want.cnt2_sum, want.valid)
    assert [p.witnesses for p in th.stream()] == \
        [p.witnesses for p in rh.stream()]
    for entry in got.witnesses:
        witness_edge_ids(tg, get_motif(motif), got.tree_edges, delta, entry)


def test_witnesses_do_not_touch_the_count(graphs):
    _, tg = graphs
    req = dict(motif="M4-2", delta=3000, k=512, seed=3)
    (plain,), _ = _results(Session, EstimateConfig, Request, tg, [req],
                           device="cpu")
    engine.STATS.reset()
    (wit,), _ = _results(Session, EstimateConfig, Request, tg,
                         [dict(req, witnesses=3)], device="cpu")
    assert plain.witnesses is None and len(wit.witnesses) == 3
    for f in ("estimate", "W", "k", "cnt2_sum", "valid", "overflow"):
        assert getattr(wit, f) == getattr(plain, f)
    assert engine.STATS.witness_dispatches == 1        # one window of 2
    assert engine.STATS.witness_chunks == 2


def test_cohort_and_adaptive_witnesses_equal_solo(graphs):
    """M5-2/3/4 share one tree signature here: in one cohort each keeps
    its solo witnesses; an adaptive request grown to k = 1024 over
    rounds keeps the witnesses of one run at 1024, as the reference."""
    rg, tg = graphs
    cohort = [dict(motif=m, delta=3000, k=512, seed=s, witnesses=5)
              for m in ("M5-2", "M5-3", "M5-4") for s in (0, 1)]
    fused, _ = _results(Session, EstimateConfig, Request, tg, cohort,
                        device="cpu")
    assert {r.fused_jobs for r in fused} == {6}
    for req, res in zip(cohort, fused):
        (solo,), _ = _results(Session, EstimateConfig, Request, tg, [req],
                              device="cpu")
        assert solo.fused_jobs == 1 and res.witnesses == solo.witnesses
    adaptive = dict(motif="M4-2", delta=3000, k=256, seed=3, witnesses=6,
                    target_rse=1e-6, k_max=1024)
    (grown,), (gh,) = _results(Session, EstimateConfig, Request, tg,
                               [adaptive], device="cpu")
    (want,), (rh,) = _results(RSession, RConfig, RRequest, rg, [adaptive])
    (once,), _ = _results(Session, EstimateConfig, Request, tg,
                          [dict(motif="M4-2", delta=3000, k=1024, seed=3,
                                witnesses=6)], device="cpu")
    assert grown.k == once.k == 1024 and gh.session.stats.adaptive_rounds
    assert grown.witnesses == once.witnesses == want.witnesses
    assert [p.witnesses for p in gh.stream()] == \
        [p.witnesses for p in rh.stream()]


def test_no_pad_edge_is_a_witness(graphs):
    """On a snapshot whose edges are mostly pads the witnesses are those
    of the unpadded graph, every edge id below ``m_real``."""
    _, tg = graphs
    padded = pad_snapshot(tg, m_floor=4096)
    req = [dict(motif="M4-2", delta=3000, k=512, seed=3, witnesses=16)]
    (got,), _ = _results(Session, EstimateConfig, Request, padded, req,
                         device="cpu")
    (want,), _ = _results(Session, EstimateConfig, Request, tg, req,
                          device="cpu")
    assert got.witnesses == want.witnesses and got.witnesses
    for entry in got.witnesses:
        eids = witness_edge_ids(padded, get_motif("M4-2"), got.tree_edges,
                                3000, entry)
        assert max(eids) < padded.live_m < padded.m
