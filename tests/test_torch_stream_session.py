"""The port's ``StreamingSession`` against the reference's.

The same edge batches and standing queries give, epoch by epoch, the
reference's epochs and results: the integer fields and the witness
entries equal, across eviction, segment merges and bucket changes.  Each
epoch's result also equals a cold port ``estimate()`` on the padded
snapshot and on the unpadded retained graph (the epoch determinism
contract).  ``replay_epochs`` reads text, ``.gz`` and ``.npz`` files.
"""
from __future__ import annotations

import numpy as np
import pytest

import repro.api  # noqa: F401  (repro.stream imports through repro.api)
from repro.api import EstimateConfig as RConfig
from repro.graphs.loader import save_edge_list as rsave
from repro.stream import StandingQuery as RQuery
from repro.stream import StreamingSession as RStreaming
from repro.stream import StreamStore as RStore
from repro.stream import replay_edge_list as rreplay_edge_list
from repro_torch import estimate, get_motif, powerlaw_temporal_graph
from repro_torch.api import EstimateConfig, Request
from repro_torch.core.graph import TemporalGraph
from repro_torch.stream import (StandingQuery, StreamingSession,
                                StreamStore, replay_edge_list, replay_epochs)

GRAPH = dict(n=120, m=2400, time_span=60000, seed=5)
N_BATCHES = 4
STORE = dict(horizon=25_000, max_segments=2, min_m_bucket=256,
             min_n_bucket=16, min_p_bucket=64)
CFG = dict(chunk=128, checkpoint_every=2)
QUERIES = [dict(motif="M5-3", delta=3000, k=512, seed=0),
           dict(motif="M4-2", delta=3000, k=384, seed=3, witnesses=4,
                name="m42")]
INT_FIELDS = ("estimate", "W", "k", "cnt2_sum", "valid", "fail_vmap",
              "fail_delta", "fail_order", "overflow", "tree_edges", "delta",
              "motif", "fused_jobs", "witnesses")
EPOCH = ("index", "t_lo", "t_hi", "m_real", "n_real", "evicted",
         "ingested_total", "evicted_total", "buckets")


@pytest.fixture(scope="module")
def batches():
    g = powerlaw_temporal_graph(**GRAPH)
    idx = np.array_split(np.arange(g.m), N_BATCHES)
    return [(g.src[i].astype(np.int64), g.dst[i].astype(np.int64),
             g.t[i].astype(np.int64)) for i in idx]


def _run(session_cls, query_cls, config_cls, batches, **cfg):
    ss = session_cls(config=config_cls(**CFG, **cfg), **STORE)
    for q in QUERIES:
        ss.subscribe(query_cls(**q))
    out = []
    for src, dst, t in batches:
        ss.ingest(src, dst, t)
        out.append(ss.advance())
    stats = ss.stats
    ss.close()
    return out, stats


@pytest.fixture(scope="module")
def reference(batches):
    return _run(RStreaming, RQuery, RConfig, batches)


@pytest.fixture(scope="module")
def port(batches):
    return _run(StreamingSession, StandingQuery, EstimateConfig, batches,
                device="cpu")


@pytest.mark.parametrize("i", range(N_BATCHES))
def test_epoch_equals_reference(reference, port, i):
    got, want = port[0][i], reference[0][i]
    for f in EPOCH:
        assert getattr(got.epoch, f) == getattr(want.epoch, f), f
    assert sorted(got.results) == sorted(want.results) == [0, 1]
    for qid, res in got.results.items():
        for f in INT_FIELDS:
            assert getattr(res, f) == getattr(want.results[qid], f), (qid, f)
        assert res.sampler_backend == "cpu"
    assert got.advance_s >= got.estimate_s > 0


def test_stream_walks_through_eviction_and_buckets(port, reference):
    epochs = [er.epoch for er in port[0]]
    assert sum(e.evicted for e in epochs) > 0
    assert len({e.buckets for e in epochs}) > 1
    assert all(er.results[1].witnesses for er in port[0][1:])
    got, want = port[1], reference[1]
    assert (got.epochs, got.queries_run, got.subscribe_calls) == \
        (want.epochs, want.queries_run, want.subscribe_calls) == \
        (N_BATCHES, 2 * N_BATCHES, 2)


def unpadded(g: TemporalGraph) -> TemporalGraph:
    """The retained graph without its pad suffix (what the store built
    before padding): the snapshot's real edges, rebuilt."""
    m = g.live_m
    return TemporalGraph.from_edges(g.src[:m], g.dst[:m], g.t[:m])


@pytest.mark.parametrize("i", [0, N_BATCHES - 1])
def test_epoch_equals_cold_estimates(port, i):
    er = port[0][i]
    g = er.epoch.graph
    plain = unpadded(g)
    assert plain.m == er.epoch.m_real < g.m
    for qid, q in enumerate(QUERIES):
        for graph in (g, plain):
            cold = estimate(graph, get_motif(q["motif"]), q["delta"],
                            q["k"], seed=q["seed"], chunk=CFG["chunk"],
                            checkpoint_every=CFG["checkpoint_every"],
                            device="cpu")
            for f in INT_FIELDS[:-1]:
                assert getattr(cold, f) == getattr(er.results[qid], f), f


@pytest.mark.parametrize("suffix", [".txt", ".txt.gz", ".npz"])
def test_replay_epochs_reads_every_format(tmp_path, port, suffix):
    """A reference-written edge-list file replays through the port in
    batches: the epochs equal the ones ingested from memory."""
    g = powerlaw_temporal_graph(**GRAPH)
    path = str(tmp_path / f"edges{suffix}")
    rsave(g, path)
    seen = []
    with StreamingSession(config=EstimateConfig(**CFG, device="cpu"),
                          **STORE) as ss:
        ss.subscribe(StandingQuery(**QUERIES[1]))
        batch = -(-g.m // N_BATCHES)
        for er in replay_epochs(ss, path, batch_size=batch, advance_every=2,
                                on_epoch=seen.append):
            assert er is seen[-1]
    assert len(seen) == -(-N_BATCHES // 2)            # a last partial epoch
    for er, want in zip(seen, port[0][1::2]):
        assert er.epoch.m_real == want.epoch.m_real
        res = er.results[0]
        for f in INT_FIELDS:
            assert getattr(res, f) == getattr(want.results[1], f), f


def test_replay_edge_list_fills_the_store_as_the_reference(tmp_path):
    g = powerlaw_temporal_graph(**GRAPH)
    path = str(tmp_path / "edges.npz")
    rsave(g, path)
    got, want = StreamStore(**STORE), RStore(**STORE)
    assert replay_edge_list(got, path, 700) == \
        rreplay_edge_list(want, path, 700) == g.m
    assert got.buffered == want.buffered
    a, b = got.advance(), want.advance()
    assert (a.m_real, a.buckets, a.evicted) == (b.m_real, b.buckets,
                                                b.evicted)
    with pytest.raises(ValueError, match="advance_every must be >= 1"):
        next(replay_epochs(None, path, advance_every=0))


@pytest.mark.parametrize("bad", [dict(k=0), dict(delta=-1),
                                 dict(witnesses=65), dict(witnesses=-1),
                                 dict(motif="no-such-motif")])
def test_standing_query_checks_as_the_reference(bad):
    kw = dict(dict(motif="M5-3", delta=3000, k=64), **bad)
    with pytest.raises(Exception) as want:
        RQuery(**kw)
    with pytest.raises(Exception) as got:
        StandingQuery(**kw)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


def test_session_guards(batches):
    cfg = EstimateConfig(**CFG, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        StreamingSession(StreamStore(), cfg, horizon=5)
    ss = StreamingSession(config=cfg, horizon=1000)
    assert StandingQuery("M5-3", 3000, 64, name="x").label == "x"
    with pytest.raises(RuntimeError, match="no epoch materialized"):
        ss.query(Request("M4-2", 3000, 64))
    with pytest.raises(ValueError, match="empty stream"):
        ss.advance()
    ss.ingest(*batches[0])
    qid = ss.subscribe(StandingQuery("M4-2", 3000, 128))
    er = ss.advance()
    one = ss.query(Request("M4-2", 3000, 128))
    assert one.cnt2_sum == er.results[qid].cnt2_sum
    assert ss.unsubscribe(qid).motif == "M4-2" and ss.queries == {}
    ss.close()
    assert ss.session is None
    for call in (lambda: ss.ingest(1, 2, 3), ss.advance,
                 lambda: ss.subscribe(StandingQuery("M4-2", 3000, 64))):
        with pytest.raises(RuntimeError, match="closed"):
            call()
