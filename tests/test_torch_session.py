"""The port's ``Session`` against the live JAX reference's.

The same requests, submitted the same way, give the reference's
results, per-window ``Progress`` snapshots, adaptive growth and session
counters field for field; an expired deadline gives the reference's
degraded partial, and every ``Request`` check raises as the
reference's does.
"""
from __future__ import annotations

import math

import pytest

from repro.api import EstimateConfig as RConfig
from repro.api import Request as RRequest
from repro.api import Session as RSession
from repro.graphs import powerlaw_temporal_graph as rgraph
from repro_torch import powerlaw_temporal_graph
from repro_torch.api import EstimateConfig, Request, Session

GRAPH = dict(n=150, m=2000, time_span=40000, seed=11)
CFG = dict(chunk=256, checkpoint_every=1, coalesce_window_s=3600.0)
REQUESTS = [dict(motif="M5-3", delta=3000, k=1024),
            dict(motif="M5-2", delta=3000, k=1024, seed=1),
            dict(motif="0-1,1-2,2-0", delta=3000, k=512),
            dict(motif="M4-2", delta=2000, k=768, seed=3),
            dict(motif="M4-2", delta=3000, k=512, target_rse=1e-3,
                 k_max=4096)]
FIELDS = ("estimate", "W", "k", "cnt2_sum", "valid", "fail_vmap",
          "fail_delta", "fail_order", "overflow", "tree_edges", "delta",
          "motif", "fused_jobs", "degraded", "degrade_reason", "rse")
PROGRESS = ("window", "k_done", "cnt2_sum", "estimate", "rse")
SESSION_STATS = ("submitted", "completed", "drains", "dispatches",
                 "adaptive_rounds")


def _run(session_cls, config_cls, request_cls, g, **cfg):
    s = session_cls(g, config_cls(**CFG, **cfg))
    handles = [s.submit(request_cls(**r)) for r in REQUESTS]
    results = [h.result() for h in handles]
    return dict(
        results=results,
        progress=[[tuple(getattr(p, f) for f in PROGRESS) for p in h.stream()]
                  for h in handles],
        rse=[h.rse for h in handles], windows=[h.windows for h in handles],
        stats={f: getattr(s.stats, f) for f in SESSION_STATS},
        planner=(s.planner.preprocess_calls, s.planner.preprocess_hits))


@pytest.fixture(scope="module")
def reference():
    return _run(RSession, RConfig, RRequest, rgraph(**GRAPH))


@pytest.fixture(scope="module")
def port():
    return _run(Session, EstimateConfig, Request,
                powerlaw_temporal_graph(**GRAPH), device="cpu")


@pytest.mark.parametrize("i", range(len(REQUESTS)))
def test_results_match_reference(reference, port, i):
    got, want = port["results"][i], reference["results"][i]
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.sampler_backend == "cpu" and got.fallback_reason == ""


@pytest.mark.parametrize("i", range(len(REQUESTS)))
def test_stream_progress_matches_reference(reference, port, i):
    assert port["progress"][i] == reference["progress"][i]
    assert port["windows"][i] == reference["windows"][i]
    assert port["rse"][i] == reference["rse"][i]
    last = port["progress"][i][-1]
    assert last[1] == port["results"][i].k
    assert last[2] == port["results"][i].cnt2_sum


def test_adaptive_growth_matches_reference(reference, port):
    got, want = port["results"][-1], reference["results"][-1]
    assert got.k == want.k and got.k > REQUESTS[-1]["k"]
    assert got.rse <= REQUESTS[-1]["target_rse"] or got.k == 4096
    assert port["stats"]["adaptive_rounds"] == \
        reference["stats"]["adaptive_rounds"] > 0


def test_session_counters_match_reference(reference, port):
    assert port["stats"] == reference["stats"]
    assert port["planner"] == reference["planner"]
    assert port["stats"]["drains"] == 1        # one coalesced window


def test_expired_deadline_gives_the_reference_degraded_partial():
    kw = dict(motif="M5-3", delta=3000, k=1024, deadline_s=1e-9)
    cfg = dict(chunk=256)
    want = RSession(rgraph(**GRAPH), RConfig(**cfg)).submit(
        RRequest(**kw)).result()
    got = Session(powerlaw_temporal_graph(**GRAPH),
                  EstimateConfig(device="cpu", **cfg)).submit(
        Request(**kw)).result()
    assert want.degraded and want.k == 0
    for f in FIELDS:
        want_f, got_f = getattr(want, f), getattr(got, f)
        if f == "rse":
            assert math.isinf(got_f) and math.isinf(want_f)
        else:
            assert got_f == want_f, f


def test_count_closed_windows_match_reference():
    """``coalesce_max_requests`` closes a window mid-stream in both."""
    def run(session_cls, config_cls, request_cls, g, **kw):
        s = session_cls(g, config_cls(chunk=256, coalesce_window_s=3600.0,
                                      coalesce_max_requests=2, **kw))
        hs = [s.submit(request_cls(**r)) for r in REQUESTS[:3]]
        pending_after = s.window_age() is not None
        s.flush()
        return ([(h.result().cnt2_sum, h.result().fused_jobs) for h in hs],
                {f: getattr(s.stats, f) for f in SESSION_STATS},
                pending_after)
    want = run(RSession, RConfig, RRequest, rgraph(**GRAPH))
    got = run(Session, EstimateConfig, Request,
              powerlaw_temporal_graph(**GRAPH), device="cpu")
    assert got == want and got[1]["drains"] == 2


BAD_REQUESTS = [dict(k=0), dict(k=-3), dict(delta=-1),
                dict(target_rse=0.0), dict(target_rse=-0.5),
                dict(k=512, k_max=256), dict(deadline_s=0.0),
                dict(deadline_s=-1.0), dict(witnesses=-1),
                dict(witnesses=65)]


@pytest.mark.parametrize("bad", BAD_REQUESTS,
                         ids=[",".join(f"{k}={v}" for k, v in b.items())
                              for b in BAD_REQUESTS])
def test_request_checks_raise_as_the_reference(bad):
    kw = dict(dict(motif="M5-3", delta=3000, k=1024), **bad)
    with pytest.raises(Exception) as want:
        RRequest(**kw)
    with pytest.raises(Exception) as got:
        Request(**kw)
    assert type(got.value) is type(want.value) is ValueError
    assert str(got.value) == str(want.value)


def test_witnesses_are_refused_until_their_slice():
    """Named for what it checked before the port had witnesses: a
    request with ``witnesses`` is now accepted, as the reference's, and
    answers the reference's witness entries (here per window too)."""
    req = dict(motif="M5-3", delta=3000, k=1024, witnesses=3)
    want = RSession(rgraph(**GRAPH), RConfig(**CFG)).submit(RRequest(**req))
    got = Session(powerlaw_temporal_graph(**GRAPH),
                  EstimateConfig(**CFG, device="cpu")).submit(Request(**req))
    assert got.result().witnesses == want.result().witnesses
    assert len(got.result().witnesses) == 3
    assert [p.witnesses for p in got.stream()] == \
        [p.witnesses for p in want.stream()]


def test_closed_session_refuses_submits_as_the_reference():
    for session_cls, config_cls, request_cls, g, kw in (
            (RSession, RConfig, RRequest, rgraph(**GRAPH), {}),
            (Session, EstimateConfig, Request,
             powerlaw_temporal_graph(**GRAPH), dict(device="cpu"))):
        s = session_cls(g, config_cls(chunk=256, **kw))
        assert s.window_age() is None
        s.close()
        with pytest.raises(RuntimeError, match="Session is closed"):
            s.submit(request_cls(motif="M5-3", delta=3000, k=256))
        with pytest.raises(RuntimeError, match="Session is closed"):
            s.submit_many([])


def test_config_checks_the_device():
    assert EstimateConfig(device="cpu").resolve().device == "cpu"
    assert EstimateConfig().device == "cuda"
    with pytest.raises(RuntimeError):
        EstimateConfig(device="nonsense").resolve()
