"""The port's telemetry layer (``repro_torch.obs``) against the JAX
package's.

* the same registry operations give byte-equal Prometheus text in both
  packages; histogram bucket math and ``CounterBlock`` semantics match;
* estimates (solo and cohort-fused) are bit-identical to the
  reference's at every level, ``off`` records nothing, ``metrics``
  feeds the stage histograms but not the ring;
* spans nest and inherit their trace; the flight recorder wraps around;
* ``serve_loop``'s ``metrics``, ``trace`` and ``profile`` verbs answer,
  and an armed profile on the CPU writes a Chrome trace file.
"""
from __future__ import annotations

import io
import json
import os

import pytest

from repro import obs as robs
from repro.core.batch import estimate_many as ref_estimate_many
from repro.core.estimator import estimate as ref_estimate
from repro.core.motif import get_motif as rmotif
from repro.graphs import powerlaw_temporal_graph as rgraph
from repro.obs import registry as rregistry
from repro_torch import (estimate, estimate_many, get_motif, obs,
                         powerlaw_temporal_graph)
from repro_torch.api import EstimateConfig, Request, Session, serve_loop
from repro_torch.core import engine
from repro_torch.obs import registry

GRAPH = dict(n=150, m=2000, time_span=40000, seed=11)
DELTA, CHUNK = 3000, 256
RESULT = ("estimate", "W", "k", "valid", "cnt2_sum", "fail_vmap",
          "fail_delta", "fail_order", "overflow", "tree_edges")


@pytest.fixture(autouse=True)
def _obs_restore():
    """Every test leaves both packages at ``off`` with empty rings."""
    yield
    obs.set_level(None)
    obs.set_ring(4096)
    obs.RECORDER.clear()
    robs.set_level(None)
    robs.RECORDER.clear()


@pytest.fixture(scope="module")
def graphs():
    return rgraph(**GRAPH), powerlaw_temporal_graph(**GRAPH)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
def _script(reg_mod, variant: int) -> str:
    """One sequence of registry operations, run on a fresh registry of
    ``reg_mod``; returns its Prometheus text."""
    reg = reg_mod.Registry()
    c = reg.counter("t_total", "a counter")
    c.inc(3)
    reg.gauge("t_rate", "a gauge").set(2.5 * variant)
    fam = reg.histogram("t_seconds", "a histogram", labels=("tenant",))
    for i, dt in enumerate((0.0, 1e-6, 3e-6, 0.5, 1e9)[:2 + variant]):
        fam.labels(tenant='we"ird\\name' if i % 2 else "b").observe(dt)
    reg.histogram("u_seconds").observe(7e-4 * variant)
    lab = reg.counter("t_events_total", "", labels=("cache", "event"))
    lab.labels(cache="w", event="hit").inc(variant)
    lab.labels(cache="a", event="miss").inc()

    class Block(reg_mod.CounterBlock):
        _PREFIX = "t_block"
        _FIELDS = ("hits", "misses")
        _DOCS = {"hits": "hits seen"}

    b = Block(reg)
    b.hits += variant
    b.misses = 4
    return reg.prometheus_text()


@pytest.mark.parametrize("variant", [0, 1, 3])
def test_prometheus_text_byte_equal_to_the_reference(variant):
    got = _script(registry, variant)
    assert got == _script(rregistry, variant)
    assert got.endswith("\n") and "# TYPE t_seconds histogram" in got


def test_histogram_bucket_math_equals_the_reference():
    assert registry.BUCKET_BOUNDS == rregistry.BUCKET_BOUNDS
    assert registry.N_BUCKETS == len(registry.BUCKET_BOUNDS) + 1
    for dt in (0.0, 1e-6, 1.0000001e-6, 2e-6, 0.3, 67.1, 1e9,
               registry.BUCKET_BOUNDS[-1]):
        assert registry.Histogram.bucket_index(dt) \
            == rregistry.Histogram.bucket_index(dt)
    h = registry.Histogram("t_seconds")
    for dt in (0.0, 1e-6, 3e-6, 0.5, 1e9):
        h.observe(dt)
    snap = h.snapshot()
    assert sum(snap["counts"]) == h.count == 5
    assert snap["sum"] == pytest.approx(1e9 + 0.5 + 4e-6)
    assert snap["counts"][-1] == 1          # the 1e9 outlier


def test_counterblock_semantics():
    class Block(registry.CounterBlock):
        _PREFIX = "t_block"
        _FIELDS = ("hits", "misses")

    reg = registry.Registry()
    b = Block(reg)
    b.hits += 1
    b.hits += 2
    b.misses = 5                       # upward assignment = increment
    assert b.hits == 3 and b.misses == 5
    assert b.as_dict() == {"hits": 3, "misses": 5}
    assert Block(reg).hits == 3        # two blocks are views of one set
    b.hits = 1                         # downward assignment = test reset
    assert b.hits == 1
    b.reset()
    assert b.as_dict() == {"hits": 0, "misses": 0}
    with pytest.raises(AttributeError):
        b.nope = 1
    with pytest.raises(ValueError):
        reg.counter("t_block_hits_total").inc(-1)
    # the port's facades are registry series, with the reference's names
    text = obs.REGISTRY.prometheus_text()
    for name in ("repro_engine_dispatches_total",
                 "repro_resilience_retries_total",
                 "repro_engine_witness_chunks_total",
                 "repro_engine_witness_seconds_total"):
        assert f"# TYPE {name} counter" in text


# ---------------------------------------------------------------------------
# bit-identity across levels
# ---------------------------------------------------------------------------
def test_estimates_bit_identical_at_every_level(graphs):
    rg, g = graphs
    jobs = [("M4-1", DELTA, 512), ("M4-4", DELTA, 512)]
    want_solo = ref_estimate(rg, rmotif("M4-2"), DELTA, 1024, seed=0,
                             chunk=CHUNK)
    want_many = ref_estimate_many(rg, jobs, seed=0, chunk=CHUNK)
    for lvl in ("off", "metrics", "trace"):
        obs.set_level(lvl)
        solo = estimate(g, get_motif("M4-2"), DELTA, 1024, seed=0,
                        chunk=CHUNK, device="cpu")
        many = estimate_many(g, jobs, seed=0, chunk=CHUNK, device="cpu")
        for got, want in zip([solo, *many], [want_solo, *want_many]):
            assert all(getattr(got, f) == getattr(want, f)
                       for f in RESULT), (lvl, got.motif)
            assert got.mesh_shape is None and want.mesh_shape is None
        assert many[0].fused_jobs == want_many[0].fused_jobs == 2


def _stage_count() -> int:
    return sum(c.count for c in
               obs.REGISTRY.get("repro_stage_seconds").children())


def test_off_records_nothing_and_metrics_skips_the_ring(graphs):
    _, g = graphs
    obs.set_level("off")
    obs.RECORDER.clear()
    n0, d0 = _stage_count(), engine.STATS.dispatches
    estimate(g, get_motif("M4-2"), DELTA, 512, seed=0, chunk=CHUNK,
             device="cpu")
    assert len(obs.RECORDER) == 0 and obs.RECORDER.recorded == 0
    assert _stage_count() == n0                     # no histograms
    assert engine.STATS.dispatches > d0             # counters always on
    obs.set_level("metrics")
    with Session(g, EstimateConfig(chunk=CHUNK, device="cpu")) as s:
        s.submit(Request("M4-2", DELTA, 512)).result()
    assert _stage_count() > n0
    assert len(obs.RECORDER) == 0


# ---------------------------------------------------------------------------
# spans and the flight recorder
# ---------------------------------------------------------------------------
def test_span_nesting_and_trace_inheritance():
    obs.set_level("trace")
    obs.RECORDER.clear()
    tid = obs.new_trace()
    assert len(tid) == 16 and tid != obs.new_trace()
    with obs.trace_context(tid):
        with obs.span("outer") as a:
            with obs.span("inner") as b:
                assert b.parent_id == a.span_id
                assert a.trace == b.trace == tid
            obs.event("point", k=1)
    recs = obs.RECORDER.records()
    by_name = {r["name"]: r for r in recs}
    assert by_name["inner"]["parent"] == by_name["outer"]["span"]
    assert by_name["outer"]["parent"] == 0
    assert {r["trace"] for r in recs} == {tid}
    assert by_name["point"]["dur_s"] == 0.0
    assert by_name["point"]["attrs"] == {"k": 1}
    assert recs.index(by_name["inner"]) < recs.index(by_name["outer"])


def test_flight_recorder_ring_wraps_around():
    r = obs.FlightRecorder(4)
    for i in range(10):
        r.append({"name": f"s{i}"})
    assert len(r) == 4 and r.recorded == 10
    assert [x["name"] for x in r.records()] == ["s6", "s7", "s8", "s9"]
    nd = r.export_ndjson()
    assert [json.loads(ln)["name"] for ln in nd.splitlines()] \
        == ["s6", "s7", "s8", "s9"]
    r.clear()
    assert len(r) == 0 and r.recorded == 0 and r.export_ndjson() == ""
    # the process recorder resized in place keeps its newest records
    obs.set_level("trace")
    obs.RECORDER.clear()
    for i in range(6):
        obs.event(f"e{i}")
    obs.set_ring(3)
    assert [x["name"] for x in obs.RECORDER.records()] == ["e3", "e4", "e5"]
    assert obs.summary() == {"level": "trace", "spans": 3, "recorded": 6,
                             "ring": 3}
    with pytest.raises(ValueError):
        obs.set_ring(0)
    with pytest.raises(ValueError):
        obs.set_level("loud")


def test_request_window_trajectory_events(graphs):
    _, g = graphs
    obs.set_level("trace")
    obs.RECORDER.clear()
    with Session(g, EstimateConfig(chunk=CHUNK, checkpoint_every=2,
                                   device="cpu")) as s:
        h = s.submit(Request("M4-2", DELTA, 4 * CHUNK))
        s.flush()
        h.result()
    points = [r for r in obs.RECORDER.records()
              if r["name"] == "request.window"]
    assert [p["attrs"]["k_done"] for p in points] == [2 * CHUNK, 4 * CHUNK]
    assert {p["trace"] for p in points} == {h._trace}
    names = {r["name"] for r in obs.RECORDER.records()
             if r["trace"] == h._trace}
    assert {"session.preprocess", "stage.queue_wait", "session.drain",
            "engine.dispatch", "engine.device"} <= names


# ---------------------------------------------------------------------------
# the serve loop's telemetry verbs
# ---------------------------------------------------------------------------
def test_serve_metrics_trace_and_profile_verbs(graphs, tmp_path):
    _, g = graphs
    obs.set_level("trace")
    obs.RECORDER.clear()
    prof_dir = str(tmp_path / "prof")
    lines = [{"cmd": "profile", "windows": 1},
             {"cmd": "profile", "windows": 1},          # already armed
             {"id": 1, "motif": "M4-2", "delta": DELTA, "k": 512},
             {"cmd": "stats"},
             {"cmd": "metrics"}, {"cmd": "trace"}, {"cmd": "health"},
             {"cmd": "profile", "windows": -1},
             {"cmd": "quit"}]
    out = io.StringIO()
    serve_loop(Session(g, EstimateConfig(chunk=CHUNK, coalesce_window_s=60,
                                         device="cpu")),
               infile=io.StringIO("".join(json.dumps(ln) + "\n"
                                          for ln in lines)),
               outfile=out, profile_dir=prof_dir)
    resp = [json.loads(ln) for ln in out.getvalue().splitlines()]
    profs = [r for r in resp if r.get("cmd") == "profile"]
    assert profs[0] == {"ok": True, "cmd": "profile", "armed": 1,
                        "dir": prof_dir}
    assert profs[1]["ok"] is False and "already armed" in profs[1]["error"]
    assert profs[2]["ok"] is False and ">= 1" in profs[2]["error"]
    status = obs.profile_status()
    assert status["error"] is None and status["captured"] == 1
    assert not status["active"] and status["remaining"] == 0
    assert os.path.dirname(status["file"]) == prof_dir
    with open(status["file"]) as f:
        assert "traceEvents" in json.load(f)
    met = next(r for r in resp if r.get("cmd") == "metrics")
    assert met["ok"] and met["content_type"].startswith("text/plain")
    assert "# TYPE repro_engine_dispatches_total counter" in met["text"]
    assert 'repro_stage_seconds_bucket{stage="dispatch"' in met["text"]
    tr = next(r for r in resp if r.get("cmd") == "trace")
    assert tr["ok"] and tr["level"] == "trace"
    assert tr["count"] == len(tr["spans"]) > 0
    names = {s["name"] for s in tr["spans"]}
    assert {"serve.intake", "session.drain", "engine.dispatch",
            "engine.device", "serve.emit"} <= names
    intake = next(s for s in tr["spans"] if s["name"] == "serve.intake")
    chain = {s["name"] for s in tr["spans"]
             if s["trace"] == intake["trace"]}
    assert {"session.drain", "engine.dispatch", "serve.emit"} <= chain
    health = next(r for r in resp if r.get("cmd") == "health")
    assert health["obs"]["level"] == "trace"
    assert health["obs"]["recorded"] > 0
    assert set(health["resilience"]) == {
        "retries", "ladder_steps", "deadline_degraded", "drain_failures",
        "emit_failures", "wal_records", "wal_replayed"}
    stats = next(r for r in resp if r.get("cmd") == "stats")
    assert stats["obs"]["level"] == "trace"
