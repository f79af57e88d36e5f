"""The port's telemetry layer (``repro_torch.obs``) against the JAX
package's.

* the same registry operations give byte-equal Prometheus text in both
  packages; histogram bucket math and ``CounterBlock`` semantics match;
* estimates (solo and cohort-fused) are bit-identical to the
  reference's at every level, ``off`` records nothing, ``metrics``
  feeds the stage histograms but not the ring;
* at ``trace`` a two-lane cohort records each chunk's stage spans
  (``sampler.draw``, one ``validate.lane`` a lane) under
  ``engine.device``; below ``trace`` none
  is opened and no CUDA event made; a stage's device time is read, and
  its record appended, only when its window closes, and a failed
  window's stages carry the error instead;
* every record's ``ts_ns`` is on ``torch.profiler``'s clock: profiler
  markers opened inside spans fall within them;
* spans nest and inherit their trace; the flight recorder wraps around;
* ``serve_loop``'s ``metrics``, ``trace`` and ``profile`` verbs answer,
  and an armed profile on the CPU writes a Chrome trace file.
"""
from __future__ import annotations

import io
import json
import os
import time
from contextlib import nullcontext

import pytest
import torch

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
#: one tree cohort of two lanes on GRAPH, two chunks a job
COHORT = [("M4-1", DELTA, 2 * CHUNK), ("M4-4", DELTA, 2 * CHUNK)]
STAGES = ("sampler.draw", "validate.lane")


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
                 "repro_engine_witness_seconds_total",
                 "repro_engine_samples_drawn_total"):
        assert f"# TYPE {name} counter" in text
    assert "repro_sampler_samples_per_s" not in text


# ---------------------------------------------------------------------------
# bit-identity across levels
# ---------------------------------------------------------------------------
def test_estimates_bit_identical_at_every_level(graphs):
    rg, g = graphs
    want_solo = ref_estimate(rg, rmotif("M4-2"), DELTA, 1024, seed=0,
                             chunk=CHUNK)
    want_many = ref_estimate_many(rg, COHORT, seed=0, chunk=CHUNK)
    for lvl in ("off", "metrics", "trace"):
        obs.set_level(lvl)
        obs.RECORDER.clear()
        solo = estimate(g, get_motif("M4-2"), DELTA, 1024, seed=0,
                        chunk=CHUNK, device="cpu")
        many = estimate_many(g, COHORT, seed=0, chunk=CHUNK, device="cpu")
        for got, want in zip([solo, *many], [want_solo, *want_many]):
            assert all(getattr(got, f) == getattr(want, f)
                       for f in RESULT), (lvl, got.motif)
            assert got.mesh_shape is None and want.mesh_shape is None
        assert many[0].fused_jobs == want_many[0].fused_jobs == 2
        lanes = [r for r in obs.RECORDER.records()
                 if r["name"] == "validate.lane"]
        # the cohort's two lanes over two chunks, plus the solo's lane
        assert len(lanes) == (2 * 2 + 1024 // CHUNK
                              if lvl == "trace" else 0)


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
# the stages of an engine chunk
# ---------------------------------------------------------------------------
def test_cohort_stage_spans_nest_under_engine_device(graphs):
    _, g = graphs
    obs.set_level("trace")
    obs.RECORDER.clear()
    drawn = engine.STATS.samples_drawn
    many = estimate_many(g, COHORT, seed=0, chunk=CHUNK, device="cpu")
    assert many[0].fused_jobs == 2
    # one stream (one seed), two chunks of CHUNK samples, at every level
    assert engine.STATS.samples_drawn - drawn == 2 * CHUNK
    recs = obs.RECORDER.records()
    device = {r["span"]: r for r in recs if r["name"] == "engine.device"}
    stages = [r for r in recs if r["name"] in STAGES]
    got = sorted((r["attrs"]["chunk"], r["name"], r["attrs"].get("lane"),
                  r["attrs"].get("motif")) for r in stages)
    want = sorted([(c, "sampler.draw", None, None) for c in (0, 1)]
                  + [(c, "validate.lane", lane, m) for c in (0, 1)
                     for lane, m in enumerate(("M4-1", "M4-4"))])
    assert got == want
    for r in stages:
        parent = device[r["parent"]]
        assert r["trace"] == parent["trace"] and "device_ms" not in r
        end = r["ts_ns"] + round(r["dur_s"] * 1e9)
        assert parent["ts_ns"] - 1000 <= r["ts_ns"] <= end \
            <= parent["ts_ns"] + round(parent["dur_s"] * 1e9) + 1000
    # within a chunk the stages run in order
    for c in (0, 1):
        order = [r["name"] for r in sorted(stages, key=lambda r: r["ts_ns"])
                 if r["attrs"]["chunk"] == c]
        assert order == ["sampler.draw", "validate.lane", "validate.lane"]


@pytest.mark.parametrize("lvl", ["off", "metrics"])
def test_no_stage_span_or_cuda_event_below_trace(graphs, monkeypatch, lvl):
    _, g = graphs

    def refuse(*args, **kwargs):
        raise AssertionError("a stage span or CUDA event below trace")

    monkeypatch.setattr(obs.trace, "DeviceStages", refuse)
    monkeypatch.setattr(obs.trace, "DeviceSpan", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    obs.set_level(lvl)
    obs.RECORDER.clear()
    many = estimate_many(g, COHORT, seed=0, chunk=CHUNK, device="cpu")
    assert many[0].fused_jobs == 2
    assert len(obs.RECORDER) == 0 and obs.RECORDER.recorded == 0


class _FakeStream:
    device_index = 0


class _FakeEvent:
    """A CUDA timing event stand-in: ``elapsed_time`` is the number of
    records made between the two."""

    made = []
    clock = [0]

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.at = None
        _FakeEvent.made.append(self)

    def record(self, stream=None):
        assert isinstance(stream, _FakeStream)
        _FakeEvent.clock[0] += 1
        self.at = _FakeEvent.clock[0]

    def elapsed_time(self, end):
        return float(end.at - self.at)


def _one_window(fail: bool) -> dict:
    """One window's two nested stages on a (faked) card, failing at its
    host copy when ``fail``; the records by name."""
    obs.RECORDER.clear()
    card = torch.device("cuda", 0)          # never touched: events faked
    with pytest.raises(RuntimeError) if fail else nullcontext():
        with obs.span("engine.device") as outer:
            with obs.device_stages():
                obs.stages_at(card, 7)
                with obs.stage("sampler.draw"):
                    with obs.stage("validate.lane", lane=0, motif="M4-1"):
                        pass
                assert len(obs.RECORDER) == 0   # held until the close
                if fail:
                    raise RuntimeError("the window's host copy failed")
    recs = {r["name"]: r for r in obs.RECORDER.records()}
    assert list(recs) == ["validate.lane", "sampler.draw", "engine.device"]
    assert recs["sampler.draw"]["parent"] == outer.span_id
    return recs


@pytest.mark.parametrize("fail", [False, True])
def test_device_stages_read_events_when_the_window_closes(monkeypatch,
                                                          fail):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: _FakeStream())
    monkeypatch.setattr(obs.trace, "_EVENT_PAIRS", {})
    _FakeEvent.made.clear()
    obs.set_level("trace")
    recs = _one_window(fail)
    assert len(_FakeEvent.made) == 4
    lane, draw = recs["validate.lane"], recs["sampler.draw"]
    assert lane["attrs"] == {"chunk": 7, "lane": 0, "motif": "M4-1"}
    assert draw["attrs"] == {"chunk": 7}
    assert lane["parent"] == draw["span"]
    if fail:
        assert lane["error"] == draw["error"] == "RuntimeError"
        assert "device_ms" not in lane and "device_ms" not in draw
        assert obs.trace._EVENT_PAIRS == {}      # a failed window's dropped
    else:
        assert "error" not in lane
        assert (draw["device_ms"], lane["device_ms"]) == (3.0, 1.0)
        # the next window reuses the read events and creates none
        again = _one_window(False)
        assert len(_FakeEvent.made) == 4
        assert again["sampler.draw"]["device_ms"] == 3.0


def test_stage_outside_an_engine_attempt_opens_nothing():
    """At ``trace``, a sampler or count fn called outside an engine
    attempt (no ``obs.trace.DeviceStages`` open on the thread) opens no
    stage span; an owner open on another thread is not this one's."""
    import threading
    obs.set_level("trace")
    obs.RECORDER.clear()
    with obs.stage("sampler.draw"):
        pass
    seen = []
    with obs.device_stages():
        t = threading.Thread(
            target=lambda: seen.append(obs.stage("validate.lane")))
        t.start()
        t.join()
    assert seen == [obs.trace._NO_SPAN] and len(obs.RECORDER) == 0


def test_profile_capture_reanchors_the_clock(monkeypatch, tmp_path):
    """Each armed capture takes a fresh anchor as its profiler starts,
    so a capture armed long after the level became ``trace`` is not
    matched through a drifted ``time_ns``."""
    calls = []
    anchor = obs.trace.set_anchor
    monkeypatch.setattr(obs.trace, "set_anchor",
                        lambda: calls.append(1) or anchor())
    obs.arm_profile(1, str(tmp_path))
    obs.profile_window_start()
    assert calls == [1]
    obs.profile_window_end()
    assert obs.profile_status()["captured"] == 1


def test_spans_hold_their_profiler_markers_on_ts_ns():
    """``ts_ns`` is on the profiler's clock: a ``record_function`` marker
    opened inside a span lies within ``[ts_ns, ts_ns + dur]``, to 20 µs,
    in the events ``torch.profiler`` stamps."""
    from torch.profiler import ProfilerActivity, profile, record_function
    obs.set_level("trace")
    obs.RECORDER.clear()
    assert abs(obs.profiler_ns(obs.perf_counter()) - time.time_ns()) < 1e6
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(40):
            with obs.span("clock.check", i=i):
                with record_function(f"clock.marker.{i}"):
                    torch.zeros(64).add_(1)
    spans = {r["attrs"]["i"]: r for r in obs.RECORDER.records()}
    marks = {int(e.name().rsplit(".", 1)[1]):
             (e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("clock.marker.")}
    assert sorted(marks) == sorted(spans) == list(range(40))
    slack = 20_000
    for i, (a, b) in marks.items():
        lo = spans[i]["ts_ns"]
        hi = lo + round(spans[i]["dur_s"] * 1e9)
        assert lo - slack <= a <= b <= hi + slack, (i, a - lo, hi - b)


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
    assert "\nrepro_engine_samples_drawn_total " in met["text"]
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
