"""The port's NDJSON serve loop and CLI.

The same request lines through both packages' ``serve_loop`` give equal
response lines (``sampler_backend`` and ``advance_s`` aside; the
``resilience`` and ``obs`` blocks of ``stats``/``health`` included, both
packages' counters reset first), in plain mode and in stream mode
(``subscribe`` / ``ingest`` / ``advance`` / ``unsubscribe``, witness
payloads included); the telemetry verbs answer the reference's
payloads.  The CLI takes comma lists, edge-list paths, ``--exact``,
``--checkpoint`` and ``--serve``, and in a subprocess ``--serve
--stream`` (with a ``--wal`` restart) and ``--stream-replay``.
"""
from __future__ import annotations

import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro.api import EstimateConfig as RConfig
from repro.api import Session as RSession
from repro.api import serve_loop as ref_serve_loop
from repro.stream import StreamingSession as RStreaming
from repro.core.engine import STATS as RSTATS
from repro.graphs import powerlaw_temporal_graph as rgraph
from repro.obs import RECORDER as R_RECORDER
from repro.resilience.retry import STATS as R_RES_STATS
from repro_torch import (count_exact, estimate, estimate_many, get_motif,
                         powerlaw_temporal_graph, save_edge_list)
from repro_torch.api import EstimateConfig, Session, serve_loop
from repro_torch.core.engine import STATS
from repro_torch.gateway import LineSource
from repro_torch.launch import estimate as cli
from repro_torch.obs import RECORDER
from repro_torch.resilience import STATS as RES_STATS
from repro_torch.stream import StreamingSession

GRAPH = dict(n=150, m=2000, time_span=40000, seed=11)
SPEC = "powerlaw:n=150,m=2000,time_span=40000,seed=11"
TINY = dict(n=60, m=400, time_span=5000, seed=1)
TINY_SPEC = "powerlaw:n=60,m=400,time_span=5000,seed=1"
LINES = [
    {"id": 1, "motif": "M5-3", "delta": 3000, "k": 1024},
    {"id": 2, "motif": "M5-2", "delta": 3000, "k": 1024, "seed": 1},
    {"id": 3, "motif": "0-1,1-2,2-0", "delta": 3000, "k": 512,
     "target_rse": 1e-3, "k_max": 2048},
    {"cmd": "health"},
    "this is not json",
    "",
    {"id": 4, "motif": "no-such-motif", "delta": 3000, "k": 512},
    {"id": 5, "motif": "M5-3", "delta": 3000},
    {"id": 6, "motif": "M5-3", "delta": 3000, "k": 512,
     "checkpoint_path": "x.json"},
    {"id": 7, "motif": "M5-3", "delta": 3000, "k": 0},
    {"id": 8, "motif": "M4-2", "delta": 3000, "k": 512,
     "deadline_ms": 1e-6},
    {"cmd": "stats"},
    {"id": 9, "motif": "M5-4", "delta": 3000, "k": 512, "seed": 1},
    {"cmd": "ingest", "edges": [[0, 1, 5]]},
    {"cmd": "advance"},
    {"cmd": "no-such-verb"},
    {"cmd": "quit"},
    {"id": 10, "motif": "M5-3", "delta": 3000, "k": 512},   # after quit
]


def _stdin(lines) -> io.StringIO:
    return io.StringIO("".join((ln if isinstance(ln, str) else json.dumps(ln))
                               + "\n" for ln in lines))


def _serve(loop, session, lines):
    out = io.StringIO()
    served = loop(session, infile=_stdin(lines), outfile=out)
    return served, [json.loads(ln) for ln in out.getvalue().splitlines()]


def _reset_reference():
    RSTATS.reset()
    R_RES_STATS.reset()
    R_RECORDER.clear()


def _reset_port():
    STATS.reset()
    RES_STATS.reset()
    RECORDER.clear()


@pytest.fixture(scope="module")
def reference():
    _reset_reference()
    s = RSession(rgraph(**GRAPH), RConfig(chunk=256,
                                          coalesce_window_s=3600.0))
    return _serve(ref_serve_loop, s, LINES)


@pytest.fixture(scope="module")
def port():
    _reset_port()
    s = Session(powerlaw_temporal_graph(**GRAPH),
                EstimateConfig(chunk=256, coalesce_window_s=3600.0,
                               device="cpu"))
    return _serve(serve_loop, s, LINES)


def _comparable(port_line: dict, ref_line: dict) -> tuple[dict, dict]:
    """The port's line without ``sampler_backend`` and the wall clock of
    an ``advance``, against the reference line's same keys."""
    got = {k: v for k, v in port_line.items()
           if k not in ("sampler_backend", "advance_s")}
    return got, {k: ref_line.get(k, "<missing>") for k in got}


def test_same_number_of_lines_and_requests(reference, port):
    assert port[0] == reference[0] == 5           # requests 1-3, 8, 9
    assert len(port[1]) == len(reference[1])


@pytest.mark.parametrize("i", range(16))
def test_response_line_equals_reference(reference, port, i):
    got, want = _comparable(port[1][i], reference[1][i])
    assert got == want
    if got.get("ok") and "id" in got:
        assert port[1][i]["sampler_backend"] == "cpu"


def test_responses_carry_the_integers_and_cohorts(port):
    by_id = {ln["id"]: ln for ln in port[1] if ln.get("id") is not None}
    assert by_id[1]["ok"] and by_id[2]["ok"] and by_id[9]["ok"]
    assert by_id[1]["fused_jobs"] == 2 and by_id[1]["W"] > 0
    assert by_id[3]["k"] > 512                         # adaptive growth
    assert by_id[8]["degraded"] and by_id[8]["k_done"] == 0
    kinds = {i: by_id[i]["error_kind"] for i in (4, 5, 6, 7)}
    assert kinds == dict.fromkeys((4, 5, 6, 7), "bad_request")
    assert [ln.get("cmd") for ln in port[1] if "cmd" in ln] == [
        "health", "stats", "quit"]
    errors = [ln["error"] for ln in port[1] if "id" not in ln
              and not ln.get("ok")]
    assert errors[0].startswith("bad json")
    assert errors[1] == "cmd 'ingest' needs stream mode (--serve --stream)"
    assert errors[3] == "unknown cmd 'no-such-verb'"


def _port_session(**kw):
    return Session(powerlaw_temporal_graph(**TINY),
                   EstimateConfig(chunk=64, device="cpu", **kw))


@pytest.mark.parametrize("cmd", ["metrics", "trace", "profile"])
def test_telemetry_verbs_wait_for_their_slice(cmd):
    """Named for what it checked before the port had telemetry: each
    verb now answers the reference's payload.  The two registries count
    different work, so ``metrics`` is held by its keys and the series
    the text declares."""
    _reset_port()
    _reset_reference()
    _, lines = _serve(serve_loop, _port_session(), [{"cmd": cmd}])
    _, want = _serve(ref_serve_loop, RSession(rgraph(**TINY), RConfig(
        chunk=64)), [{"cmd": cmd}])
    if cmd != "metrics":
        assert lines == want
        return
    assert set(lines[0]) == set(want[0])
    assert lines[0]["content_type"] == want[0]["content_type"]
    declared = {ln for ln in lines[0]["text"].splitlines()
                if ln.startswith("# TYPE repro_resilience")}
    assert declared == {ln for ln in want[0]["text"].splitlines()
                        if ln.startswith("# TYPE repro_resilience")}
    assert "# TYPE repro_engine_dispatches_total counter" in lines[0]["text"]


def test_witness_requests_answer_bad_request():
    """Named for what it checked before the port had witnesses: a
    witness request now answers the reference's line, witness edges
    included."""
    req = [{"id": 1, "motif": "M4-2", "delta": 500, "k": 128,
            "witnesses": 2}]
    _, lines = _serve(serve_loop, _port_session(), req)
    _, want = _serve(ref_serve_loop, RSession(rgraph(**TINY), RConfig(
        chunk=64)), req)
    got, ref = _comparable(lines[0], want[0])
    assert got == ref and lines[0]["ok"] is True
    assert len(lines[0]["witnesses"]) == 2
    assert all(len(w["edges"]) == 3 and w["cnt"] > 0
               for w in lines[0]["witnesses"])


def test_count_closed_window_drains_mid_stream():
    s = _port_session(coalesce_window_s=3600.0, coalesce_max_requests=2)
    req = [{"id": i, "motif": "M4-2", "delta": 500, "k": 64, "seed": i}
           for i in range(3)]
    served, lines = _serve(serve_loop, s, req + [{"cmd": "stats"}])
    assert served == 3 and [ln.get("id") for ln in lines[:3]] == [0, 1, 2]
    assert lines[3]["drains"] == 2 and lines[3]["completed"] == 3


def test_line_source_deadlines_on_a_pipe():
    r, w = os.pipe()
    with os.fdopen(r, "rb", buffering=0) as rf:
        src = LineSource(rf)
        assert src.readline(0.0) is None               # idle fd
        os.write(w, b'{"a": 1}\n{"b"')
        assert src.readline(0.0) == '{"a": 1}\n'       # buffered line
        assert src.readline(0.01) is None              # partial line
        os.write(w, b': 2}\n')
        os.close(w)
        assert src.readline(None) == '{"b": 2}\n'
        assert src.readline(None) == ""                # EOF


def _strip_times(line: str) -> str:
    return re.sub(r"\(pre [0-9.]+s \+ samp [0-9.]+s\)", "", line)


def test_cli_comma_lists_run_estimate_many(capsys):
    cli.main(["--graph", SPEC, "--motif", "M5-2,M5-3", "--delta",
              "3000,2000", "--k", "512", "--chunk", "256", "--device",
              "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("delta=")]
    want = estimate_many(powerlaw_temporal_graph(**GRAPH),
                         [(m, d, 512) for m in ("M5-2", "M5-3")
                          for d in (3000, 2000)], chunk=256, device="cpu")
    assert [_strip_times(ln) for ln in lines] == [
        _strip_times(f"delta={r.delta}  fused={r.fused_jobs}  "
                     f"{r.summary()}") for r in want]


@pytest.mark.parametrize("suffix", [".txt", ".txt.gz", ".npz"])
def test_cli_reads_an_edge_list_and_runs_the_exact_oracle(tmp_path, capsys,
                                                          suffix):
    g = powerlaw_temporal_graph(**TINY)
    path = str(tmp_path / f"g{suffix}")
    save_edge_list(g, path)
    cli.main(["--graph", path, "--motif", "M5-3", "--delta", "500",
              "--k", "256", "--chunk", "64", "--exact", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    want = estimate(g, get_motif("M5-3"), 500, 256, chunk=64, device="cpu")
    summary = next(ln for ln in out if ln.startswith("M5-3: C^="))
    assert _strip_times(summary) == _strip_times(want.summary())
    exact = count_exact(g, get_motif("M5-3"), 500)
    err = abs(want.estimate - exact) / max(exact, 1)
    assert f"  exact={exact}  error={100 * err:.2f}%" in out


def test_cli_checkpoint_resumes(tmp_path, capsys):
    ck = str(tmp_path / "ck.json")
    base = ["--graph", TINY_SPEC, "--motif", "M4-2", "--delta", "500",
            "--chunk", "64", "--seed", "2", "--device", "cpu",
            "--checkpoint", ck]
    cli.main(base + ["--k", "128"])
    assert json.load(open(ck))["chunks_done"] == 2
    cli.main(base + ["--k", "256"])
    out = capsys.readouterr().out.splitlines()
    assert json.load(open(ck))["chunks_done"] == 4
    want = estimate(powerlaw_temporal_graph(**TINY), get_motif("M4-2"), 500,
                    256, seed=2, chunk=64, device="cpu")
    summary = [ln for ln in out if ln.startswith("M4-2: C^=")][-1]
    assert _strip_times(summary) == _strip_times(want.summary())


def test_cli_serves_ndjson(monkeypatch, capsys):
    req = [{"id": 1, "motif": "M4-2", "delta": 500, "k": 128},
           {"cmd": "quit"}]
    monkeypatch.setattr("sys.stdin", _stdin(req))
    cli.main(["--graph", TINY_SPEC, "--serve", "--chunk", "64",
              "--coalesce-window", "60", "--device", "cpu"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    want = estimate(powerlaw_temporal_graph(**TINY), get_motif("M4-2"), 500,
                    128, chunk=64, device="cpu")
    assert lines[0]["ok"] and lines[0]["estimate"] == want.estimate
    assert lines[0]["W"] == want.W and lines[0]["valid"] == want.valid
    assert lines[1] == {"ok": True, "cmd": "quit", "served": 1}


# -- stream mode ----------------------------------------------------------
def _stream_lines():
    g = powerlaw_temporal_graph(**TINY)
    edges = [[int(a), int(b), int(c)] for a, b, c in zip(g.src, g.dst, g.t)]
    half = len(edges) // 2
    return [
        {"cmd": "advance"},                                  # empty stream
        {"id": 0, "motif": "M4-2", "delta": 500, "k": 64},   # no epoch yet
        {"cmd": "subscribe", "motif": "M4-2", "delta": 500, "k": 128,
         "witnesses": 3},
        {"cmd": "subscribe", "motif": "0-1,1-2,2-0", "delta": 800, "k": 128,
         "seed": 2, "name": "tri"},
        {"cmd": "subscribe", "motif": "M4-2", "delta": 500, "k": 64,
         "bogus": 1},
        {"cmd": "subscribe", "motif": "M4-2", "delta": 500, "k": 0},
        {"cmd": "ingest", "edges": edges[:half] + [[7, 7, 10]]},
        {"cmd": "ingest", "edges": [[1, 2]]},
        {"cmd": "ingest"},
        {"cmd": "health"},
        {"cmd": "advance"},
        {"id": 1, "motif": "M4-2", "delta": 500, "k": 128, "seed": 1,
         "witnesses": 2},
        {"cmd": "ingest", "edges": edges[half:]},
        {"cmd": "advance"},
        {"cmd": "unsubscribe", "sub": 1},
        {"cmd": "unsubscribe", "sub": 9},
        {"cmd": "advance"},
        {"cmd": "stats"},
        {"cmd": "health"},
        {"cmd": "quit"},
    ]


def _stream_serve(loop, ss, lines):
    out = io.StringIO()
    served = loop(None, infile=_stdin(lines), outfile=out, stream=ss)
    return served, [json.loads(ln) for ln in out.getvalue().splitlines()]


@pytest.fixture(scope="module")
def stream_reference():
    _reset_reference()
    ss = RStreaming(config=RConfig(chunk=64, coalesce_window_s=3600.0),
                    horizon=3000)
    return _stream_serve(ref_serve_loop, ss, _stream_lines())


@pytest.fixture(scope="module")
def stream_port():
    _reset_port()
    ss = StreamingSession(config=EstimateConfig(
        chunk=64, coalesce_window_s=3600.0, device="cpu"), horizon=3000)
    return _stream_serve(serve_loop, ss, _stream_lines())


def test_stream_wire_equals_reference(stream_reference, stream_port):
    assert stream_port[0] == stream_reference[0] == 6
    assert len(stream_port[1]) == len(stream_reference[1]) == 25
    for i, (got, want) in enumerate(zip(stream_port[1],
                                        stream_reference[1])):
        a, b = _comparable(got, want)
        assert a == b, i


def test_stream_wire_answers(stream_port):
    lines = stream_port[1]
    advances = [ln for ln in lines if ln.get("cmd") == "advance"]
    assert [a["ok"] for a in advances] == [False, True, True, True]
    assert advances[0]["error_kind"] == "bad_request"
    assert [a["epoch"] for a in advances[1:]] == [0, 1, 2]
    assert advances[2]["evicted"] > 0
    subs = [ln for ln in lines if "sub" in ln and "epoch" in ln]
    assert [(s["sub"], s["epoch"]) for s in subs] == [
        (0, 0), (1, 0), (0, 1), (1, 1), (0, 2)]
    assert all(len(s["witnesses"]) == 3 for s in subs if s["sub"] == 0)
    assert all("witnesses" not in s for s in subs if s["sub"] == 1)
    assert subs[1]["name"] == "tri" and subs[0]["sampler_backend"] == "cpu"
    one_shot = [ln for ln in lines if ln.get("id") is not None]
    assert [o["ok"] for o in one_shot] == [False, True]
    assert len(one_shot[1]["witnesses"]) == 2
    health = [ln for ln in lines if ln.get("cmd") == "health"]
    assert health[0]["mode"] == "stream" and health[0]["epoch"] == 0
    assert health[1]["epoch"] == 3 and "wal" not in health[1]


def test_stream_wal_position_in_health(tmp_path):
    from repro_torch.stream import StreamStore
    wal = str(tmp_path / "s.wal")
    ss = StreamingSession(StreamStore(wal=wal),
                          EstimateConfig(chunk=64, device="cpu"))
    _, lines = _stream_serve(serve_loop, ss, [
        {"cmd": "ingest", "edges": [[0, 1, 5], [1, 2, 9]]},
        {"cmd": "health"}])
    assert lines[1]["wal"] == {"path": wal, "records": 1,
                               "offset": os.path.getsize(wal)}


def test_serve_loop_needs_one_of_session_and_stream():
    with pytest.raises(ValueError, match="exactly one of session/stream"):
        serve_loop(None)


# -- the CLI in a subprocess ----------------------------------------------
REPO = Path(__file__).resolve().parents[1]


def _cli(args, lines=(), check=True):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.estimate", *args],
        input="".join(json.dumps(ln) + "\n" for ln in lines), env=env,
        capture_output=True, text=True, timeout=300, check=check)
    return proc


def test_cli_serves_a_live_stream_and_recovers_its_wal(tmp_path):
    """``--serve --stream --wal``: a server killed after an ingest (never
    advanced) restarts from its log and answers the uncrashed server's
    next epoch."""
    g = powerlaw_temporal_graph(**TINY)
    edges = [[int(a), int(b), int(c)] for a, b, c in zip(g.src, g.dst, g.t)]
    sub = {"cmd": "subscribe", "motif": "M4-2", "delta": 500, "k": 128,
           "witnesses": 2}
    first = [sub, {"cmd": "ingest", "edges": edges[:200]},
             {"cmd": "advance"}, {"cmd": "ingest", "edges": edges[200:]}]
    base = ["--serve", "--stream", "--chunk", "64", "--horizon", "4000",
            "--device", "cpu"]
    wal = str(tmp_path / "live.wal")
    _cli(base + ["--wal", wal], first)
    again = _cli(base + ["--wal", wal], [sub, {"cmd": "advance"}])
    assert "recovered epoch=1" in again.stderr
    restarted = [json.loads(ln) for ln in again.stdout.splitlines()]
    whole = _cli(base, first + [{"cmd": "advance"}])
    uncrashed = [json.loads(ln) for ln in whole.stdout.splitlines()]
    assert restarted[1]["epoch"] == uncrashed[-2]["epoch"] == 1
    got, want = _comparable(restarted[1], uncrashed[-2])
    assert got == want and got["ok"] and len(got["witnesses"]) == 2
    got, want = _comparable(restarted[2], uncrashed[-1])
    assert got == want and got["cmd"] == "advance" and got["ok"]


def test_cli_replays_an_edge_list_as_a_stream(tmp_path):
    g = powerlaw_temporal_graph(**TINY)
    path = str(tmp_path / "edges.txt.gz")
    save_edge_list(g, path)
    out = _cli(["--stream-replay", path, "--motif", "M4-2,M5-3", "--delta",
                "500", "--k", "128", "--chunk", "64", "--horizon", "3000",
                "--replay-batch", "150", "--advance-every", "1",
                "--device", "cpu"]).stdout.splitlines()
    assert out[0].startswith(f"replaying {path}  horizon=3000  batch=150  "
                             "queries=2")
    epochs = [ln for ln in out if ln.startswith("epoch ")]
    assert len(epochs) == 3
    ss = StreamingSession(config=EstimateConfig(chunk=64, device="cpu"),
                          horizon=3000)
    from repro_torch.stream import StandingQuery, replay_epochs
    for m in ("M4-2", "M5-3"):
        ss.subscribe(StandingQuery(m, 500, 128))
    want = list(replay_epochs(ss, path, batch_size=150))
    rows = [ln for ln in out if ln.startswith("  ")]
    assert [float(r.split("C^=")[1].split()[0]) for r in rows] == [
        float(f"{er.results[q].estimate:12.4g}") for er in want
        for q in (0, 1)]


@pytest.mark.parametrize("args,msg", [
    (["--stream"], "--stream requires --serve"),
    (["--horizon", "5"], "--horizon only applies to stream modes"),
    (["--serve", "--wal", "x.wal"], "--wal requires --serve --stream")])
def test_cli_refuses_stream_flags_out_of_place(args, msg, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(args + ["--device", "cpu"])
    assert e.value.code == 2 and msg in capsys.readouterr().err
