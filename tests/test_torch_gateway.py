"""The port's multi-tenant gateway (``repro_torch.gateway``) against the
JAX package's.

* one wire script (two graph tenants, a stream tenant with a WAL,
  witnesses, progress lines, a malformed line, a quota-free interleave)
  through both packages' ``gateway_serve_loop``: every answer equal per
  ``(tenant, id)`` and per tenant verb, ``sampler_backend`` and
  ``advance_s`` aside (thread order between tenants is free);
* the per-tenant quota sheds as ``overloaded`` at enqueue;
* idle-LRU eviction, reopen after eviction, and per-tenant WAL recovery
  over the wire;
* a malformed line answers alone, touching no tenant;
* one request's span chain shares one trace id across the intake,
  dispatcher and emitter threads;
* the CLI's ``--serve --gateway`` and its flag checks.
"""
from __future__ import annotations

import io
import json
import threading

import pytest

from repro.api import EstimateConfig as RConfig
from repro.gateway import gateway_serve_loop as ref_gateway
from repro_torch import estimate, get_motif, obs, powerlaw_temporal_graph
from repro_torch.api import EstimateConfig
from repro_torch.gateway import (FairScheduler, GatewayState, Work,
                                 gateway_serve_loop)
from repro_torch.launch import estimate as cli
from repro_torch.resilience import (OVERLOADED, OverloadedError, classify,
                                    error_payload)

FIN = "powerlaw:n=150,m=2000,time_span=40000,seed=11"
SOC = "powerlaw:n=60,m=400,time_span=5000,seed=1"
CHUNK, CKPT, DELTA = 256, 2, 3000
TIMING = ("sampler_backend", "advance_s")


def _cfg(pkg_config, **kw):
    return pkg_config(chunk=CHUNK, checkpoint_every=CKPT,
                      coalesce_window_s=60.0, **kw)


def _run(loop, config, lines, **kw):
    out = io.StringIO()
    served = loop(config, infile=io.StringIO(
        "".join((ln if isinstance(ln, str) else json.dumps(ln)) + "\n"
                for ln in lines)), outfile=out, **kw)
    return served, [json.loads(ln) for ln in out.getvalue().splitlines()]


def _port(lines, **kw):
    return _run(gateway_serve_loop, _cfg(EstimateConfig, device="cpu"),
                lines, **kw)


def _stream_edges():
    g = powerlaw_temporal_graph(n=60, m=400, time_span=5000, seed=1)
    return [[int(a), int(b), int(c)] for a, b, c in zip(g.src, g.dst, g.t)]


def _script():
    edges = _stream_edges()
    return [
        {"cmd": "open_tenant", "tenant": "fin", "graph": FIN},
        {"cmd": "open_tenant", "tenant": "soc", "graph": SOC},
        {"cmd": "open_tenant", "tenant": "live", "stream": True,
         "wal": True},
        {"tenant": "fin", "id": 1, "motif": "M4-2", "delta": DELTA,
         "k": 1024, "witnesses": 3},
        {"tenant": "soc", "id": 2, "motif": "M4-2", "delta": 500,
         "k": 512},
        "this is not json",
        {"tenant": "fin", "id": 3, "motif": "M4-2", "delta": DELTA,
         "k": 512, "seed": 3},
        {"tenant": "fin", "id": 4, "motif": "no-such-motif",
         "delta": DELTA, "k": 512},
        {"id": 5, "motif": "M4-2", "delta": 500, "k": 64},   # no tenant
        {"tenant": "nobody", "id": 6, "motif": "M4-2", "delta": 500,
         "k": 64},
        {"cmd": "subscribe", "tenant": "live", "motif": "M4-2",
         "delta": 500, "k": 512, "witnesses": 2},
        {"cmd": "ingest", "tenant": "live", "edges": edges[:200]},
        {"cmd": "advance", "tenant": "live"},
        {"cmd": "ingest", "tenant": "live", "edges": edges[200:]},
        {"cmd": "advance", "tenant": "live"},
        {"cmd": "advance", "tenant": "fin"},                 # graph tenant
        {"cmd": "close_tenant", "tenant": "soc"},
        {"cmd": "no-such-verb"},
        {"cmd": "quit"},
    ]


def _keyed(lines) -> dict:
    """Answers by (tenant, id, progress window) for requests and by
    (tenant, cmd, n-th) / (tenant, sub, epoch) for the rest."""
    out, seen = {}, {}
    for ln in lines:
        got = {k: v for k, v in ln.items() if k not in TIMING}
        if ln.get("cmd") in ("health", "stats"):
            continue
        if "id" in ln:
            key = ("id", ln.get("tenant"), ln["id"], ln.get("window")
                   if ln.get("progress") else None)
        elif "sub" in ln and "epoch" in ln:
            key = ("sub", ln.get("tenant"), ln["sub"], ln["epoch"])
        else:
            base = (ln.get("tenant"), ln.get("cmd"), ln.get("error"))
            seen[base] = seen.get(base, 0) + 1
            key = ("line", *base, seen[base])
        assert key not in out, key
        out[key] = got
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    wal_dir = tmp_path_factory.mktemp("wal")
    ref = _run(ref_gateway, _cfg(RConfig), _script(),
               wal_dir=str(wal_dir / "ref"))
    port = _port(_script(), wal_dir=str(wal_dir / "port"))
    return ref, port


def test_gateway_wire_equals_the_reference(both):
    (rserved, rlines), (served, lines) = both
    assert served == rserved == 5          # requests 1-3, two epoch lines
    assert len(lines) == len(rlines)
    got, want = _keyed(lines), _keyed(rlines)
    assert got == want
    assert all(ln["sampler_backend"] == "cpu" for ln in lines
               if ln.get("ok") and "estimate" in ln and "progress" not in ln)


def test_gateway_answers_carry_the_solo_integers(both):
    _, (_, lines) = both
    final = {ln["id"]: ln for ln in lines
             if "id" in ln and not ln.get("progress")}
    solo = estimate(powerlaw_temporal_graph(n=150, m=2000, time_span=40000,
                                            seed=11), get_motif("M4-2"),
                    DELTA, 1024, chunk=CHUNK, checkpoint_every=CKPT,
                    device="cpu")
    assert final[1]["W"] == solo.W and final[1]["valid"] == solo.valid
    assert final[1]["estimate"] == solo.estimate
    assert len(final[1]["witnesses"]) == 3
    # witness progress: one line per checkpoint window, before the answer
    prog = [ln for ln in lines if ln.get("progress") and ln["id"] == 1]
    assert [p["window"] for p in prog] == [0, 1]
    assert prog[-1]["witnesses"] == final[1]["witnesses"]
    assert lines.index(prog[-1]) < lines.index(final[1])
    assert final[4]["error_kind"] == "bad_request"
    assert final[5]["ok"] is False and "tenant" in final[5]["error"]
    assert final[6]["error_kind"] == "bad_request"      # unknown tenant
    bad = [ln for ln in lines if str(ln.get("error", "")).startswith(
        "bad json")]
    assert len(bad) == 1 and "tenant" not in bad[0]


def test_gateway_stream_tenant_epochs(both):
    _, (_, lines) = both
    adv = [ln for ln in lines if ln.get("cmd") == "advance"]
    assert [a["ok"] for a in adv if a["tenant"] == "live"] == [True, True]
    assert [a["ok"] for a in adv if a["tenant"] == "fin"] == [False]
    subs = [ln for ln in lines if "sub" in ln and "epoch" in ln]
    assert [s["epoch"] for s in subs] == [0, 1]
    assert all(len(s["witnesses"]) == 2 for s in subs)
    opened = [ln for ln in lines if ln.get("cmd") == "open_tenant"]
    assert [o["tenant"] for o in opened] == ["fin", "soc", "live"]
    assert opened[2]["recovered"] is False      # a fresh WAL


# ---------------------------------------------------------------------------
# backpressure, eviction, WAL recovery
# ---------------------------------------------------------------------------
def test_quota_sheds_with_overloaded():
    started, release = threading.Event(), threading.Event()

    def execute(unit):
        started.set()
        release.wait(30)

    sched = FairScheduler(execute, quota=2)
    try:
        sched.submit("other", Work("request", {}, "other"))
        assert started.wait(30)
        sched.submit("t", Work("request", {"id": 1}, "t"))
        sched.submit("t", Work("request", {"id": 2}, "t"))
        with pytest.raises(OverloadedError) as ei:
            sched.submit("t", Work("request", {"id": 3}, "t"))
        assert classify(ei.value) == OVERLOADED
        assert error_payload(ei.value)["error_kind"] == "overloaded"
        assert sched.stats.shed == 1 and sched.pending("t") == 2
        sched.submit("u", Work("request", {"id": 4}, "u"))
    finally:
        release.set()
        sched.stop()
    assert sched.stats.turns == 3 and sched.stats.batched == 1


def test_eviction_and_reopen():
    """At capacity the least-recently-active idle tenant is evicted, a
    busy one never; a reopened tenant answers the same integers.  (In
    process: over the wire ``open_tenant`` runs on the control queue
    ahead of queued tenant work, so the order is the scheduler's.)"""
    state = GatewayState(EstimateConfig(chunk=64, device="cpu"),
                         max_tenants=2)
    req = dict(motif="M4-2", delta=500, k=256)
    from repro_torch.api import Request
    a = state.open_tenant("a", graph=SOC)
    first = a.cur_session().submit(Request(**req)).result()
    state.open_tenant("b", graph=SOC)
    state.tenants["a"].touch()                 # b is now the LRU idle one
    state.open_tenant("c", graph=SOC)
    assert list(state.tenants) == ["a", "c"] and state.evictions == 1
    state.pending_of = lambda name: 1          # everyone busy
    with pytest.raises(OverloadedError):
        state.open_tenant("d", graph=SOC)
    state.pending_of = lambda name: 0
    state.close_tenant("a")
    again = state.open_tenant("a", graph=SOC)
    assert again.cur_session().submit(Request(**req)).result().estimate \
        == first.estimate
    state.close_all()
    _, lines = _port([
        {"cmd": "open_tenant", "tenant": "bad/name", "graph": SOC},
        {"cmd": "open_tenant", "tenant": "c", "graph": "nope:n=1"},
        {"cmd": "open_tenant", "tenant": "d", "graph": "/etc/edges.txt"},
        {"cmd": "open_tenant", "tenant": "e", "graph": SOC, "x": 1},
        {"cmd": "close_tenant", "tenant": "zz"},
        {"cmd": "quit"}], max_tenants=1)
    assert [ln["error_kind"] for ln in lines[:-1]] == ["bad_request"] * 5


def test_wal_recovery_over_the_wire(tmp_path):
    """A stream tenant's WAL outlives its gateway: a second gateway on
    the same ``wal_dir`` reopens it recovered and answers the next epoch
    of a gateway that never stopped."""
    edges = _stream_edges()
    sub = {"cmd": "subscribe", "tenant": "s", "motif": "M4-2",
           "delta": 500, "k": 256}
    common = [{"cmd": "open_tenant", "tenant": "s", "stream": True,
               "wal": True}, sub,
              {"cmd": "ingest", "tenant": "s", "edges": edges[:250]},
              {"cmd": "advance", "tenant": "s"},
              {"cmd": "ingest", "tenant": "s", "edges": edges[250:]}]
    wal_dir = str(tmp_path / "wal")
    _port(common + [{"cmd": "close_tenant", "tenant": "s"}],
          wal_dir=wal_dir)
    _, second = _port([
        {"cmd": "open_tenant", "tenant": "s", "stream": True, "wal": True},
        sub, {"cmd": "advance", "tenant": "s"}], wal_dir=wal_dir)
    _, whole = _port(common + [{"cmd": "advance", "tenant": "s"}],
                     wal_dir=str(tmp_path / "other"))
    reopened = next(ln for ln in second if ln.get("cmd") == "open_tenant")
    assert reopened["recovered"] is True and reopened["epoch"] == 1
    assert reopened["buffered"] == len(edges) - 250
    got = [ln for ln in second if ln.get("epoch") == 1 and "sub" in ln]
    want = [ln for ln in whole if ln.get("epoch") == 1 and "sub" in ln]
    assert got == want and got[0]["ok"]
    _, refused = _port([{"cmd": "open_tenant", "tenant": "x",
                         "stream": True, "wal": True}])
    assert refused[0]["error_kind"] == "bad_request"   # no --wal-dir


def test_gateway_state_in_process():
    state = GatewayState(EstimateConfig(chunk=CHUNK, device="cpu"),
                         max_tenants=2)
    t = state.open_tenant("fin", graph=SOC)
    assert t.mode == "graph" and t.cur_session() is t.session
    assert t.describe()["mode"] == "graph"
    state.close_all()
    assert not state.tenants


# ---------------------------------------------------------------------------
# telemetry across threads
# ---------------------------------------------------------------------------
def test_trace_chain_across_threads():
    obs.set_level("trace")
    obs.RECORDER.clear()
    try:
        served, lines = _port([
            {"cmd": "open_tenant", "tenant": "fin", "graph": SOC},
            {"tenant": "fin", "id": 7, "motif": "M4-2", "delta": 500,
             "k": 256},
            {"cmd": "quit"}])
        recs = obs.RECORDER.records()
    finally:
        obs.set_level(None)
        obs.RECORDER.clear()
    assert served == 1
    intake = next(r for r in recs if r["name"] == "gateway.intake"
                  and r.get("attrs", {}).get("id") == 7)
    chain = [r for r in recs if r["trace"] == intake["trace"]]
    names = {r["name"] for r in chain}
    assert {"gateway.intake", "stage.queue_wait", "session.preprocess",
            "session.drain", "engine.dispatch", "engine.device",
            "gateway.emit"} <= names
    threads = {r["thread"] for r in chain}
    assert {"gateway-dispatch", "gateway-emit"} <= threads
    assert len(threads) >= 3
    disp = next(r for r in chain if r["name"] == "engine.dispatch")
    dev = next(r for r in chain if r["name"] == "engine.device")
    assert dev["parent"] == disp["span"]
    fam = obs.REGISTRY.get("repro_tenant_request_seconds")
    assert fam.labels(tenant="fin").count >= 1


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def test_cli_serves_the_gateway(monkeypatch, capsys, tmp_path):
    lines = [{"cmd": "open_tenant", "tenant": "fin", "graph": SOC},
             {"tenant": "fin", "id": 1, "motif": "M4-2", "delta": 500,
              "k": 256},
             {"cmd": "metrics"}, {"cmd": "quit"}]
    monkeypatch.setattr("sys.stdin", io.StringIO(
        "".join(json.dumps(ln) + "\n" for ln in lines)))
    trace = tmp_path / "trace.ndjson"
    try:
        cli.main(["--serve", "--gateway", "--chunk", "64", "--device",
                  "cpu", "--max-tenants", "2", "--tenant-quota", "4",
                  "--trace-out", str(trace), "--obs-ring", "64"])
        assert obs.level_name() == "trace" and obs.RECORDER.capacity == 64
    finally:
        obs.set_level(None)
        obs.set_ring(4096)
        obs.RECORDER.clear()
    out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    ans = next(ln for ln in out if ln.get("id") == 1)
    solo = estimate(powerlaw_temporal_graph(n=60, m=400, time_span=5000,
                                            seed=1), get_motif("M4-2"), 500,
                    256, chunk=64, device="cpu")
    assert ans["ok"] and ans["estimate"] == solo.estimate
    assert any(ln.get("cmd") == "metrics" and ln["ok"] for ln in out)
    spans = [json.loads(ln) for ln in trace.read_text().splitlines()]
    assert 0 < len(spans) <= 64
    assert "gateway.emit" in {s["name"] for s in spans}


@pytest.mark.parametrize("args,msg", [
    (["--gateway"], "--gateway requires --serve"),
    (["--serve", "--gateway", "--stream"], "--gateway pools graph AND"),
    (["--serve", "--wal-dir", "d"], "--wal-dir only applies"),
    (["--profile-dir", "d"], "--profile-dir requires --serve"),
    (["--obs", "loud"], "invalid choice")])
def test_cli_refuses_gateway_flags_out_of_place(args, msg, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(args + ["--device", "cpu"])
    assert e.value.code == 2 and msg in capsys.readouterr().err
