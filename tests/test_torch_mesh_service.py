"""The port's data mesh through the service paths, against the reference.

Witnesses on a 3-shard mesh equal the reference's (they run unsharded
on shard 0); a ``StreamingSession`` on a 3-shard mesh answers every
epoch as a cold reference ``estimate()`` on that epoch's retained
graph; a gateway on a 2-shard mesh shares it with every tenant and
answers as the reference; the CLI's ``--mesh`` and ``--devices`` give
the meshless run's numbers and log the mesh's shape in every mode.
"""
from __future__ import annotations

import io
import json

import numpy as np
import pytest
import torch

import repro.api  # noqa: F401  (turns on jax x64 and loads the engine)
from repro.api import EstimateConfig as RConfig
from repro.api import Request as RRequest
from repro.api import Session as RSession
from repro.core.estimator import estimate as ref_estimate
from repro.core.graph import TemporalGraph as RGraph
from repro.core.motif import get_motif as rget
from repro.graphs import powerlaw_temporal_graph as rgraph
from repro_torch import powerlaw_temporal_graph
from repro_torch.api import EstimateConfig, Request, Session
from repro_torch.gateway import GatewayState, gateway_serve_loop
from repro_torch.launch import estimate as cli
from repro_torch.launch.mesh import EstimatorMesh, make_estimator_mesh
from repro_torch.stream import StandingQuery, StreamingSession

SPEC = "powerlaw:n=150,m=2000,time_span=40000,seed=11"
GRAPH = dict(n=150, m=2000, time_span=40000, seed=11)
DELTA, CHUNK = 3000, 256
WIT_REQ = dict(motif="M4-2", delta=DELTA, k=512, seed=3, witnesses=8)
WIT_CFG = dict(chunk=CHUNK, checkpoint_every=1)
FIELDS = ("estimate", "W", "k", "cnt2_sum", "valid", "fail_vmap",
          "fail_delta", "fail_order", "overflow", "tree_edges")
# the stream: 3 batches of a small graph, one standing query
STREAM_GRAPH = dict(n=120, m=2400, time_span=60000, seed=5)
STORE = dict(horizon=25_000, max_segments=2, min_m_bucket=256,
             min_n_bucket=16, min_p_bucket=64)
STREAM_Q = dict(motif="0-1,1-2,2-0", delta=3000, k=512, seed=0)
STREAM_CFG = dict(chunk=128)


def _same(got, want):
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f


def _mesh(D):
    return make_estimator_mesh(D, device="cpu")


@pytest.fixture(scope="module")
def m42():
    """The reference's M4-2 with 8 witnesses on the small graph, in two
    windows: the result and each window's witnesses (the gateway's and
    the CLI's yardstick too)."""
    rs = RSession(rgraph(**GRAPH), RConfig(**WIT_CFG))
    rh, = rs.submit_many([RRequest(**WIT_REQ)])
    return rh.result(), [p.witnesses for p in rh.stream()]


def test_witnesses_on_a_mesh_equal_reference(m42):
    """Witnesses run unsharded on shard 0 of a 3-shard mesh: the entries,
    every window's progress and the integers are the reference's."""
    want, progress = m42
    s = Session(powerlaw_temporal_graph(**GRAPH),
                EstimateConfig(device="cpu", **WIT_CFG), mesh=_mesh(3))
    h, = s.submit_many([Request(**WIT_REQ)])
    got = h.result()
    _same(got, want)
    assert got.witnesses == want.witnesses and len(got.witnesses) == 8
    assert [p.witnesses for p in h.stream()] == progress
    assert got.mesh_shape == (3,)


def test_streaming_session_on_a_mesh_equals_cold_reference():
    g = powerlaw_temporal_graph(**STREAM_GRAPH)
    idx = np.array_split(np.arange(g.m), 3)
    ss = StreamingSession(config=EstimateConfig(device="cpu", **STREAM_CFG),
                          mesh=_mesh(3), **STORE)
    qid = ss.subscribe(StandingQuery(**STREAM_Q))
    for i in idx:
        ss.ingest(g.src[i].astype(np.int64), g.dst[i].astype(np.int64),
                  g.t[i].astype(np.int64))
        er = ss.advance()
        assert ss.session.mesh is ss.mesh
        snap = er.epoch.graph
        m = snap.live_m
        retained = RGraph.from_edges(snap.src[:m], snap.dst[:m],
                                     snap.t[:m])
        want = ref_estimate(retained, rget(STREAM_Q["motif"]),
                            STREAM_Q["delta"], STREAM_Q["k"],
                            seed=STREAM_Q["seed"], **STREAM_CFG)
        got = er.results[qid]
        _same(got, want)
        assert got.mesh_shape == (3,)
    assert ss.stats.epochs == 3
    ss.close()


def test_gateway_state_shares_its_mesh():
    mesh = _mesh(2)
    state = GatewayState(EstimateConfig(chunk=CHUNK, device="cpu"),
                         mesh=mesh)
    graph = state.open_tenant("fin", graph=SPEC)
    live = state.open_tenant("live", stream=True)
    assert graph.session.mesh is mesh and live.stream.mesh is mesh
    state.close_all()
    with pytest.raises(ValueError, match="do not match"):
        GatewayState(EstimateConfig(device="cpu"),
                     mesh=EstimatorMesh((torch.device("cuda", 0),)))


def test_gateway_on_a_mesh_answers_as_the_reference(m42):
    lines = [{"cmd": "open_tenant", "tenant": "fin", "graph": SPEC},
             {"tenant": "fin", "id": 1, "motif": "M4-2", "delta": DELTA,
              "k": WIT_REQ["k"], "seed": WIT_REQ["seed"]}, {"cmd": "quit"}]
    out = io.StringIO()
    gateway_serve_loop(EstimateConfig(chunk=CHUNK, device="cpu"),
                       infile=io.StringIO("".join(json.dumps(ln) + "\n"
                                                  for ln in lines)),
                       outfile=out, mesh=_mesh(2))
    ans = next(json.loads(ln) for ln in out.getvalue().splitlines()
               if json.loads(ln).get("id") == 1)
    assert ans["ok"]
    want = m42[0]
    assert (ans["estimate"], ans["W"], ans["k"], ans["valid"]) == \
        (want.estimate, want.W, want.k, want.valid)


def _cli(capsys, *extra):
    cli.main(["--graph", SPEC, "--motif", "M4-2", "--delta", str(DELTA),
              "--k", str(WIT_REQ["k"]), "--seed", str(WIT_REQ["seed"]),
              "--chunk", str(CHUNK), "--device", "cpu", *extra])
    head, summary, _ = capsys.readouterr().out.splitlines()
    return head, summary.split("(")[0]          # timings aside


@pytest.mark.parametrize("extra,shape", [(("--mesh", "4"), 4),
                                         (("--devices", "3", "--mesh",
                                           "auto"), 3),
                                         (("--mesh", "auto"), 1)])
def test_cli_mesh_equals_the_meshless_run(capsys, m42, extra, shape):
    head, plain = _cli(capsys)
    assert "mesh=None" in head
    head, got = _cli(capsys, *extra)
    assert f"mesh={{'data': {shape}}}" in head
    assert got == plain
    want = m42[0]
    assert f"C^={want.estimate:.6g}  W={want.W}" in got


@pytest.mark.parametrize("mode", [("--serve", "--graph", SPEC),
                                  ("--serve", "--gateway"),
                                  ("--serve", "--stream")])
def test_cli_serve_modes_log_the_mesh(monkeypatch, capsys, mode):
    monkeypatch.setattr("sys.stdin", io.StringIO('{"cmd": "quit"}\n'))
    cli.main([*mode, "--device", "cpu", "--mesh", "2", "--chunk", "64"])
    assert "mesh={'data': 2}" in capsys.readouterr().err


def test_cli_devices_needs_mesh_auto(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--device", "cpu", "--devices", "2"])
    assert e.value.code == 2
    assert "--devices sets the shard count" in capsys.readouterr().err
