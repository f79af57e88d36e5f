"""The port's data mesh against the reference's meshless results.

The reference's own tests hold its mesh results equal to its meshless
ones, so the port on a mesh of 1, 2, 3 and 8 CPU shards is held to the
reference's live meshless ``estimate_many`` bit for bit.  Windows of 4
chunks leave 3 shards uneven and 8 shards partly idle.  Also here: a
Session cohort on a 3-shard mesh, checkpoints resumed across mesh shapes
(byte-equal to the reference's), a fault in one shard's dispatch, the
halving ladder on a mesh, the mesh's errors, and the mesh helpers.
"""
from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
import torch

from repro.core.batch import estimate_many as ref_estimate_many
from repro.core.estimator import estimate as ref_estimate
from repro.core.motif import get_motif as rget
from repro.dist import sharding as rsharding
from repro.graphs import powerlaw_temporal_graph as rgraph
from repro_torch import (EstimateConfig, Request, Session, estimate,
                         estimate_many, get_motif, powerlaw_temporal_graph)
from repro_torch import resilience
from repro_torch.core import engine
from repro_torch.dist import collectives, sharding
from repro_torch.launch.mesh import EstimatorMesh, make_estimator_mesh

GRAPH = dict(n=150, m=2000, time_span=40000, seed=11)
DELTA, K, CHUNK = 3000, 1024, 256
TRIANGLE = "0-1,1-2,2-0"                     # a spec outside the registry
SINGLES = ("M4-2", "M5-3", TRIANGLE)
COHORT, SEEDS = ("M5-2", "M5-3", "M5-4"), (0, 1)
JOBS = ([(m, DELTA, K, 0) for m in SINGLES if m != "M5-3"]
        + [(m, DELTA, K, s) for m in COHORT for s in SEEDS])
FIELDS = ("estimate", "W", "k", "cnt2_sum", "valid", "fail_vmap",
          "fail_delta", "fail_order", "overflow", "tree_edges", "delta",
          "motif")
SHARDS = (1, 2, 3, 8)


def _same(got, want):
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f


def _mesh(D):
    return make_estimator_mesh(D, device="cpu")


@pytest.fixture(scope="module")
def graph():
    return powerlaw_temporal_graph(**GRAPH)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """One meshless reference ``estimate_many`` over every job (the
    reference's own tests hold it to its solo runs), keyed by (motif,
    seed), and the bytes of its checkpoint of M5-3 at k / 2."""
    g = rgraph(**GRAPH)
    res = ref_estimate_many(g, JOBS, chunk=CHUNK)
    by = {(m, s): r for (m, _, _, s), r in zip(JOBS, res)}
    path = tmp_path_factory.mktemp("ref") / "half.json"
    ref_estimate(g, rget("M5-3"), DELTA, K // 2, chunk=CHUNK,
                 checkpoint_path=str(path))
    return dict(by=by, half=path.read_bytes())


@pytest.mark.parametrize("D", SHARDS)
def test_estimate_on_a_mesh_equals_reference(graph, reference, D):
    for m in SINGLES:
        got = estimate(graph, get_motif(m), DELTA, K, chunk=CHUNK,
                       device="cpu", mesh=_mesh(D))
        _same(got, reference["by"][(m, 0)])
        assert got.mesh_shape == (D,)
        assert reference["by"][(m, 0)].mesh_shape is None


@pytest.mark.parametrize("D", SHARDS)
def test_estimate_many_on_a_mesh_equals_reference(graph, reference, D):
    res = estimate_many(graph, [(m, DELTA, K) for m in SINGLES],
                        chunk=CHUNK, device="cpu", mesh=_mesh(D))
    for m, got in zip(SINGLES, res):
        _same(got, reference["by"][(m, 0)])
        assert got.mesh_shape == (D,)


def test_meshless_result_has_no_mesh_shape(graph, reference):
    got = estimate(graph, get_motif("M4-2"), DELTA, K, chunk=CHUNK,
                   device="cpu")
    _same(got, reference["by"][("M4-2", 0)])
    assert got.mesh_shape is None


def test_session_cohort_on_three_shards_equals_reference(graph, reference):
    engine.STATS.reset()
    cells = [(m, s) for m in COHORT for s in SEEDS]
    with Session(graph, EstimateConfig(chunk=CHUNK, device="cpu"),
                 mesh=_mesh(3)) as s:
        handles = s.submit_many([Request(m, DELTA, K, seed=seed)
                                 for m, seed in cells])
        results = [h.result() for h in handles]
    for (m, seed), got in zip(cells, results):
        _same(got, reference["by"][(m, seed)])
        assert got.fused_jobs == len(cells) and got.mesh_shape == (3,)
    # one mesh-wide dispatch for the cohort's one window
    assert engine.STATS.dispatches == engine.STATS.tree_cohorts == 1


@pytest.mark.parametrize("first,then", [(1, 4), (4, 1), (3, 2), (None, 3),
                                        (2, None)])
def test_checkpoint_resumes_across_mesh_shapes(graph, reference, tmp_path,
                                               first, then):
    """Written at k / 2 on one mesh shape (None: no mesh), resumed to k
    on another: equal to the unbroken reference run, and the file is the
    reference's byte for byte (it records no mesh)."""
    path = str(tmp_path / "ck.json")
    mesh = None if first is None else _mesh(first)
    estimate(graph, get_motif("M5-3"), DELTA, K // 2, chunk=CHUNK,
             checkpoint_path=path, device="cpu", mesh=mesh)
    with open(path, "rb") as f:
        half = f.read()
    assert half == reference["half"]
    assert "mesh" not in json.loads(half)
    mesh = None if then is None else _mesh(then)
    got = estimate(graph, get_motif("M5-3"), DELTA, K, chunk=CHUNK,
                   checkpoint_path=path, device="cpu", mesh=mesh)
    _same(got, reference["by"][("M5-3", 0)])
    assert json.loads(open(path).read())["chunks_done"] == K // CHUNK


def test_fault_on_one_shard_retries_the_window(graph, reference):
    resilience.STATS.reset()
    spec = resilience.FaultSpec("engine.shard", hits=(0,), tag="cpu:1")
    with resilience.FaultInjector([spec]) as inj:
        got = estimate(graph, get_motif("M5-3"), DELTA, K, chunk=CHUNK,
                       device="cpu", mesh=_mesh(3))
    _same(got, reference["by"][("M5-3", 0)])
    assert inj.log == [("engine.shard", "cpu:1", 0, True),
                       ("engine.shard", "cpu:1", 1, False)]
    assert resilience.STATS.retries == 1 and got.fallback_reason == ""


def test_idle_shards_never_dispatch(graph, reference):
    """4 chunks on 8 shards: shards 4-7 have no offset, never fire their
    site and launch nothing."""
    spec = resilience.FaultSpec("engine.shard", hits=())   # log only
    with resilience.FaultInjector([spec]) as inj:
        got = estimate(graph, get_motif("M4-2"), DELTA, K, chunk=CHUNK,
                       device="cpu", mesh=_mesh(8))
    _same(got, reference["by"][("M4-2", 0)])
    assert [tag for _, tag, _, _ in inj.log] == [
        f"cpu:{d}" for d in range(K // CHUNK)]


def test_halving_ladder_on_a_mesh(graph, reference):
    """Three failed attempts halve the 4-chunk window to 2 + 2 on a
    3-shard mesh; the counts do not move."""
    resilience.STATS.reset()
    spec = resilience.FaultSpec("engine.dispatch", hits=(0, 1, 2))
    with resilience.FaultInjector([spec]):
        got = estimate(graph, get_motif("M5-3"), DELTA, K, chunk=CHUNK,
                       device="cpu", mesh=_mesh(3))
    _same(got, reference["by"][("M5-3", 0)])
    assert resilience.STATS.ladder_steps == 1
    assert "halved to 2 chunks" in got.fallback_reason


@pytest.mark.parametrize("axes,shape", [
    (("data", "model"), {"data": 2, "model": 2}),
    (("pod", "data"), {"pod": 2, "data": 2})])
def test_mesh_must_be_data_only(graph, axes, shape):
    bad = SimpleNamespace(axis_names=axes, shape=shape, size=4,
                          devices=(torch.device("cpu"),) * 4)
    cfg = EstimateConfig(chunk=CHUNK, device="cpu")
    with pytest.raises(ValueError, match="data-only"):
        Session(graph, cfg, mesh=bad)
    with pytest.raises(ValueError, match="data-only"):
        engine.make_engine_window_fn((None,), CHUNK, 16, "cpu", mesh=bad)


def test_mesh_device_type_must_match_the_config(graph):
    card = EstimatorMesh((torch.device("cuda", 0),) * 2)
    with pytest.raises(ValueError, match="do not match"):
        Session(graph, EstimateConfig(chunk=CHUNK, device="cpu"), mesh=card)
    with pytest.raises(ValueError, match="do not match"):
        estimate(graph, get_motif("M4-2"), DELTA, K, chunk=CHUNK,
                 device="cpu", mesh=card)


def test_make_estimator_mesh_on_the_cpu():
    mesh = make_estimator_mesh(device="cpu")
    assert mesh.devices == (torch.device("cpu"),)
    mesh = make_estimator_mesh(3, device="cpu")
    assert (mesh.axis_names, mesh.shape, mesh.size) == (("data",),
                                                        {"data": 3}, 3)
    assert set(mesh.devices) == {torch.device("cpu")}
    with pytest.raises(ValueError, match="at least one shard"):
        make_estimator_mesh(0, device="cpu")


def test_make_estimator_mesh_places_shards_round_robin(monkeypatch):
    """``shards=D`` puts shard d on cuda:(d % cards); the default is one
    shard per card (the card count stubbed: no card is touched)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = make_estimator_mesh(5)
    assert mesh.devices == tuple(torch.device("cuda", d % 2)
                                 for d in range(5))
    assert make_estimator_mesh().devices == (torch.device("cuda", 0),
                                             torch.device("cuda", 1))


MESHES = [(("data",), {"data": 4}), (("data", "model"), {"data": 2,
                                                          "model": 3}),
          (("pod", "data", "model"), {"pod": 2, "data": 2, "model": 2}),
          (("model",), {"model": 4}), (("x",), {"x": 5}),
          (("x", "model"), {"x": 3, "model": 2})]


@pytest.mark.parametrize("axes,shape", MESHES)
def test_mesh_introspection_equals_reference(axes, shape):
    mesh = SimpleNamespace(axis_names=axes, shape=shape)
    for fn in ("data_axes", "n_data", "n_model"):
        assert getattr(sharding, fn)(mesh) == getattr(rsharding, fn)(mesh)


def test_folded_axis_index_is_row_major():
    mesh = SimpleNamespace(axis_names=("pod", "data"),
                           shape={"pod": 2, "data": 3})
    got = [collectives.folded_axis_index(mesh, ("pod", "data"),
                                         dict(pod=p, data=d))
           for p in range(2) for d in range(3)]
    assert got == list(range(6))
    assert collectives.folded_axis_index(None, ("data",), {"data": 5}) == 5


def test_combine_is_an_exact_int64_sum():
    big = (1 << 62) + 3
    parts = [torch.full((6, 2, 3), big, dtype=torch.int64),
             torch.full((6, 2, 3), -big + 1, dtype=torch.int64),
             torch.arange(36, dtype=torch.int64).reshape(6, 2, 3)]
    got = collectives.combine(parts)
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    assert torch.equal(got, torch.arange(36).reshape(6, 2, 3) + 1)
