"""The port's tree-cohort engine against the live JAX reference.

On ``powerlaw(n=150, m=2000, time_span=40000, seed=11)`` at delta 3000
the planner puts {M4-1, M4-3, M4-4, M4-7} and {M5-2, M5-3, M5-4} on
signature-equal min-W trees: a 4-lane and a 3-lane cohort.  With two
seeds each, every cell must equal the reference's ``estimate_many``
field for field and the port's own solo run of that motif and seed.
Checkpoints cross between the two packages in both directions.
"""
from __future__ import annotations

import json

import pytest
import torch

from repro.core.batch import estimate_many as ref_estimate_many
from repro.core.engine import STATS as RSTATS
from repro.core.estimator import estimate as ref_estimate
from repro.core.motif import get_motif as rget
from repro.graphs import powerlaw_temporal_graph as rgraph
from repro_torch import (BatchPlanner, estimate, estimate_many, get_motif,
                         powerlaw_temporal_graph)
from repro_torch.core import rng
from repro_torch.core.engine import STATS
from repro_torch.core.sampler import make_batched_sample_fn, make_sample_fn
from repro_torch.core.spanning_tree import tree_signature
from repro_torch.kernels.tree_sampler.ops import (build_schedule,
                                                  tree_sampler_keyed)

GRAPH = dict(n=150, m=2000, time_span=40000, seed=11)
DELTA, K, CHUNK = 3000, 1024, 256
COHORTS = {"M4": ("M4-1", "M4-3", "M4-4", "M4-7"),
           "M5": ("M5-2", "M5-3", "M5-4")}
SEEDS = (0, 1)
JOBS = [(m, DELTA, K, s) for ms in COHORTS.values() for m in ms
        for s in SEEDS]
FIELDS = ("estimate", "W", "k", "cnt2_sum", "valid", "fail_vmap",
          "fail_delta", "fail_order", "overflow", "tree_edges", "delta",
          "motif", "fused_jobs", "degraded", "degrade_reason")
STAT_FIELDS = ("dispatches", "fused_dispatches", "job_windows",
               "tree_cohorts", "cohort_motif_lanes", "samples_shared",
               "witness_dispatches")


def _same(got, want, fields=FIELDS):
    for f in fields:
        assert getattr(got, f) == getattr(want, f), f


@pytest.fixture(scope="module")
def graph():
    return powerlaw_temporal_graph(**GRAPH)


@pytest.fixture(scope="module")
def reference():
    """One reference ``estimate_many`` over both cohorts, its engine
    counters, and the unbroken M5-3 run the checkpoint tests resume to."""
    g = rgraph(**GRAPH)
    RSTATS.reset()
    res = ref_estimate_many(g, JOBS, chunk=CHUNK)
    stats = {f: getattr(RSTATS, f) for f in STAT_FIELDS}
    return dict(graph=g, many=res, stats=stats)


@pytest.fixture(scope="module")
def port_many(graph):
    STATS.reset()
    res = estimate_many(graph, JOBS, chunk=CHUNK, device="cpu")
    return res, {f: getattr(STATS, f) for f in STAT_FIELDS}


def test_planner_forms_the_two_cohorts(graph):
    planner = BatchPlanner(graph, device="cpu")
    for motifs in COHORTS.values():
        plans = [planner.plan(get_motif(m), DELTA) for m in motifs]
        assert len({tree_signature(t) for t, _ in plans}) == 1
        assert len({id(w) for _, w in plans}) == 1
        assert len({t for t, _ in plans}) == len(motifs)   # distinct lanes


@pytest.mark.parametrize("job", range(len(JOBS)),
                         ids=[f"{m}-seed{s}" for m, _, _, s in JOBS])
def test_cohort_cell_equals_reference_estimate_many(reference, port_many,
                                                    job):
    got, want = port_many[0][job], reference["many"][job]
    _same(got, want)
    assert got.fused_jobs == 2 * len(COHORTS[got.motif[:2]])


@pytest.mark.parametrize("cohort", sorted(COHORTS))
def test_cohort_cells_equal_solo_runs(graph, port_many, cohort):
    """A solo run (its own one-job plan, one stream and one lane) of each
    cell's motif and seed gives the cohort cell's integers."""
    planner = BatchPlanner(graph, device="cpu")
    for i, (m, d, k, s) in enumerate(JOBS):
        if m not in COHORTS[cohort]:
            continue
        solo, = estimate_many(graph, [(m, d, k, s)], chunk=CHUNK,
                              planner=planner, device="cpu")
        _same(solo, port_many[0][i],
              [f for f in FIELDS if f != "fused_jobs"])
        assert solo.fused_jobs == 1


def test_engine_stats_match_reference(reference, port_many):
    stats = port_many[1]
    assert stats == reference["stats"]
    # 2 cohorts, one window each; 14 jobs over 7 lanes and 4 streams
    assert stats["dispatches"] == stats["tree_cohorts"] == 2
    assert stats["cohort_motif_lanes"] == 7 and stats["job_windows"] == 14
    assert stats["samples_shared"] == (14 - 4) * K


def test_engine_stats_count_windows_and_reset(graph):
    STATS.reset()
    estimate_many(graph, [("M5-2", DELTA, K, 0), ("M5-3", DELTA, K // 2, 0)],
                  chunk=CHUNK, checkpoint_every=1, device="cpu")
    # one cohort window a chunk while both run, then M5-2 alone
    assert (STATS.dispatches, STATS.fused_dispatches,
            STATS.job_windows) == (4, 2, 6)
    assert STATS.samples_shared == 2 * CHUNK
    assert STATS.motifs_per_cohort == 6 / 4
    STATS.reset()
    assert all(getattr(STATS, f) == 0 for f in STAT_FIELDS)


def _ckpt(path):
    return json.loads(path.read_text())


def test_checkpoint_crosses_packages_both_ways(reference, graph, tmp_path):
    """A checkpoint written by the reference at k/2 resumes in the port
    to the reference's unbroken result at k, and the other way round;
    the files the two write are the same bytes."""
    rg = reference["graph"]
    want = next(r for (m, _, _, s), r in zip(JOBS, reference["many"])
                if (m, s) == ("M5-3", 1))
    motif_r, motif_t = rget("M5-3"), get_motif("M5-3")
    ref_path, port_path = tmp_path / "ref.json", tmp_path / "port.json"
    ref_estimate(rg, motif_r, DELTA, K // 2, seed=1, chunk=CHUNK,
                 checkpoint_path=str(ref_path))
    estimate(graph, motif_t, DELTA, K // 2, seed=1, chunk=CHUNK,
             checkpoint_path=str(port_path), device="cpu")
    assert ref_path.read_bytes() == port_path.read_bytes()
    assert _ckpt(port_path)["chunks_done"] == K // 2 // CHUNK

    got = estimate(graph, motif_t, DELTA, K, seed=1, chunk=CHUNK,
                   checkpoint_path=str(ref_path), device="cpu")
    _same(got, want, [f for f in FIELDS if f != "fused_jobs"])
    back = ref_estimate(rg, motif_r, DELTA, K, seed=1, chunk=CHUNK,
                        checkpoint_path=str(port_path))
    _same(back, want, [f for f in FIELDS if f != "fused_jobs"])
    assert ref_path.read_bytes() == port_path.read_bytes()
    assert _ckpt(port_path)["chunks_done"] == K // CHUNK


@pytest.mark.parametrize("content", ['{"motif": "M5-3", "del', "",
                                     '["not", "a", "dict"]',
                                     '{"motif": "M5-3"}'])
def test_torn_or_foreign_checkpoint_is_ignored(graph, port_many, tmp_path,
                                               content):
    path = tmp_path / "torn.json"
    path.write_text(content)
    got = estimate(graph, get_motif("M5-3"), DELTA, K, seed=0, chunk=CHUNK,
                   checkpoint_path=str(path), device="cpu")
    want = port_many[0][JOBS.index(("M5-3", DELTA, K, 0))]
    _same(got, want, [f for f in FIELDS if f != "fused_jobs"])
    assert _ckpt(path)["chunks_done"] == K // CHUNK


def test_mismatched_checkpoint_starts_fresh(graph, port_many, tmp_path):
    """A checkpoint of another seed, or of a larger budget, is stale."""
    path = tmp_path / "other.json"
    estimate(graph, get_motif("M5-3"), DELTA, 2 * K, seed=0, chunk=CHUNK,
             checkpoint_path=str(path), device="cpu")
    want = port_many[0][JOBS.index(("M5-3", DELTA, K, 1))]
    got = estimate(graph, get_motif("M5-3"), DELTA, K, seed=1, chunk=CHUNK,
                   checkpoint_path=str(path), device="cpu")
    _same(got, want, [f for f in FIELDS if f != "fused_jobs"])
    want = port_many[0][JOBS.index(("M5-3", DELTA, K, 0))]
    path.write_text(json.dumps(dict(_ckpt(path), chunks_done=8)))
    got = estimate(graph, get_motif("M5-3"), DELTA, K, seed=0, chunk=CHUNK,
                   checkpoint_path=str(path), device="cpu")
    _same(got, want, [f for f in FIELDS if f != "fused_jobs"])


@pytest.mark.parametrize("J", [1, 2, 5])
def test_multi_stream_sampler_streams_equal_solo_calls(graph, J):
    planner = BatchPlanner(graph, device="cpu")
    tree, wts = planner.plan(get_motif("M5-3"), DELTA)
    dev = planner.dev
    keys = rng.fold_in(rng.PRNGKey(3), torch.arange(J) + 40)
    args = (build_schedule(tree), tree.root, tree.num_edges, dev, wts)
    edges, window = tree_sampler_keyed(*args, keys, 300)
    assert edges.shape == (J, 300, tree.num_edges)
    batched = make_batched_sample_fn(tree, 300, "cpu")(dev, wts, keys)
    solo_fn = make_sample_fn(tree, 300, "cpu")
    for i in range(J):
        e_i, w_i = tree_sampler_keyed(*args, keys[i], 300)
        assert torch.equal(edges[i], e_i) and torch.equal(window[i], w_i)
        solo = solo_fn(dev, wts, keys[i])
        for name in ("edges", "window", "phi_v"):
            assert torch.equal(batched[name][i], solo[name]), name
