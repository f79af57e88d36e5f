"""The whole slice: ``repro_torch.estimate`` (and its CLI) on the CPU
against the live JAX reference, field for field.

Compared with ``repro.core.estimator.estimate`` computed in this process,
never with the golden constants of ``tests/test_api.py`` (those pin the
legacy threefry mode and drift under jax's default one)."""
from __future__ import annotations

import re

import pytest

from repro.core.estimator import estimate as ref_estimate
from repro.core.motif import get_motif as rget
from repro.graphs import powerlaw_temporal_graph as rgraph
from repro_torch import estimate, get_motif, powerlaw_temporal_graph
from repro_torch.launch import estimate as cli

GRAPH = dict(n=150, m=2000, time_span=40000, seed=11)
SPEC = "powerlaw:n=150,m=2000,time_span=40000,seed=11"
CASES = [("M5-3", 1024, 0), ("M4-2", 512, 3)]
DELTA, CHUNK = 3000, 256
FIELDS = ("estimate", "W", "k", "cnt2_sum", "valid", "fail_vmap",
          "fail_delta", "fail_order", "overflow", "tree_edges")


@pytest.fixture(scope="module")
def reference():
    g = rgraph(**GRAPH)
    return {name: ref_estimate(g, rget(name), DELTA, k, seed=seed,
                               chunk=CHUNK)
            for name, k, seed in CASES}


@pytest.mark.parametrize("name,k,seed", CASES)
def test_estimate_matches_reference_field_for_field(reference, name, k,
                                                    seed):
    g = powerlaw_temporal_graph(**GRAPH)
    got = estimate(g, get_motif(name), DELTA, k, seed=seed, chunk=CHUNK,
                   device="cpu")
    want = reference[name]
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.W > 0 and got.valid > 0 and got.cnt2_sum > 0
    assert got.tree_select_s >= got.preprocess_s > 0 and got.sampling_s > 0


def test_checkpoint_window_does_not_change_counts(reference):
    """Windows are an execution detail: one sync per chunk or per run
    gives the same sums."""
    g = powerlaw_temporal_graph(**GRAPH)
    name, k, seed = CASES[1]
    for ce in (1, 3):
        got = estimate(g, get_motif(name), DELTA, k, seed=seed, chunk=CHUNK,
                       checkpoint_every=ce, device="cpu")
        assert (got.cnt2_sum, got.valid) == (reference[name].cnt2_sum,
                                              reference[name].valid)


def _strip_times(line: str) -> str:
    return re.sub(r"\(pre [0-9.]+s \+ samp [0-9.]+s\)", "", line)


@pytest.mark.parametrize("name,k,seed", CASES)
def test_cli_prints_the_reference_summary(reference, capsys, name, k,
                                          seed):
    cli.main(["--graph", SPEC, "--motif", name, "--delta", str(DELTA),
              "--k", str(k), "--chunk", str(CHUNK), "--seed", str(seed),
              "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    want = reference[name]
    summary = next(ln for ln in lines if ln.startswith(f"{name}: C^="))
    assert _strip_times(summary) == _strip_times(want.summary())
    fail = next(ln for ln in lines if ln.startswith("  fail:"))
    assert fail.startswith(
        f"  fail: vmap={want.fail_vmap} delta={want.fail_delta} "
        f"order={want.fail_order} overflow={want.overflow}  ")
