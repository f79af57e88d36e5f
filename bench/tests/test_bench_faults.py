"""A run whose timed path is broken underneath comes out not correct.

Each case drives the harness on the CPU at a small size, past its look
for a card, with one fault planted in the program: a window that
returns its state unchanged, half of each chunk's samples left out and
the rest counted twice, an answer altered where it is produced, a
graph index entry altered, and a plan that is not the least-``W`` one;
and an answer altered only once the session has served the warm-up and
the window's first batch, which the check of the window's last batch
catches.  (The cells run on one card: there is no exchange between
chips to leave out.)  The unbroken run is correct."""
import json

import pytest
import torch

import repro_torch.core.batch as batch
import repro_torch.core.engine as engine
import repro_torch.core.graph as graph

from bench import run as harness
from bench.tests import small


def state_unchanged(mp):
    make = engine.make_engine_window_fn

    def fake(*a, **kw):
        window = make(*a, **kw)
        return lambda *args: [torch.zeros_like(s) for s in window(*args)]
    mp.setattr(engine, "make_engine_window_fn", fake)


def half_the_samples(mp):
    make = engine.make_cohort_count_fn

    def fake(*a, **kw):
        fn = make(*a, **kw)

        def half(dev, wts, samples):
            K = samples["edges"].shape[1]
            cut = {k: v[:, :K // 2] for k, v in samples.items()}
            return {k: 2 * v for k, v in fn(dev, wts, cut).items()}
        return half
    mp.setattr(engine, "make_cohort_count_fn", fake)


def answer_altered(mp):
    mp.setattr(engine, "unbias_estimate",
               lambda W, c, k: (W * c / (2.0 * k) if k else 0.0) + 1.0)


def index_altered(mp):
    arrays = graph.TemporalGraph.device_arrays

    def fake(self, device="cuda"):
        out = arrays(self, device)
        out["out_t"] = out["out_t"].clone()
        out["out_t"][7] += 1
        return out
    mp.setattr(graph.TemporalGraph, "device_arrays", fake)


def plan_not_least(mp):
    cands = batch.candidate_trees
    mp.setattr(batch, "candidate_trees",
               lambda *a, **kw: list(reversed(cands(*a, **kw))))


FAULTS = [state_unchanged, half_the_samples, answer_altered, index_altered,
          plan_not_least]


MOTIFS = ["M4-1", "M4-3", "M4-2"]


def test_unbroken_run_is_correct():
    out = small.run("wikitalk.census", motifs=MOTIFS)
    assert out["correct"] and out["attempted"] >= 3 and not out["failed"]
    assert all(c["value"] == 0 for c in out["checks"].values())


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_broken_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = small.run("wikitalk.census", motifs=MOTIFS)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_late_fault_is_caught_in_the_last_batch(monkeypatch, capsys):
    """Answers go wrong from the window's second batch on; the window's
    last batch is always among those checked."""
    calls = []
    unbias = engine.unbias_estimate

    def late(W, c, k):
        calls.append(1)
        late_on = (2 * len(MOTIFS)) < len(calls)
        return unbias(W, c, k) + (1.0 if late_on else 0.0)
    monkeypatch.setattr(engine, "unbias_estimate", late)
    cfg, mix = small.CELLS["wikitalk.census"]
    out = harness.run("wikitalk.census", 2**31 + 11, 0.5, False,
                      device="cpu", config=small.config(cfg),
                      traffic=small.traffic(mix, motifs=MOTIFS), forbid=())
    logs = [json.loads(line) for line in capsys.readouterr().err.splitlines()
            if line.startswith("{")]
    batches = next(x["window"]["batches"] for x in logs if "window" in x)
    checked = next(x["check"]["batches"] for x in logs if "check" in x)
    assert batches >= 2 and batches - 1 in checked
    assert out["correct"] is False and out["checks"][
        "estimates_differing"]["value"] > 0
