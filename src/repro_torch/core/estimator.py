"""End-to-end TIMEST estimation (paper Alg. 6/7).

``estimate()`` runs the whole main path on one device: Alg. 7 tree
choice over the looseness-ranked candidates (each one preprocessed by
the Alg. 1/2 weight DP), the Alg. 3 sampler and the Alg. 4/5 counts in
``checkpoint_every`` windows of chunks (``core.engine``), and the Alg. 6
unbiasing.  For the same graph, motif, delta, k, seed and chunk it
returns the JAX reference's ``repro.core.estimator.estimate`` result
field for field.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; without a card they raise rather than fall back.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from .engine import run_job
from .graph import TemporalGraph
from .motif import TemporalMotif
from .spanning_tree import SpanningTree, candidate_trees
from .weights import Weights, preprocess


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for a CUDA device when
    no card is present (never falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch: no CUDA device available; pass "
                           "device='cpu' to run on the CPU")
    return device


def unbias_estimate(W: int, cnt2_sum: int, k: int) -> float:
    """Alg. 6 unbiasing: ``C^ = W * sum(cnt2) / (2k)``."""
    return W * cnt2_sum / (2.0 * k) if k else 0.0


@dataclass
class EstimateResult:
    estimate: float
    W: int
    k: int                      # samples drawn
    valid: int
    fail_vmap: int
    fail_delta: int
    fail_order: int
    overflow: int
    cnt2_sum: int
    motif: str
    tree_edges: tuple
    delta: int
    preprocess_s: float = 0.0   # weight DP of every candidate tree
    sampling_s: float = 0.0     # sampling + counting, device synced
    tree_select_s: float = 0.0  # Alg. 7 as a whole (includes preprocess)

    @property
    def valid_rate(self) -> float:
        return self.valid / max(self.k, 1)

    def summary(self) -> str:
        return (f"{self.motif}: C^={self.estimate:.6g}  W={self.W}  "
                f"k={self.k}  valid={100 * self.valid_rate:.1f}%  "
                f"(pre {self.preprocess_s:.2f}s + samp {self.sampling_s:.2f}s)")


def choose_tree(g: TemporalGraph, motif: TemporalMotif, delta: int,
                n_candidates: int = 3, roots_per_tree: int = 2,
                dev: dict | None = None, use_c2: bool = True,
                use_c3: bool = True, device: str = "cuda",
                timings: dict | None = None) -> tuple[SpanningTree, Weights]:
    """Alg. 7: looseness-ranked candidates, exact W for each, min-W wins.

    Same candidate order and strict ``<`` ranking as the reference, so
    the same tree wins; returns it with its already computed Weights.
    ``timings["preprocess_s"]`` (when given) accumulates the DP time.
    """
    if dev is None:
        dev = g.device_arrays(require_device(device))
    best: tuple[int, SpanningTree, Weights] | None = None
    for tree in candidate_trees(motif, n_candidates=n_candidates,
                                roots_per_tree=roots_per_tree):
        t0 = time.perf_counter()
        w = preprocess(g, tree, delta, dev=dev, use_c2=use_c2,
                       use_c3=use_c3)
        Wt = int(w.W_total)
        if timings is not None:
            timings["preprocess_s"] = (timings.get("preprocess_s", 0.0)
                                       + time.perf_counter() - t0)
        if best is None or Wt < best[0]:
            best = (Wt, tree, w)
        del w   # free a losing candidate before the next one is built
    if best is None:
        raise ValueError(f"motif {motif.name} has no spanning tree")
    return best[1], best[2]


def estimate(g: TemporalGraph, motif: TemporalMotif, delta: int, k: int,
             seed: int = 0, chunk: int = 8192, Lmax: int = 16,
             checkpoint_every: int = 64, use_c2: bool = True,
             use_c3: bool = True, device: str = "cuda") -> EstimateResult:
    """Alg. 6: the full TIMEST estimate with ``k`` samples on ``device``.

    Draws ``ceil(k / chunk) * chunk`` samples; chunk ``j`` from
    ``fold_in(PRNGKey(seed), j)``.  Refuses ``k < 1`` and ``delta < 0``
    with the reference's messages.
    """
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if delta < 0:
        raise ValueError(f"delta must be >= 0, got {delta}")
    dev = g.device_arrays(require_device(device))
    t0 = time.perf_counter()
    timings: dict = {}
    tree, wts = choose_tree(g, motif, delta, dev=dev, use_c2=use_c2,
                            use_c3=use_c3, timings=timings)
    tree_select_s = time.perf_counter() - t0
    run = run_job(tree, wts, dev, k, seed, chunk=chunk, Lmax=Lmax,
                  checkpoint_every=checkpoint_every)
    W = int(wts.W_total)
    acc = run.acc
    return EstimateResult(
        estimate=unbias_estimate(W, acc["cnt2"], run.k_eff),
        W=W, k=run.k_eff, valid=acc["valid"], fail_vmap=acc["fail_vmap"],
        fail_delta=acc["fail_delta"], fail_order=acc["fail_order"],
        overflow=acc["overflow"], cnt2_sum=acc["cnt2"], motif=motif.name,
        tree_edges=tree.edge_ids, delta=int(delta),
        preprocess_s=timings.get("preprocess_s", 0.0),
        sampling_s=run.sampling_s, tree_select_s=tree_select_s)
