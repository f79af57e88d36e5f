"""Batched multi-motif estimation (the odeN-style serving path).

Torch counterpart of ``repro.core.batch``.  ``estimate_many()`` shares
the work of many ``(motif, delta, k)`` jobs over one graph:

* one ``device_arrays()`` upload serves every job;
* tree choice and preprocessing go through a ``BatchPlanner`` whose
  Weights cache is keyed on ``(tree_signature, delta, wd, use_c2)``:
  jobs that resolve to the same key (same motif and delta, or distinct
  motifs whose trees share a structural signature) preprocess once and
  share ONE ``Weights`` object;
* sampling runs through the engine (``core/engine.py``): jobs sharing a
  plan key and that Weights object form a tree cohort, one sample stream
  per seed scored by every member motif's own count fn.

Each job's result is bit-identical to ``estimate(g, motif, delta, k,
seed=seed)``: the same candidate ranking picks the same tree, and chunk
``j`` draws from ``fold_in(PRNGKey(seed), j)`` whichever cohort runs it.

Telemetry: every candidate the planner resolves opens the ``obs`` span
``planner.weights`` (attrs ``signature``, ``delta``, ``hit``; on a miss
also ``W``, ``dep_sums``, the dep-sum kernel launches its weight DP
made, and ``bytes``, the Weights' size); a miss's ``elapsed_s`` is what
``preprocess_s`` sums.  The planner reads no clock of its own.

The reference also caches a compiled preprocess program per process
(``weights.cached_preprocess_fn``); torch compiles nothing, so the port
has no counterpart.  The device is fixed per planner, so the cache key
carries no backend.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Sequence

from .. import obs
from ..kernels.interval_weight.ops import dep_sum
from . import rng
from .estimator import EstimateResult, require_device
from .graph import TemporalGraph
from .motif import TemporalMotif, get_motif
from .spanning_tree import SpanningTree, candidate_trees, tree_signature
from .weights import Weights, preprocess


@dataclass(frozen=True)
class Job:
    """One estimation request: count ``motif`` under ``delta`` with ``k``
    samples.  ``seed=None`` inherits the batch-level seed."""

    motif: TemporalMotif
    delta: int
    k: int
    seed: int | None = None


def as_job(spec) -> Job:
    """Accept Job | (motif, delta, k[, seed]); motif may be a name."""
    if isinstance(spec, Job):
        return spec
    motif, delta, k, *rest = spec
    if isinstance(motif, str):
        motif = get_motif(motif)
    return Job(motif=motif, delta=int(delta), k=int(k),
               seed=rest[0] if rest else None)


class BatchPlanner:
    """Shared-preprocess tree selection over one graph.

    ``plan(motif, delta)`` mirrors ``estimator.choose_tree`` (same
    candidate order, same strict min-W ranking, so the same tree wins)
    but routes every candidate's ``preprocess`` through a cache keyed on
    ``(tree_signature, delta, wd, use_c2)``: structurally equal trees of
    different motifs share one Weights object.  ``preprocess_s`` sums
    the time of the weight DPs it ran.
    """

    def __init__(self, g: TemporalGraph, dev: dict | None = None,
                 n_candidates: int = 3, roots_per_tree: int = 2,
                 use_c2: bool = True, use_c3: bool = True,
                 device: str = "cuda"):
        self.g = g
        self.dev = (g.device_arrays(require_device(device)) if dev is None
                    else dev)
        self.n_candidates = n_candidates
        self.roots_per_tree = roots_per_tree
        self.use_c2 = use_c2
        self.use_c3 = use_c3
        self._weights: dict = {}
        self._plans: dict = {}
        self.preprocess_calls = 0
        self.preprocess_hits = 0
        self.preprocess_s = 0.0

    def _wd(self, delta: int) -> int:
        return int(delta) if self.use_c3 else int(self.g.time_span) + 1

    def weights_for(self, tree: SpanningTree, delta: int) -> Weights:
        # keyed on the STRUCTURAL signature: the weight DP reads only
        # signature fields, so trees of different motifs sharing one
        # resolve to one Weights object, the identity the engine's
        # cohorts key on
        sig = tree_signature(tree)
        key = (sig, int(delta), self._wd(delta), self.use_c2)
        hit = key in self._weights
        with obs.span("planner.weights", signature=str(sig),
                      delta=int(delta), hit=hit) as sp:
            if hit:
                self.preprocess_hits += 1
            else:
                self.preprocess_calls += 1
                launches = dep_sum.launches
                w = self._weights[key] = preprocess(
                    self.g, tree, delta, dev=self.dev, use_c2=self.use_c2,
                    use_c3=self.use_c3)
                sp.set(W=int(w.W_total),                 # device synced
                       dep_sums=dep_sum.launches - launches,
                       bytes=w.nbytes)
        if not hit:
            self.preprocess_s += sp.elapsed_s
        return self._weights[key]

    def plan(self, motif: TemporalMotif, delta: int
             ) -> tuple[SpanningTree, Weights]:
        """Min-W tree + its Weights for (motif, delta), cached."""
        pkey = (motif, int(delta))
        if pkey in self._plans:
            return self._plans[pkey]
        best = None
        for tree in candidate_trees(motif, n_candidates=self.n_candidates,
                                    roots_per_tree=self.roots_per_tree):
            w = self.weights_for(tree, delta)
            Wt = int(w.W_total)
            if best is None or Wt < best[0]:
                best = (Wt, tree, w)
        if best is None:
            raise ValueError(f"motif {motif.name} has no spanning tree")
        self._plans[pkey] = (best[1], best[2])
        return self._plans[pkey]


def estimate_many(g: TemporalGraph, jobs: Iterable, seed: int = 0,
                  chunk: int = 8192, Lmax: int = 16, n_candidates: int = 3,
                  use_c2: bool = True, use_c3: bool = True,
                  checkpoint_every: int = 64, dev: dict | None = None,
                  planner: BatchPlanner | None = None,
                  device: str = "cuda", mesh=None) -> list[EstimateResult]:
    """Estimate every ``(motif, delta, k[, seed])`` job over one graph.

    One ``EstimateResult`` per job, in job order, each bit-identical to
    the sequential ``estimate()`` call with the same seed.  Pass a
    ``BatchPlanner`` to carry the preprocess cache across calls.
    ``mesh`` shards every window's chunk range over a data mesh's
    shards.

    A shim over the session API: the whole batch becomes ONE submit
    window of a one-shot ``Session`` (``submit_many``).
    """
    from ..api import EstimateConfig, Request, Session
    jobs = [as_job(j) for j in jobs]
    cfg = EstimateConfig(chunk=chunk, Lmax=Lmax,
                         checkpoint_every=checkpoint_every,
                         n_candidates=n_candidates, use_c2=use_c2,
                         use_c3=use_c3, device=device, seed=int(seed))
    session = Session(g, cfg, dev=dev, mesh=mesh, planner=planner)
    handles = session.submit_many([
        Request(motif=j.motif, delta=int(j.delta), k=int(j.k),
                seed=int(seed if j.seed is None else j.seed))
        for j in jobs])
    return [h.result() for h in handles]


def sample_matches_many(g: TemporalGraph, specs: Sequence, K: int,
                        seed: int = 0, dev: dict | None = None,
                        planner: BatchPlanner | None = None,
                        device: str = "cuda"):
    """Draw ``K`` weighted tree samples + counts per (motif, delta) spec.

    The feature-extraction entry point: per-spec dicts with ``phi_v [K,
    nv]``, ``cnt2 [K]``, ``valid [K]`` and the rescale factor ``W/(2K)``,
    sharing the upload and preprocessing like ``estimate_many``.  Spec
    ``j`` draws from ``fold_in(PRNGKey(seed), j)``.
    """
    from .sampler import make_sample_fn
    from .validate import make_count_fn

    if planner is None:
        planner = BatchPlanner(g, dev=dev, device=device)
    dev = planner.dev
    on = dev["t"].device
    fns: dict = {}   # specs resolving to one tree share their fns
    out = []
    for j, spec in enumerate(specs):
        motif, delta = spec[0], int(spec[1])
        if isinstance(motif, str):
            motif = get_motif(motif)
        tree, wts = planner.plan(motif, delta)
        if tree not in fns:
            fns[tree] = (make_sample_fn(tree, K, on), make_count_fn(tree, K))
        sample_fn, count_fn = fns[tree]
        s = sample_fn(dev, wts, rng.fold_in(rng.PRNGKey(seed), j))
        c = count_fn(dev, wts, s)
        out.append(dict(motif=motif, tree=tree, phi_v=s["phi_v"],
                        cnt2=c["cnt2"], valid=c["valid"],
                        scale=float(wts.W_total) / (2.0 * K)))
    return out
