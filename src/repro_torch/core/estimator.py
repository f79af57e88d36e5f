"""End-to-end TIMEST estimation (paper Alg. 6/7).

``estimate()`` is the reference's compatibility shim over the session
API (``repro_torch.api``): it wraps the graph in a one-shot ``Session``
and submits a single ``Request``.  The session plans (Alg. 7 tree choice
over the looseness-ranked candidates, each preprocessed by the Alg. 1/2
weight DP, through ``core.batch.BatchPlanner``) and hands the job to
the engine (``core.engine``), which samples (Alg. 3) and counts (Alg.
4/5) in ``checkpoint_every`` windows of chunks; ``unbias_estimate`` is
Alg. 6.  For the same graph, motif, delta, k, seed and chunk it returns
the JAX reference's ``repro.core.estimator.estimate`` result field for
field.  This module also keeps ``choose_tree`` (Alg. 7 on its own, the
planner's counterpart) and the ``EstimateResult`` container.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; without a card they raise rather than fall back.  With
``mesh=`` the chunks stride over a data mesh's shards, bit-identically
on any mesh shape (``core.engine``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .graph import TemporalGraph
from .motif import TemporalMotif
from .spanning_tree import SpanningTree, candidate_trees
from .weights import Weights, preprocess

ACC_KEYS = ("cnt2", "valid", "fail_vmap", "fail_delta", "fail_order",
            "overflow")


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
    preprocess_s: float = 0.0   # weight DP of the candidates it computed
    sampling_s: float = 0.0     # sampling + counting, device synced
    tree_select_s: float = 0.0  # Alg. 7 as a whole (includes preprocess)
    sampler_backend: str = "cuda"   # the device type that sampled
    # the retry ladder's rungs taken ("" when none): the port never
    # swaps a kernel for its plain twin, it only halves windows
    fallback_reason: str = ""
    mesh_shape: tuple | None = None   # data mesh ``(D,)``; None = unsharded
    fused_jobs: int = 1            # jobs sharing this job's tree cohort
    # empirical batch-means relative standard error, filled by the
    # session layer (api/session.py); None when no session measured it
    rse: float | None = None
    # deadline partials: the job stopped at its last completed checkpoint
    # window, ``k`` reports the samples actually drawn (never an error)
    degraded: bool = False
    degrade_reason: str = ""
    # up to ``Request.witnesses`` accepted full-match edge tuples from the
    # deterministic reservoir (``engine.witness_entries`` format); None
    # when the request did not ask for witnesses
    witnesses: tuple | None = None

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
                use_c3: bool = True, device: str = "cuda"
                ) -> tuple[SpanningTree, Weights]:
    """Alg. 7: looseness-ranked candidates, exact W for each, min-W wins.

    Same candidate order and strict ``<`` ranking as the reference, so
    the same tree wins; returns it with its already computed Weights.
    The session path chooses through ``core.batch.BatchPlanner``, which
    ranks the same way and caches every candidate's Weights.
    """
    if dev is None:
        dev = g.device_arrays(require_device(device))
    best: tuple[int, SpanningTree, Weights] | None = None
    for tree in candidate_trees(motif, n_candidates=n_candidates,
                                roots_per_tree=roots_per_tree):
        w = preprocess(g, tree, delta, dev=dev, use_c2=use_c2,
                       use_c3=use_c3)
        Wt = int(w.W_total)
        if best is None or Wt < best[0]:
            best = (Wt, tree, w)
        del w   # free a losing candidate before the next one is built
    if best is None:
        raise ValueError(f"motif {motif.name} has no spanning tree")
    return best[1], best[2]


def estimate(g: TemporalGraph, motif: TemporalMotif, delta: int, k: int,
             seed: int = 0, tree: SpanningTree | None = None,
             n_candidates: int = 3, chunk: int = 8192, Lmax: int = 16,
             use_c2: bool = True, use_c3: bool = True,
             checkpoint_path: str | None = None, checkpoint_every: int = 64,
             dev: dict | None = None, wts: Weights | None = None,
             device: str = "cuda", mesh=None) -> EstimateResult:
    """Alg. 6: the full TIMEST estimate with ``k`` samples on ``device``.

    Draws ``ceil(k / chunk) * chunk`` samples; chunk ``j`` from
    ``fold_in(PRNGKey(seed), j)``.  ``tree`` (with ``wts``) skips the
    tree choice (and the weight DP); ``checkpoint_path`` writes the
    reference's checkpoint JSON after every window and resumes from a
    matching one.  Refuses ``k < 1`` and ``delta < 0`` with the
    reference's messages (``api.Request``).  ``mesh`` (a data mesh of
    ``device``'s type, ``launch.mesh.make_estimator_mesh``) shards each
    window's chunk range over its shards; the estimate stays
    bit-identical to the unsharded one.

    A one-shot ``Session`` per call: callers with several related
    queries should hold a ``Session`` and let its preprocess cache and
    coalescing windows share the work.
    """
    from ..api import EstimateConfig, Request, Session
    cfg = EstimateConfig(chunk=chunk, Lmax=Lmax,
                         checkpoint_every=checkpoint_every,
                         n_candidates=n_candidates, use_c2=use_c2,
                         use_c3=use_c3, device=device, seed=int(seed))
    session = Session(g, cfg, dev=dev, mesh=mesh)
    handle, = session.submit_many([Request(
        motif=motif, delta=int(delta), k=int(k), seed=int(seed),
        checkpoint_path=checkpoint_path, tree=tree, wts=wts)])
    return handle.result()
