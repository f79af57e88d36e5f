"""Cross-job execution engine: tree cohorts in checkpoint windows.

Torch counterpart of ``repro.core.engine`` (its docstring holds the
design notes) on one device.  Jobs whose trees share a structural
signature, and the same ``Weights`` object, form one **tree cohort**:
their distinct seeds become sample *streams* and their distinct trees
count *lanes*.  Each chunk draws one ``[J, K]`` sample batch through
the lead tree's batched sampler (one tree-sampler launch for all J
streams) and every lane scores that same batch with its own count fn
(``core.sampler.make_cohort_count_fn``); job (seed, tree) reads cell
``[stream, lane]`` of the window sums.

Determinism contract, as the reference's: chunk ``j`` of stream ``i``
draws from ``fold_in(base_keys[i], j)``, never from a lane index, a job
index or the window grid, and the six accumulators are exact int64
sums.  So every cohort cell is bit-identical to a solo run of its motif
at its seed, and a checkpoint ``(chunks_done, acc)`` resumes
bit-identically.  The keys of a ``checkpoint_every``-chunk window are
made on the host and moved to the device in one copy; the sums stay on
the device until the window ends (one host sync per window).

Checkpoints are the reference's JSON ``{motif, delta, seed, chunk,
tree_edges, chunks_done, acc}``, written atomically, matched by the same
predicate and ignored when torn: files cross between the two packages.

Not here (the reference's, to come with later slices of the port): the
mesh, the retry ladder and its degradation rungs, witnesses, obs spans
and the compiled-program LRU (nothing is compiled).  The reference pads
a cohort's stream rows to the group's width only to avoid a retrace;
the port does not pad.
"""
from __future__ import annotations

import json
import os
import time
from collections import OrderedDict
from dataclasses import dataclass, field, fields

import torch

from ..resilience import atomic_write_json
from . import rng
from .estimator import ACC_KEYS, EstimateResult, unbias_estimate
from .motif import TemporalMotif
from .sampler import make_batched_sample_fn, make_cohort_count_fn
from .spanning_tree import SpanningTree, tree_signature
from .weights import Weights


def make_engine_window_fn(trees, chunk: int, Lmax: int, device):
    """``fn(dev, wts, base_keys [J, 2], j0, n) -> {key: [J][M] ints}``:
    chunks ``j0 .. j0+n-1`` of a J-stream, M-lane tree cohort.

    ``trees`` is the tuple of signature-equal lane trees (the first one
    drives sampling).  Per chunk: one batched sampler call, then every
    lane's counts; the sums stay on ``device`` and are read once, at the
    end of the window.
    """
    bs_fn = make_batched_sample_fn(trees[0], chunk, device)
    cc_fn = make_cohort_count_fn(trees, chunk, Lmax=Lmax)
    device = torch.device(device)

    def window(dev, wts, base_keys, j0, n):
        J = base_keys.shape[0]
        keys = rng.fold_in(base_keys[:, None, :],
                           torch.arange(j0, j0 + n)).transpose(0, 1)
        keys = keys.contiguous().to(device)          # [n, J, 2]
        sums = torch.zeros((len(ACC_KEYS), J, len(trees)),
                           dtype=torch.int64, device=device)
        for i in range(n):
            out = cc_fn(dev, wts, bs_fn(dev, wts, keys[i]))
            sums += torch.stack([out[kk] for kk in ACC_KEYS])
        return dict(zip(ACC_KEYS, sums.tolist()))

    return window


@dataclass(frozen=True)
class PlanKey:
    """Fusion key: jobs sharing it (plus Weights identity) form one
    tree cohort."""

    signature: tuple  # spanning_tree.tree_signature of every member tree
    chunk: int
    Lmax: int
    backend: str      # the device type the cohort runs on


@dataclass
class EngineJob:
    """One planned estimation job + its runtime cursor/accumulators."""

    index: int
    motif: TemporalMotif
    delta: int
    k: int
    seed: int
    tree: SpanningTree
    wts: Weights
    checkpoint_path: str | None = None
    # in-memory resume ``(chunks_done, acc)``: the session's adaptive
    # growth rounds continue a job from its previous round's cursor.
    # Takes precedence over ``checkpoint_path`` when set.
    resume: tuple | None = None
    # absolute ``time.monotonic()`` deadline: when it passes mid-run the
    # job stops at its last completed checkpoint window and returns a
    # partial result marked ``degraded`` (never an error)
    deadline_t: float | None = None
    # resolved by plan_jobs
    backend: str = ""
    fallback_reason: str = ""
    degraded: bool = False
    degrade_reason: str = ""
    n_chunks: int = 0
    k_eff: int = 0
    cursor: int = 0
    acc: dict = field(default_factory=dict)
    base_key: torch.Tensor | None = None
    group_size: int = 1
    # the job reads cell ``[stream(seed), lane]`` of its cohort's sums
    lane: int = 0
    # timings (tree_select_s/preprocess_s are filled by the front-ends)
    sampling_s: float = 0.0
    preprocess_s: float = 0.0
    tree_select_s: float = 0.0


@dataclass
class JobGroup:
    key: PlanKey
    wts: Weights
    jobs: list
    # deduped lane trees (first-seen job order; one count fn each) and
    # the number of distinct seed streams
    lane_trees: tuple = ()
    n_streams: int = 1


@dataclass
class ExecutionPlan:
    """Grouped jobs + the window config ``run_plan`` executes."""

    jobs: list          # input order
    groups: list
    dev: dict
    chunk: int
    Lmax: int
    checkpoint_every: int
    dispatches: int = 0


@dataclass
class EngineStats:
    """Process-wide dispatch accounting, with the reference's names.

    ``dispatches``          cohort windows run
    ``fused_dispatches``    windows carrying more than one job
    ``job_windows``         job x window pairs covered
    ``tree_cohorts``        cohort windows dispatched
    ``cohort_motif_lanes``  distinct motif lanes over those windows
    ``samples_shared``      samples consumed without being redrawn
    ``witness_dispatches``  witness windows (none until witnesses land)
    """

    dispatches: int = 0
    fused_dispatches: int = 0
    job_windows: int = 0
    tree_cohorts: int = 0
    cohort_motif_lanes: int = 0
    samples_shared: int = 0
    witness_dispatches: int = 0

    def reset(self) -> None:
        for f in fields(self):
            setattr(self, f.name, 0)

    @property
    def motifs_per_cohort(self) -> float:
        """Mean motif-lane fan-out per cohort window (1.0 = no sharing)."""
        if not self.tree_cohorts:
            return 0.0
        return self.cohort_motif_lanes / self.tree_cohorts


STATS = EngineStats()


def _load_checkpoint(job: EngineJob, chunk: int) -> None:
    """Resume ``(cursor, acc)`` from the job's checkpoint when it matches.

    A torn or corrupt checkpoint is treated as absent: the job starts
    fresh instead of poisoning the run.
    """
    path = job.checkpoint_path
    if not path or not os.path.exists(path):
        return
    try:
        with open(path) as f:
            st = json.load(f)
    except (OSError, ValueError):
        return                      # torn/unreadable: start fresh
    if not isinstance(st, dict) or not all(
            kk in st for kk in ("motif", "delta", "seed", "chunk",
                                "tree_edges", "chunks_done", "acc")):
        return
    if (st["motif"] == job.motif.name and st["delta"] == job.delta
            and st["seed"] == job.seed and st["chunk"] == chunk
            and tuple(st["tree_edges"]) == job.tree.edge_ids
            # a checkpoint from a LARGER budget would divide its counts
            # by this run's smaller k — stale state, start fresh
            and int(st["chunks_done"]) <= job.n_chunks):
        job.acc = {kk: int(st["acc"][kk]) for kk in ACC_KEYS}
        job.cursor = int(st["chunks_done"])


def _write_checkpoint(job: EngineJob, chunk: int) -> None:
    atomic_write_json(
        job.checkpoint_path,
        dict(motif=job.motif.name, delta=job.delta, seed=job.seed,
             chunk=chunk, tree_edges=list(job.tree.edge_ids),
             chunks_done=job.cursor, acc=job.acc))


def plan_jobs(jobs, *, dev: dict, chunk: int = 8192, Lmax: int = 16,
              checkpoint_every: int = 64) -> ExecutionPlan:
    """Load checkpoints and group jobs into tree cohorts.

    ``jobs`` is a list of ``EngineJob``s with identity fields set (index,
    motif, delta, k, seed, tree, wts, checkpoint_path).  Cohorts are
    keyed by ``(tree_signature, chunk, Lmax, device type)`` + Weights
    identity: within one, distinct trees become count lanes
    (``job.lane``) and distinct seeds sample streams.
    """
    backend = dev["t"].device.type
    groups: OrderedDict = OrderedDict()
    for job in jobs:
        job.backend, job.fallback_reason = backend, ""
        job.n_chunks = max(1, -(-job.k // chunk))
        job.k_eff = job.n_chunks * chunk
        job.cursor = 0
        job.acc = {kk: 0 for kk in ACC_KEYS}
        job.base_key = rng.PRNGKey(job.seed)
        if int(job.wts.W_total) == 0:
            job.cursor = job.n_chunks       # nothing to sample
        elif job.resume is not None:
            done, acc = job.resume
            if 0 <= int(done) <= job.n_chunks:
                job.cursor = int(done)
                job.acc = {kk: int(acc[kk]) for kk in ACC_KEYS}
        else:
            _load_checkpoint(job, chunk)
        gkey = (PlanKey(tree_signature(job.tree), int(chunk), int(Lmax),
                        backend), id(job.wts))
        if gkey not in groups:
            groups[gkey] = JobGroup(key=gkey[0], wts=job.wts, jobs=[])
        groups[gkey].jobs.append(job)
    for group in groups.values():
        lanes: dict = {}      # tree -> lane index (first-seen job order)
        for job in group.jobs:
            job.group_size = len(group.jobs)
            job.lane = lanes.setdefault(job.tree, len(lanes))
        group.lane_trees = tuple(lanes)
        group.n_streams = len({job.seed for job in group.jobs})
    return ExecutionPlan(jobs=list(jobs), groups=list(groups.values()),
                         dev=dev, chunk=int(chunk), Lmax=int(Lmax),
                         checkpoint_every=max(1, int(checkpoint_every)))


def _mark_deadline_expired(jobs, chunk) -> list:
    """Split off jobs whose deadline has passed; they stop at their last
    completed checkpoint window (cursor stays put).  Returns survivors."""
    now = time.monotonic()
    live = []
    for job in jobs:
        if job.deadline_t is not None and now >= job.deadline_t:
            job.degraded = True
            job.degrade_reason = (
                f"deadline: stopped at k={job.cursor * chunk} "
                f"of {job.k_eff} (last completed checkpoint window)")
        else:
            live.append(job)
    return live


def run_plan(plan: ExecutionPlan, on_window=None) -> list[EstimateResult]:
    """Execute a plan, one cohort window at a time; results in input job
    order, bit-identical to each job's solo ``estimate()``.

    ``on_window(job, window_sums, j0, n)`` fires once per job per
    completed window, after the job's accumulators and cursor advanced
    (``window_sums`` is THIS window's int sums).

    Within a group, jobs whose next window coincides (same ``(j0, n)``
    on the ``checkpoint_every``-aligned grid) run together: one stream
    row per distinct seed, jobs sharing a seed read the same samples
    (``STATS.samples_shared`` counts what they did not redraw).  Fused
    jobs report the shared window's wall clock as their ``sampling_s``.
    Jobs whose ``deadline_t`` passes stop at their last completed window
    and return partials marked ``degraded``, with the samples actually
    drawn as ``k``.
    """
    ce = plan.checkpoint_every
    device = plan.dev["t"].device
    for group in plan.groups:
        window_fn = make_engine_window_fn(group.lane_trees, plan.chunk,
                                          plan.Lmax, device)
        active = [j for j in group.jobs if j.cursor < j.n_chunks]
        while active:
            active = _mark_deadline_expired(active, plan.chunk)
            cohorts: OrderedDict = OrderedDict()
            for job in active:
                j0 = job.cursor
                n = min(ce - j0 % ce, job.n_chunks - j0)
                cohorts.setdefault((j0, n), []).append(job)
            for (j0, n), cjobs in cohorts.items():
                # stream rows: first-seen dedupe by seed
                row_of: dict = {}
                keys: list = []
                for job in cjobs:
                    if job.seed not in row_of:
                        row_of[job.seed] = len(keys)
                        keys.append(job.base_key)
                t0 = time.perf_counter()
                sums = window_fn(plan.dev, group.wts, torch.stack(keys),
                                 j0, n)
                dt = time.perf_counter() - t0
                plan.dispatches += 1
                STATS.dispatches += 1
                STATS.job_windows += len(cjobs)
                if len(cjobs) > 1:
                    STATS.fused_dispatches += 1
                STATS.tree_cohorts += 1
                STATS.cohort_motif_lanes += len({j.lane for j in cjobs})
                STATS.samples_shared += (plan.chunk * n
                                         * (len(cjobs) - len(keys)))
                for job in cjobs:
                    wsums = {kk: int(sums[kk][row_of[job.seed]][job.lane])
                             for kk in ACC_KEYS}
                    for kk in ACC_KEYS:
                        job.acc[kk] += wsums[kk]
                    job.cursor = j0 + n
                    job.sampling_s += dt
                    if job.checkpoint_path:
                        _write_checkpoint(job, plan.chunk)
                    if on_window is not None:
                        on_window(job, wsums, j0, n)
            active = [j for j in active if j.cursor < j.n_chunks]

    results = []
    for job in sorted(plan.jobs, key=lambda j: j.index):
        W = int(job.wts.W_total)
        # a deadline-degraded job answers for the samples it drew
        k_done = job.cursor * plan.chunk if job.degraded else job.k_eff
        results.append(EstimateResult(
            estimate=unbias_estimate(W, job.acc["cnt2"], k_done),
            W=W, k=k_done, valid=job.acc["valid"],
            fail_vmap=job.acc["fail_vmap"], fail_delta=job.acc["fail_delta"],
            fail_order=job.acc["fail_order"], overflow=job.acc["overflow"],
            cnt2_sum=job.acc["cnt2"], motif=job.motif.name,
            tree_edges=job.tree.edge_ids, delta=int(job.delta),
            preprocess_s=job.preprocess_s, sampling_s=job.sampling_s,
            tree_select_s=job.tree_select_s, sampler_backend=job.backend,
            fallback_reason=job.fallback_reason, fused_jobs=job.group_size,
            degraded=job.degraded, degrade_reason=job.degrade_reason))
    return results
