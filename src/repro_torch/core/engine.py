"""Cross-job execution engine: tree cohorts in checkpoint windows.

Torch counterpart of ``repro.core.engine`` (its docstring holds the
design notes), on one device or a data mesh.  Jobs whose trees share a
structural signature, and the same ``Weights`` object, form one **tree
cohort**: their distinct seeds become sample *streams* and their
distinct trees count *lanes*.  Each chunk draws one ``[J, K]`` sample
batch through the lead tree's batched sampler (one tree-sampler launch
for all J streams) and every lane scores that same batch with its own
count fn (``core.sampler.make_cohort_count_fn``); job (seed, tree)
reads cell ``[stream, lane]`` of the window sums.

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

Witnesses (``EngineJob.witnesses > 0``): after each counted window the
job's witness window re-draws the same chunks with the same keys
(``sampler.make_witness_fn``; on the card a second sampler launch per
chunk), keeps the window's top ``n_wit`` accepted matches by
deterministic priority and merges them into ``job.wit``, keyed by the
edge-id tuple.  A job without witnesses never re-draws.

Resilience (the reference's ladder at ``sampler_backend="xla"``): every
window dispatch runs through a transient-retry loop
(``resilience.retry.DISPATCH_POLICY``, deterministic backoff), and a
window whose retries are spent on a *retryable* failure is split into
halves, each retried the same way, down to one chunk; then the error
raises.  The halves are summed on the host in int64 and chunk ``j``
still draws ``fold_in(base_key, j)``, so every rung is bit-identical.
The window's six sums are copied to the host inside the retry's ``try``
(and inside the ``engine.device`` span): a fault of an asynchronous
launch surfaces at that copy, the window's one host sync, and so meets
the ladder.  There is no backend-swap rung: the port has one route per
device, and swapping a card's kernel for its plain twin would be a
hidden fallback.  A witness window retries the same way.

Telemetry (``repro_torch.obs``): spans ``engine.dispatch`` (per cohort
window) with ``engine.device`` (per attempt) inside it, and
``engine.witness``.  At level ``trace`` each chunk of an attempt adds
stage spans under ``engine.device``, each with attr ``chunk``:
``sampler.draw`` and one ``validate.lane`` per count lane (1 + M spans
for M lanes).  On a card each carries ``device_ms`` from a pair of CUDA
timing events on the current stream, read once the attempt's host copy
has returned, so no sync is added (``obs.device_stages``); a failed
attempt's stage records carry its error and no device time.  Below
``trace`` an attempt reads the level once and opens no stage span and
no event.  Every record made at ``trace`` carries ``ts_ns``, its start
on the profiler's clock.  The profile seam starts and stops around
cohort windows;
``STATS.samples_drawn`` (``repro_engine_samples_drawn_total``) counts
every shard's samples at every level; ``STATS`` is a registry
``CounterBlock``.  All timing goes through ``obs``.

The data mesh (``mesh=``, ``launch.mesh.EstimatorMesh``): one process,
one shard per entry of ``mesh.devices``, as the reference's
single-controller ``shard_map``.  Shard ``d`` of ``D`` runs window
offsets ``d, d + D, ...`` below ``n`` on its own device (an offset past
``n`` is never launched), keys folded on the host for its own offsets
only; the shards' launches interleave chunk by chunk, so shards sharing
a card run as one stream of chunks, in order, and one chunk's
temporaries are live at a time whatever ``D``.  Each shard's ``[6, J,
M]`` sums are copied to the host inside the dispatch's retry (a fault
on any shard fails the whole window, which retries and halves as one)
and summed there in int64 in shard order (``dist.collectives.
combine``): the result is bit-identical on any mesh shape, and a
checkpoint, which records no mesh, resumes across shapes.  Every
distinct device of the mesh gets one exact copy of the graph arrays and
of each cohort's Weights per plan (none where it is the lead copy's);
the cohort key stays the lead copy's identity.  Without a mesh the
engine is the one-shard case.  Witness windows run unsharded on shard
0's device.  ``STATS.dispatches`` counts the mesh-wide window.

Not here: the compiled-program LRU (nothing is compiled).  The
reference pads a cohort's stream rows to the group's width only to
avoid a retrace; the port does not pad.
"""
from __future__ import annotations

import json
import os
import time
from collections import OrderedDict
from dataclasses import dataclass, field

import torch

from .. import obs
from ..dist.collectives import combine, folded_axis_index
from ..dist.sharding import data_axes, n_data
from ..resilience import STATS as RSTATS
from ..resilience import atomic_write_json, fire, is_retryable
from ..resilience.retry import DISPATCH_POLICY, backoff_delay
from . import rng
from .estimator import ACC_KEYS, EstimateResult, unbias_estimate
from .motif import TemporalMotif
from .sampler import (WITNESS_SENTINEL, make_batched_sample_fn,
                      make_cohort_count_fn, make_witness_fn)
from .spanning_tree import SpanningTree, tree_signature
from .weights import Weights


def shard_devices(mesh, device) -> tuple:
    """The device of every shard: ``(device,)`` without a mesh, else
    ``mesh.devices``.  Raises the reference's ``ValueError`` for a mesh
    whose devices do not all lie on one ``"data"`` axis, and a
    ``ValueError`` when the mesh's devices are not of ``device``'s
    type."""
    device = torch.device(device)
    if mesh is None:
        return (device,)
    if data_axes(mesh) != ("data",) or n_data(mesh) != mesh.size:
        raise ValueError(
            f"engine meshes must be data-only (axes {mesh.axis_names}, "
            f"data extent {n_data(mesh)} of {mesh.size} devices): chunks "
            "round-robin over data_axes and any other axis would "
            "recompute every chunk per shard — build one with "
            "launch.mesh.make_estimator_mesh")
    devices = tuple(torch.device(d) for d in mesh.devices)
    if {d.type for d in devices} != {device.type}:
        raise ValueError(f"mesh devices {[str(d) for d in devices]} do not "
                         f"match the session's device {device}")
    return devices


def make_engine_window_fn(trees, chunk: int, Lmax: int, device, mesh=None):
    """``fn(shards, base_keys [J, 2], j0, n) -> [int64 [6, J, M], ...]``:
    chunks ``j0 .. j0+n-1`` of a J-stream, M-lane tree cohort, one
    ``[6, J, M]`` sum (``ACC_KEYS`` order) per shard, on its device.

    ``trees`` is the tuple of signature-equal lane trees (the first one
    drives sampling); ``shards`` holds every shard's ``(dev, wts)`` on
    its own device (``shard_devices(mesh, device)``).  Shard ``d`` of
    ``D`` runs offsets ``d + i * D < n``; per chunk one batched sampler
    call, then every lane's counts.  Shards interleave chunk by chunk
    and an offset past ``n`` is never launched.  The sums stay on the
    devices (the caller reads them once, at the end of the window).
    Each chunk points the attempt's stage spans, if any, at its index
    (``obs.stages_at``).
    """
    devices = shard_devices(mesh, device)
    D = len(devices)
    bs_fns = {d: make_batched_sample_fn(trees[0], chunk, d)
              for d in dict.fromkeys(devices)}
    cc_fn = make_cohort_count_fn(trees, chunk, Lmax=Lmax)

    def window(shards, base_keys, j0, n):
        J = base_keys.shape[0]
        keys, sums, firsts = [], [], []
        for d, on in enumerate(devices):
            firsts.append(folded_axis_index(mesh, ("data",), {"data": d}))
            offs = torch.arange(n)[firsts[d]::D]
            keys.append(rng.fold_in(base_keys[:, None, :], j0 + offs)
                        .transpose(0, 1).contiguous().to(on))  # [slots, J, 2]
            sums.append(torch.zeros((len(ACC_KEYS), J, len(trees)),
                                    dtype=torch.int64, device=on))
        for i in range(-(-n // D)):
            for d, on in enumerate(devices):
                if i >= len(keys[d]):
                    continue                 # offset d + i * D >= n
                if i == 0:
                    fire("engine.shard", tag=f"{on.type}:{d}")
                dev, wts = shards[d]
                obs.stages_at(on, j0 + firsts[d] + i * D)   # chunk index
                out = cc_fn(dev, wts, bs_fns[on](dev, wts, keys[d][i]))
                sums[d] += torch.stack([out[kk] for kk in ACC_KEYS])
        return sums

    return window


_WIT_KEYS = ("prio", "eids", "src", "dst", "t", "cnt2")


def _witness_width(n: int) -> int:
    """The reservoir width the reference compiles for ``witnesses=n``: a
    power of two, floor 4 (the host trims back to ``n``).  Kept so the
    window's top rows are the reference's."""
    return max(4, 1 << (int(n) - 1).bit_length())


def make_witness_window_fn(tree, chunk: int, Lmax: int, n_wit: int, device):
    """``fn(dev, wts, base_key, j0, n, seed) -> dict`` of tensors on
    ``device``: scan chunks ``j0 .. j0+n-1`` merging each chunk's witness
    reservoir (``sampler.make_witness_fn``) into the window's top
    ``n_wit``.

    Chunk ``j`` re-draws from ``fold_in(base_key, j)``, the key the
    counting path used, so witnesses come from the instances the
    estimate counted.  The merge is a stable sort of the carry followed
    by the chunk's rows, as the reference's scan, so the window's top
    ``n_wit`` is the reference's row for row.
    """
    w_fn = make_witness_fn(tree, chunk, device, Lmax=Lmax, n_wit=n_wit)
    S = tree.num_edges
    device = torch.device(device)

    def window(dev, wts, base_key, j0, n, seed):
        keys = rng.fold_in(base_key, torch.arange(j0, j0 + n)).to(device)
        carry = dict(prio=torch.full((n_wit,), WITNESS_SENTINEL,
                                     dtype=torch.int64, device=device),
                     **{kk: torch.zeros((n_wit, S), dtype=torch.int64,
                                        device=device)
                        for kk in ("eids", "src", "dst", "t")},
                     cnt2=torch.zeros(n_wit, dtype=torch.int64,
                                      device=device))
        for i in range(n):
            out = w_fn(dev, wts, keys[i], j0 + i, seed)
            prio = torch.cat([carry["prio"], out["prio"]])
            order = torch.argsort(prio, stable=True)[:n_wit]
            carry = {kk: torch.cat([carry[kk], out[kk]])[order]
                     for kk in _WIT_KEYS}
            STATS.witness_chunks += 1
        return carry

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
    # absolute ``obs.monotonic()`` deadline: when it passes mid-run the
    # job stops at its last completed checkpoint window and returns a
    # partial result marked ``degraded`` (never an error)
    deadline_t: float | None = None
    # witness capture: keep up to this many accepted full-match edge
    # tuples (deterministic reservoir, ``sampler.witness_priority``).
    # 0 = no witness window at all (the count path never pays for it).
    witnesses: int = 0
    # merged witness reservoir, keyed by the edge-id tuple: the same
    # match sampled in several chunks collapses to its best priority
    wit: dict = field(default_factory=dict)
    # resolved by plan_jobs
    backend: str = ""
    fallback_reason: str = ""
    degraded: bool = False
    degrade_reason: str = ""
    # runtime degradation ladder state: 0 = dispatch whole windows; a
    # positive value caps the chunks per dispatch (execution only: the
    # chunk -> fold_in key map and the checkpoint grid are untouched)
    max_window: int = 0
    n_chunks: int = 0
    k_eff: int = 0
    cursor: int = 0
    acc: dict = field(default_factory=dict)
    base_key: torch.Tensor | None = None
    group_size: int = 1
    # the job reads cell ``[stream(seed), lane]`` of its cohort's sums
    lane: int = 0
    # obs trace id of the request that planned this job (None when the
    # caller runs untraced); dispatch spans report it
    trace: str | None = None
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
    # every shard's (dev, wts) on its device, made once per plan by
    # ExecutionPlan.shard_inputs (the lead objects where a shard shares
    # their device)
    shards: tuple = ()


@dataclass
class ExecutionPlan:
    """Grouped jobs + the mesh/window config ``run_plan`` executes."""

    jobs: list          # input order
    groups: list
    dev: dict
    mesh: object
    devices: tuple      # every shard's device (``shard_devices``)
    chunk: int
    Lmax: int
    checkpoint_every: int
    dispatches: int = 0
    # the graph arrays on each distinct shard device (exact copies)
    devs: dict = field(default_factory=dict)

    @property
    def mesh_shape(self) -> tuple | None:
        if self.mesh is None:
            return None
        return tuple(int(self.mesh.shape[a]) for a in self.mesh.axis_names)

    def shard_inputs(self, group: "JobGroup") -> tuple:
        """Every shard's ``(dev, wts)`` for ``group``: the lead copies on
        their own device, one exact copy on each other distinct device
        (made at the group's first call and kept by the plan alone)."""
        if not group.shards:
            wts_on = {group.wts.W_total.device: group.wts}
            for on in self.devices:
                if on not in self.devs:
                    self.devs[on] = {kk: v.to(on)
                                     for kk, v in self.dev.items()}
                if on not in wts_on:
                    wts_on[on] = group.wts.to(on)
            group.shards = tuple((self.devs[on], wts_on[on])
                                 for on in self.devices)
        return group.shards


_WITNESS_SECONDS = obs.REGISTRY.counter(
    "repro_engine_witness_seconds_total",
    "wall seconds in witness windows, device synced")


class EngineStats(obs.CounterBlock):
    """Process-wide dispatch accounting, with the reference's names: a
    registry ``CounterBlock`` (``repro_engine_*_total``, monotonic;
    ``reset()`` is a test seam).

    ``dispatches``          window dispatches launched (halved windows
                            count each part)
    ``fused_dispatches``    cohort windows carrying more than one job
    ``job_windows``         job x window pairs covered
    ``tree_cohorts``        cohort windows dispatched
    ``cohort_motif_lanes``  distinct motif lanes over those windows
    ``samples_shared``      samples consumed without being redrawn
    ``samples_drawn``       samples drawn by count windows, one per
                            stream row and chunk (the port's own; its
                            rate is the sampler's samples/s)
    ``witness_dispatches``  witness windows run
    ``witness_chunks``      chunks re-drawn by witness windows (the
                            port's own: on the card one sampler launch
                            each, apart from the counting path's)
    ``witness_s``           wall seconds in witness windows, device
                            synced (the port's own; a float counter,
                            read-only here)
    """

    _PREFIX = "repro_engine"
    _FIELDS = ("dispatches", "fused_dispatches", "job_windows",
               "tree_cohorts", "cohort_motif_lanes", "samples_shared",
               "samples_drawn", "witness_dispatches", "witness_chunks")
    _DOCS = {
        "dispatches": "window dispatches launched",
        "fused_dispatches": "cohort windows carrying more than one job",
        "job_windows": "job x window pairs covered",
        "tree_cohorts": "cohort windows dispatched",
        "cohort_motif_lanes": "distinct motif lanes over cohort windows",
        "samples_shared": "samples consumed without being redrawn",
        "samples_drawn": "samples drawn by count windows (every shard)",
        "witness_dispatches": "witness reservoir windows run",
        "witness_chunks": "chunks re-drawn by witness windows",
    }

    @property
    def witness_s(self) -> float:
        return _WITNESS_SECONDS.value

    def reset(self) -> None:
        """Zero the block — TEST-ONLY seam."""
        super().reset()
        _WITNESS_SECONDS._reset()

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


def _run_witness_window(fn, plan, group, job, j0, n) -> None:
    """Run one job's witness window ``fn`` (``make_witness_window_fn``,
    built once per job) over a counted window and merge its top rows
    into ``job.wit``.

    Transient failures retry like count dispatches (the rows are copied
    to the host inside the ``try``).  ``job.wit`` keeps every per-window
    survivor at its best (smallest) priority and is never trimmed here,
    so an adaptive run split into resume rounds merges to the same set
    as one uninterrupted run.
    """
    def attempt():
        out = fn(*plan.shard_inputs(group)[0], job.base_key, j0, n,
                 job.seed)
        return {kk: out[kk].tolist() for kk in _WIT_KEYS}

    with obs.span("engine.witness", trace=job.trace, backend=job.backend,
                  j0=int(j0), n=int(n)) as sp:
        out = _retrying("engine.witness", job.backend, j0, attempt)
    _WITNESS_SECONDS.inc(sp.elapsed_s)
    STATS.witness_dispatches += 1
    width = len(out["prio"])
    # present edges in motif (pi) order, not tree-local order
    rank_order = sorted(range(job.tree.num_edges),
                        key=lambda s: job.tree.edge_ids[s])
    for i in range(width):
        p = out["prio"][i]
        if p >= WITNESS_SENTINEL:
            break                      # sorted: the rest are padding
        eid_row = tuple(out["eids"][i])
        cur = job.wit.get(eid_row)
        if cur is None or p < cur["prio"]:
            job.wit[eid_row] = dict(
                prio=p, cnt=out["cnt2"][i],
                edges=tuple((out["src"][i][s], out["dst"][i][s],
                             out["t"][i][s]) for s in rank_order))


def witness_entries(wit: dict, n: int) -> tuple:
    """A merged witness reservoir as the public payload: up to ``n``
    entries ordered by reservoir priority, each ``{"edges": ((src, dst,
    t), ...), "cnt": ..., "prio": ...}`` with the tree's edges in motif
    (pi) order (the reference's format; JSON-safe)."""
    top = sorted(wit.values(), key=lambda e: e["prio"])[:max(0, int(n))]
    return tuple(dict(edges=e["edges"], cnt=e["cnt"], prio=e["prio"])
                 for e in top)


def plan_jobs(jobs, *, dev: dict, chunk: int = 8192, Lmax: int = 16,
              checkpoint_every: int = 64, mesh=None) -> ExecutionPlan:
    """Load checkpoints and group jobs into tree cohorts.

    ``jobs`` is a list of ``EngineJob``s with identity fields set (index,
    motif, delta, k, seed, tree, wts, checkpoint_path).  Cohorts are
    keyed by ``(tree_signature, chunk, Lmax, device type)`` + Weights
    identity: within one, distinct trees become count lanes
    (``job.lane``) and distinct seeds sample streams.  ``mesh`` (a
    data mesh of ``dev``'s device type) shards every window's chunks.
    """
    devices = shard_devices(mesh, dev["t"].device)
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
                         dev=dev, mesh=mesh, devices=devices,
                         devs={dev["t"].device: dev},
                         chunk=int(chunk), Lmax=int(Lmax),
                         checkpoint_every=max(1, int(checkpoint_every)))


def _retrying(site: str, tag: str, j0: int, attempt):
    """``attempt()`` behind the ``site`` fault-injection point, with the
    transient-retry loop: ``classify() == retryable`` failures are
    retried up to the policy's attempt budget with deterministically
    jittered backoff (seeded by the window's ``j0``).  Non-retryable
    failures and spent budgets raise to the caller."""
    for i in range(DISPATCH_POLICY.max_attempts):
        try:
            fire(site, tag=tag)
            return attempt()
        except Exception as e:
            if not is_retryable(e):
                raise
            RSTATS.retries += 1
            if i == DISPATCH_POLICY.max_attempts - 1:
                raise
            time.sleep(backoff_delay(DISPATCH_POLICY, i, seed=int(j0)))


def _attempt_dispatch(window_fn, shards, base_keys, j0, n, backend):
    """One mesh-wide window dispatch through the retry loop; returns the
    window's sums as a host int64 tensor ``[6, J, M]``.  Every shard's
    sums are copied to the host and combined inside the loop: a fault of
    an asynchronous launch on any shard surfaces at its copy, so it
    fails the whole window and meets the retries and the ladder.  At
    level ``trace`` the attempt's stage spans are read and recorded
    after that copy (``obs.device_stages``)."""
    def attempt():
        with obs.span("engine.device", stage="device", backend=backend,
                      j0=int(j0), n=int(n)), obs.device_stages():
            return combine(window_fn(shards, base_keys, j0, n))

    return _retrying("engine.dispatch", backend, j0, attempt)


def _run_cohort_window(plan, group, get_fn, cjobs, base_keys, j0, n):
    """Dispatch one cohort window through the degradation ladder.

    Rungs, each taken only after the retry budget at the current one is
    spent on a *retryable* failure: the whole window, then windows
    halved again and again (``max_window`` chunks per dispatch, summed
    on the host in int64) down to one chunk; then the last error raises.
    Purely an execution change: chunk ``j`` still draws ``fold_in(
    base_key, j)`` and the checkpoint grid is untouched, so every rung
    is bit-identical.  (The reference's ``pallas -> xla`` swap has no
    counterpart: the port has one route per device.)

    Returns ``(sums, n_dispatches)`` and records the rung on the cohort's
    jobs (``max_window`` / ``fallback_reason``).
    """
    backend = cjobs[0].backend
    max_window = cjobs[0].max_window
    shards = plan.shard_inputs(group)
    while True:
        try:
            window_fn = get_fn()
            if not max_window or max_window >= n:
                return _attempt_dispatch(window_fn, shards, base_keys,
                                         j0, n, backend), 1
            total = None
            parts = 0
            done = 0
            while done < n:
                step = min(max_window, n - done)
                part = _attempt_dispatch(window_fn, shards, base_keys,
                                         j0 + done, step, backend)
                parts += 1
                total = part if total is None else total + part
                done += step
            return total, parts
        except Exception as e:
            if not is_retryable(e):
                raise
            cur = max_window if max_window and max_window < n else n
            if cur <= 1:
                raise           # smallest dispatch still failing
            max_window = cur // 2
            reason = f"ladder: dispatch window halved to {max_window} " \
                     "chunks after repeated transient failure"
            RSTATS.ladder_steps += 1
            for job in cjobs:
                job.max_window = max_window
                job.fallback_reason = (job.fallback_reason + "; " + reason
                                       if job.fallback_reason else reason)


def _mark_deadline_expired(jobs, chunk) -> list:
    """Split off jobs whose deadline has passed; they stop at their last
    completed checkpoint window (cursor stays put).  Returns survivors."""
    now = obs.monotonic()
    live = []
    for job in jobs:
        if job.deadline_t is not None and now >= job.deadline_t:
            job.degraded = True
            job.degrade_reason = (
                f"deadline: stopped at k={job.cursor * chunk} "
                f"of {job.k_eff} (last completed checkpoint window)")
            RSTATS.deadline_degraded += 1
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
    on the ``checkpoint_every``-aligned grid, and the same ladder rung)
    run together: one stream row per distinct seed, jobs sharing a seed
    read the same samples (``STATS.samples_shared`` counts what they did
    not redraw).  Fused jobs report the shared window's wall clock as
    their ``sampling_s``.  Every window goes through the retry ladder
    (``_run_cohort_window``); a laddered job records its rung in
    ``fallback_reason`` and peels into its own cohorts, so fused
    siblings never inherit it.  Jobs whose ``deadline_t`` passes stop at
    their last completed window and return partials marked ``degraded``,
    with the samples actually drawn as ``k``.
    """
    ce = plan.checkpoint_every
    device = plan.devices[0]
    on_card = device.type == "cuda"
    for group in plan.groups:
        built: list = []

        def get_fn(_group=group, _built=built):
            # built at the group's first dispatch, behind its fault site
            if not _built:
                fire("sampler.call", tag=device.type)
                _built.append(make_engine_window_fn(
                    _group.lane_trees, plan.chunk, plan.Lmax, device,
                    mesh=plan.mesh))
            return _built[0]

        witness_fns = {
            id(job): make_witness_window_fn(
                job.tree, plan.chunk, plan.Lmax,
                _witness_width(job.witnesses), device)
            for job in group.jobs if job.witnesses}
        active = [j for j in group.jobs if j.cursor < j.n_chunks]
        while active:
            active = _mark_deadline_expired(active, plan.chunk)
            cohorts: OrderedDict = OrderedDict()
            for job in active:
                j0 = job.cursor
                n = min(ce - j0 % ce, job.n_chunks - j0)
                # laddered jobs peel into their own cohorts so fused
                # siblings never inherit their rung
                cohorts.setdefault((j0, n, job.max_window),
                                   []).append(job)
            for (j0, n, _), cjobs in cohorts.items():
                # stream rows: first-seen dedupe by seed
                row_of: dict = {}
                keys: list = []
                for job in cjobs:
                    if job.seed not in row_of:
                        row_of[job.seed] = len(keys)
                        keys.append(job.base_key)
                profiling = obs.profile_armed()
                if profiling:
                    obs.profile_window_start(cuda=on_card)
                with obs.span("engine.dispatch", stage="dispatch",
                              trace=cjobs[0].trace,
                              backend=cjobs[0].backend, j0=int(j0),
                              n=int(n), jobs=len(cjobs),
                              streams=len(keys), rung=cjobs[0].max_window,
                              shards=len(plan.devices),
                              plan_key=str(group.key.signature)) as sp:
                    sums, n_disp = _run_cohort_window(
                        plan, group, get_fn, cjobs, torch.stack(keys),
                        j0, n)
                    sp.set(dispatches=n_disp)
                if profiling:
                    obs.profile_window_end()
                dt = sp.elapsed_s
                sums = dict(zip(ACC_KEYS, sums.tolist()))
                plan.dispatches += n_disp
                STATS.dispatches += n_disp
                STATS.job_windows += len(cjobs)
                if len(cjobs) > 1:
                    STATS.fused_dispatches += 1
                STATS.tree_cohorts += 1
                STATS.cohort_motif_lanes += len({j.lane for j in cjobs})
                STATS.samples_shared += (plan.chunk * n
                                         * (len(cjobs) - len(keys)))
                STATS.samples_drawn += plan.chunk * n * len(keys)
                for job in cjobs:
                    wsums = {kk: int(sums[kk][row_of[job.seed]][job.lane])
                             for kk in ACC_KEYS}
                    for kk in ACC_KEYS:
                        job.acc[kk] += wsums[kk]
                    job.cursor = j0 + n
                    job.sampling_s += dt
                    if job.witnesses:
                        _run_witness_window(witness_fns[id(job)], plan,
                                            group, job, j0, n)
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
            fallback_reason=job.fallback_reason,
            mesh_shape=plan.mesh_shape, fused_jobs=job.group_size,
            degraded=job.degraded, degrade_reason=job.degrade_reason,
            witnesses=(witness_entries(job.wit, job.witnesses)
                       if job.witnesses else None)))
    return results
