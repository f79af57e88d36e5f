"""Long-lived estimation sessions: resident graph, coalescing submit
windows, progressive streaming and error-targeted adaptive budgets.

Torch counterpart of ``repro.api.session`` (its docstring holds the
design notes).  A :class:`Session` owns what is expensive to rebuild
between requests over one temporal graph: the device upload and the
``(tree_signature, delta, wd, use_c2)`` preprocess cache (a
``core.batch.BatchPlanner``).

``submit(Request) -> Handle`` enqueues a request into the current
coalescing window.  The window drains through
``core.engine.plan_jobs``/``run_plan`` when it has been open
``config.coalesce_window_s`` seconds, when ``coalesce_max_requests``
are pending, or when a handle's ``result()``/``stream()`` forces a
flush.  Requests draining together that share a plan key and Weights
fuse into one tree cohort: one sample stream per distinct seed, scored
by every member motif's own count lane.

Determinism contract (the engine's): chunk ``j`` of a request always
draws from ``fold_in(PRNGKey(seed), j)``, so a coalesced, fused or
adaptive result is bit-identical to a solo ``estimate()`` with the same
seed and final budget.

Adaptive budgets: a request with ``target_rse`` starts at its ``k`` and
grows the budget by ``config.rse_growth`` until the batch-means relative
standard error over checkpoint windows meets the target or ``k_max`` is
hit; growth rounds RESUME (``EngineJob.resume``) and never redraw a
chunk.  Deadlines use ``obs.monotonic``.

Witnesses: ``Request.witnesses = n`` asks for up to ``n`` accepted
full-match edge tuples beside the count; the handle merges the engine's
reservoir across adaptive rounds (least priority per edge-id tuple), so
an adaptive result carries the witnesses of one uninterrupted run at its
final budget.

Telemetry (``repro_torch.obs``): ``submit`` is an intake point (the
handle inherits the ambient trace id or mints one at the ``trace``
level); a drain records the ``session.drain`` span, plan resolution
``session.preprocess``, the submit-to-drain wait the ``queue_wait``
stage, and each window a ``request.window`` event (the RSE-vs-samples
trajectory).

The data mesh: ``Session(..., mesh=launch.mesh.make_estimator_mesh())``
shards every window's chunk range over the mesh's shards
(``core.engine``); results are bit-identical to the meshless ones.  The
planner's weight DP runs once, on shard 0's device (the mesh's device
type must be the config's); each drain's plan copies the graph and
Weights once to every other distinct device of the mesh and drops the
copies with the plan.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, Sequence

from .. import obs
from ..core.batch import BatchPlanner
from ..core.engine import shard_devices, witness_entries
from ..core.estimator import EstimateResult
from ..core.graph import TemporalGraph
from ..core.motif import TemporalMotif, get_motif
from ..core.spanning_tree import SpanningTree
from ..core.weights import Weights
from .config import EstimateConfig

#: reservoir-width ceiling for ``Request.witnesses`` (the reference's)
MAX_WITNESSES = 64


@dataclass(frozen=True, eq=False)
class Request:
    """One count query: ``motif`` under window ``delta`` with ``k`` samples.

    ``motif`` may be a catalog name ("M5-3"), an inline edge-list spec
    ("0-1,1-2,2-0") or a ``TemporalMotif``.  ``seed=None`` inherits the
    session config's seed.

    ``target_rse`` turns the run adaptive: ``k`` becomes the initial
    budget and grows until the empirical relative standard error meets
    the target or ``k_max`` (default ``config.k_max_factor * k``).

    ``deadline_s`` is a soft wall-clock budget (seconds from submit):
    when it expires mid-run the request stops at its last completed
    checkpoint window and ``result()`` returns a partial marked
    ``degraded=True`` — never an error.

    ``witnesses=n`` asks for up to ``n`` accepted full-match edge tuples
    alongside the count (``EstimateResult.witnesses``; each per-window
    :class:`Progress` snapshot carries the running top ``n``).  Witness
    capture re-draws the chunks the estimate counted (same keys,
    priorities from ``(seed, chunk, position)`` alone), so the count
    stays bit-identical and the witnesses are cohort-invariant.

    ``tree``/``wts`` are the injection seam the ``estimate()`` shim
    uses: a fixed spanning tree skips Alg. 7, precomputed ``Weights``
    skip preprocessing.
    """

    motif: TemporalMotif | str
    delta: int
    k: int
    seed: int | None = None
    target_rse: float | None = None
    k_max: int | None = None
    checkpoint_path: str | None = None
    deadline_s: float | None = None
    witnesses: int = 0
    tree: SpanningTree | None = None
    wts: Weights | None = None

    def __post_init__(self) -> None:
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.delta < 0:
            raise ValueError(f"delta must be >= 0, got {self.delta}")
        if self.target_rse is not None and not self.target_rse > 0:
            raise ValueError(f"target_rse must be > 0, got {self.target_rse}")
        if self.k_max is not None and self.k_max < self.k:
            raise ValueError(f"k_max ({self.k_max}) must be >= k ({self.k})")
        if self.deadline_s is not None and not self.deadline_s > 0:
            raise ValueError(
                f"deadline_s must be > 0, got {self.deadline_s}")
        if not 0 <= self.witnesses <= MAX_WITNESSES:
            raise ValueError(f"witnesses must be in [0, {MAX_WITNESSES}], "
                             f"got {self.witnesses}")


@dataclass(frozen=True)
class Progress:
    """One per-checkpoint-window snapshot of a running estimate."""

    window: int        # 0-based completed-window index for this request
    k_done: int        # samples drawn so far
    cnt2_sum: int      # cumulative count accumulator
    estimate: float    # W * cnt2_sum / (2 * k_done)
    rse: float         # batch-means RSE over windows so far (inf if < 2)
    # running top-n witness entries (None unless Request.witnesses > 0)
    witnesses: tuple | None = None


@dataclass
class SessionStats:
    """Per-session serving counters (``Session.stats``)."""

    submitted: int = 0
    completed: int = 0
    drains: int = 0            # coalescing windows drained
    dispatches: int = 0        # engine cohort windows run
    adaptive_rounds: int = 0   # extra budget-growth rounds executed


class Handle:
    """A submitted request's future: ``result()``, ``stream()``, ``rse``.

    Handles complete when their coalescing window drains.  All methods
    are synchronous.
    """

    def __init__(self, session: "Session", request: Request):
        self.session = session
        self.request = request
        self.done = False
        self._result: EstimateResult | None = None
        self._error: BaseException | None = None
        self._progress: list[Progress] = []
        self._windows: list[tuple[int, int]] = []   # (S_i, k_i) batches
        # witness reservoir merged across adaptive rounds (least priority
        # per edge-id tuple: the union equals one uninterrupted run's)
        self._wit: dict = {}
        # resolved lazily at first drain
        self._motif: TemporalMotif | None = None
        self._tree: SpanningTree | None = None
        self._wts: Weights | None = None
        self._tree_select_s = 0.0
        self._preprocess_s = 0.0
        self._k_total = int(request.k)
        self._resume: tuple[int, dict] | None = None
        # obs identity: inherit the ambient trace (a serve loop's intake
        # minted one) or mint here: Session.submit is an intake point
        self._trace = obs.current_trace() or (
            obs.new_trace() if obs.enabled(obs.TRACE) else None)
        self._submit_t = obs.monotonic()
        self._queue_wait_seen = False
        # absolute monotonic deadline, fixed at SUBMIT time
        self._deadline_t = (None if request.deadline_s is None
                            else obs.monotonic() + request.deadline_s)

    # -- public surface --------------------------------------------------
    def result(self) -> EstimateResult:
        """Block until this request has drained; return its result.

        Raises ``RuntimeError`` (chaining the cause) when the drain this
        request belonged to failed.
        """
        if not self.done:
            self.session.flush()
        if self._error is not None:
            raise RuntimeError(
                f"request failed during session drain: {self._error}"
            ) from self._error
        assert self._result is not None
        return self._result

    def stream(self) -> Iterator[Progress]:
        """Per-checkpoint-window progressive estimates, oldest first.

        Forces the drain if the request is still queued (at CALL time),
        then yields one :class:`Progress` per window this session
        executed (the last one agrees with ``result()``).
        """
        if not self.done:
            self.session.flush()
        if self._error is not None:
            raise RuntimeError(
                f"request failed during session drain: {self._error}"
            ) from self._error
        return iter(self._progress)

    @property
    def windows(self) -> int:
        """Checkpoint windows completed so far."""
        return len(self._progress)

    @property
    def rse(self) -> float:
        """Empirical batch-means RSE over the windows executed so far."""
        return self._current_rse()

    # -- session-internal ------------------------------------------------
    def _on_window(self, job, wsums: dict, j0: int, n: int) -> None:
        chunk = self.session.config.chunk
        self._windows.append((int(wsums["cnt2"]), n * chunk))
        k_done = (j0 + n) * chunk
        W = int(job.wts.W_total)
        cnt2 = int(job.acc["cnt2"])
        wit = None
        if job.witnesses:
            for eid_row, e in job.wit.items():
                cur = self._wit.get(eid_row)
                if cur is None or e["prio"] < cur["prio"]:
                    self._wit[eid_row] = e
            wit = witness_entries(self._wit, job.witnesses)
        rse = self._current_rse()
        self._progress.append(Progress(
            window=len(self._progress), k_done=k_done, cnt2_sum=cnt2,
            estimate=W * cnt2 / (2.0 * k_done), rse=rse,
            witnesses=wit))
        if obs.enabled(obs.TRACE):
            # per-request RSE-vs-samples trajectory point (flight recorder)
            obs.event("request.window", trace=self._trace, k_done=k_done,
                      cnt2=cnt2, rse=(rse if math.isfinite(rse) else None))

    def _current_rse(self) -> float:
        if self._wts is not None and int(self._wts.W_total) == 0:
            return 0.0           # the zero estimate is exact
        wins = self._windows
        if len(wins) < 2:
            return math.inf
        tot_S = sum(S for S, _ in wins)
        if tot_S <= 0:
            return math.inf
        tot_k = sum(kw for _, kw in wins)
        mu = tot_S / tot_k
        n = len(wins)
        var_batch = sum((S - kw * mu) ** 2 for S, kw in wins) / (n - 1)
        return math.sqrt(n * var_batch) / tot_S

    def _k_cap(self) -> int:
        if self.request.k_max is not None:
            return int(self.request.k_max)
        return int(self.request.k) * self.session.config.k_max_factor


class Session:
    """A persistent estimation service over one resident temporal graph::

        with Session(graph, EstimateConfig(chunk=4096)) as s:
            h1 = s.submit(Request("M5-3", delta=4_000, k=1 << 16))
            h2 = s.submit(Request("M5-1", delta=4_000, k=1 << 16))
            print(h1.result().estimate, h2.result().estimate)

    ``planner`` injects an existing ``BatchPlanner`` (its preprocess
    cache then outlives this session); ``dev`` injects an existing
    device upload.  The config's ``device`` ("cuda" by default) is where
    the graph lives and the kernels run.  ``mesh`` (a data mesh of that
    device type, ``launch.mesh.make_estimator_mesh``) shards every
    window's chunk range; the graph then lives on shard 0's device.
    """

    def __init__(self, g: TemporalGraph, config: EstimateConfig | None = None,
                 *, dev: dict | None = None, mesh=None,
                 planner: BatchPlanner | None = None):
        self.g = g
        self.config = (config or EstimateConfig()).resolve()
        lead = shard_devices(mesh, self.config.device)[0]
        self.mesh = mesh
        if planner is None:
            planner = BatchPlanner(
                g, dev=dev, n_candidates=self.config.n_candidates,
                roots_per_tree=self.config.roots_per_tree,
                use_c2=self.config.use_c2, use_c3=self.config.use_c3,
                device=lead)
        self.planner = planner
        self.dev = planner.dev
        self.stats = SessionStats()
        self._pending: list[Handle] = []
        self._window_opened = 0.0
        self._closed = False

    # -- lifecycle -------------------------------------------------------
    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Drain anything pending and refuse further submits."""
        if not self._closed:
            self.flush()
            self._closed = True

    # -- submission ------------------------------------------------------
    def submit(self, request: Request) -> Handle:
        """Enqueue a request into the current coalescing window.

        The window drains at once when full (``coalesce_max_requests``)
        or stale (open longer than ``coalesce_window_s`` when this submit
        arrives); otherwise the request waits to fuse with its
        window-mates until the next drain trigger.
        """
        if self._closed:
            raise RuntimeError("Session is closed")
        if (self._pending
                and obs.monotonic() - self._window_opened
                >= self.config.coalesce_window_s):
            self.flush()                       # time-closed window
        if not self._pending:
            # a fresh clock read: the flush above ran a whole window
            self._window_opened = obs.monotonic()
        handle = Handle(self, request)
        self._pending.append(handle)
        self.stats.submitted += 1
        if len(self._pending) >= self.config.coalesce_max_requests:
            self.flush()                       # count-closed window
        return handle

    def submit_many(self, requests: Sequence[Request]) -> list[Handle]:
        """Enqueue a pre-formed batch as ONE window (no mid-batch close).

        The shims (``estimate``/``estimate_many``) use this so a batch
        always plans as a single unit whatever the coalescing config.
        """
        if self._closed:
            raise RuntimeError("Session is closed")
        handles = [Handle(self, r) for r in requests]
        if not self._pending:
            self._window_opened = obs.monotonic()
        self._pending.extend(handles)
        self.stats.submitted += len(handles)
        return handles

    def window_age(self) -> float | None:
        """Seconds the current coalescing window has been open (None when
        nothing is pending): serve loops poll this to time-close."""
        if not self._pending:
            return None
        return obs.monotonic() - self._window_opened

    def sample_matches(self, specs: Sequence, K: int,
                       seed: int | None = None) -> list[dict]:
        """Draw ``K`` weighted tree samples + counts per (motif, delta)
        spec through this session's upload and preprocess cache
        (``core.batch.sample_matches_many``)."""
        from ..core.batch import sample_matches_many
        return sample_matches_many(
            self.g, specs, K,
            seed=self.config.seed if seed is None else seed,
            planner=self.planner)

    # -- execution -------------------------------------------------------
    def flush(self) -> None:
        """Close the current coalescing window and run it to completion
        (every adaptive growth round of its requests included).

        A failure mid-drain marks every unfinished handle of the window
        failed and re-raises; the session stays usable.
        """
        pending, self._pending = self._pending, []
        if not pending:
            return
        self.stats.drains += 1
        active = pending
        with obs.span("session.drain", stage="drain",
                      trace=pending[0]._trace, requests=len(pending)):
            try:
                while active:
                    active = self._run_round(active)
            except BaseException as e:
                for h in pending:
                    if not h.done:
                        h._error = e
                        h.done = True
                raise

    def _resolve_plan(self, h: Handle) -> None:
        """Tree + weights for a handle (cached across growth rounds)."""
        if h._tree is not None:
            return
        req = h.request
        pre0 = self.planner.preprocess_s
        with obs.span("session.preprocess", stage="preprocess",
                      trace=h._trace) as sp:
            h._motif = (get_motif(req.motif) if isinstance(req.motif, str)
                        else req.motif)
            if req.tree is not None:
                h._tree = req.tree
                h._wts = (req.wts if req.wts is not None
                          else self.planner.weights_for(req.tree, req.delta))
            else:
                h._tree, h._wts = self.planner.plan(h._motif, req.delta)
        h._preprocess_s = self.planner.preprocess_s - pre0
        h._tree_select_s = sp.elapsed_s

    def _run_round(self, active: list[Handle]) -> list[Handle]:
        """One engine pass over ``active`` handles; returns the handles
        whose adaptive budget still needs to grow."""
        from ..core.engine import EngineJob, plan_jobs, run_plan

        cfg = self.config
        handles, jobs = [], []
        for h in active:
            if obs.enabled() and not h._queue_wait_seen:
                # submit -> first drain: coalescing + queueing latency
                h._queue_wait_seen = True
                obs.observe_stage("queue_wait",
                                  obs.monotonic() - h._submit_t,
                                  trace=h._trace)
            self._resolve_plan(h)
            req = h.request
            job = EngineJob(
                index=len(jobs), motif=h._motif, delta=int(req.delta),
                k=h._k_total,
                seed=int(cfg.seed if req.seed is None else req.seed),
                tree=h._tree, wts=h._wts,
                checkpoint_path=req.checkpoint_path, resume=h._resume,
                deadline_t=h._deadline_t, witnesses=int(req.witnesses),
                trace=h._trace)
            job.tree_select_s = h._tree_select_s
            job.preprocess_s = h._preprocess_s
            handles.append(h)
            jobs.append(job)

        plan = plan_jobs(jobs, dev=self.dev, chunk=cfg.chunk, Lmax=cfg.Lmax,
                         checkpoint_every=cfg.checkpoint_every,
                         mesh=self.mesh)
        results = run_plan(
            plan, on_window=lambda job, ws, j0, n:
                handles[job.index]._on_window(job, ws, j0, n))
        self.stats.dispatches += plan.dispatches

        still_growing: list[Handle] = []
        for h, job, res in zip(handles, jobs, results):
            res.rse = h._current_rse()
            if h.request.witnesses:
                # the engine result covers this round alone; answer with
                # the handle's cross-round merged reservoir
                res.witnesses = witness_entries(h._wit, h.request.witnesses)
            h._result = res
            if res.degraded:
                # the engine stopped this job at its deadline: its
                # partial is final; never grow a degraded request
                h.done = True
                self.stats.completed += 1
                continue
            if self._needs_growth(h, job):
                h._resume = (job.cursor, dict(job.acc))
                h._k_total = min(h._k_cap(),
                                 max(int(h._k_total * cfg.rse_growth),
                                     job.k_eff + cfg.chunk))
                self.stats.adaptive_rounds += 1
                still_growing.append(h)
            else:
                if (h.request.target_rse is not None
                        and h._deadline_t is not None
                        and h._current_rse() > h.request.target_rse
                        and obs.monotonic() >= h._deadline_t):
                    # target unmet but the deadline vetoed further
                    # growth rounds: report the partial as degraded
                    res.degraded = True
                    res.degrade_reason = (
                        f"deadline: adaptive growth stopped at k={res.k} "
                        f"with rse={res.rse:.4g} "
                        f"(target {h.request.target_rse})")
                h.done = True
                self.stats.completed += 1
        return still_growing

    def _needs_growth(self, h: Handle, job) -> bool:
        """Grow iff the target RSE is unmet AND a larger budget can still
        add whole new chunks under the cap AND the deadline (if any) has
        not expired."""
        target = h.request.target_rse
        if target is None or h._current_rse() <= target:
            return False
        if h._deadline_t is not None and obs.monotonic() >= h._deadline_t:
            return False
        cap_chunks = max(1, -(-h._k_cap() // self.config.chunk))
        return job.cursor < cap_chunks
