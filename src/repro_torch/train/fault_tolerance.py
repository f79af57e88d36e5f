"""Fault tolerance: resumable training and the estimator's work queue
(the port of ``repro.train.fault_tolerance``, whose docstring holds the
design notes).

1. ``run_resumable``: step-indexed checkpoints (``checkpoint.py``), a
   bounded retry of a failing step with a fresh batch when the failure
   is transient, skip-and-log otherwise, and an idempotent resume from
   the latest complete manifest.
2. ``WorkQueue`` / ``run_estimation_distributed``: over-decomposed work
   units leased with deadlines; expired leases re-issue, and unit ``j``
   draws ``fold_in(base_key, j)``, so who runs it never changes the
   result (first completion wins).

Whether a failure is worth retrying is the port's own
:func:`repro_torch.resilience.classify`, the taxonomy the engine's
ladder and the serve loops use; it also knows the card's faults
(``torch.cuda.OutOfMemoryError`` is retryable).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

from ..resilience import classify, is_retryable
from . import checkpoint as ckpt


# ---------------------------------------------------------------------------
# 1. resumable synchronous training
# ---------------------------------------------------------------------------
@dataclass
class RunReport:
    steps_run: int = 0
    retries: int = 0
    resumed_from: int | None = None
    failures_skipped: int = 0
    metrics: list = field(default_factory=list)


def run_resumable(step_fn: Callable, state: Any, next_batch: Callable,
                  total_steps: int, ckpt_dir: str, ckpt_every: int = 10,
                  max_retries: int = 2, keep: int = 3,
                  fail_injector: Callable | None = None, mesh=None,
                  specs=None) -> tuple[Any, RunReport]:
    """Run ``total_steps`` of ``state = step_fn(state, batch, step)``.

    * resumes from the latest complete checkpoint in ``ckpt_dir``;
    * retries a raising step with a fresh batch (bounded) IF the
      failure classifies as transient (``resilience.errors.classify``
      — the same taxonomy the engine's retry ladder uses), then skips
      it (skip-and-log) so one poisoned batch cannot wedge the job;
      non-retryable failures skip immediately without burning retries;
    * ``fail_injector(step, attempt)`` raising is the test hook.

    On a model mesh every rank runs it with its pieces of ``state``
    (``specs``: a ``PartitionSpec`` per leaf): checkpoints hold the full
    tree, written by rank 0 (``checkpoint.save``), and a resume reads
    them on every rank.  The ranks' steps are collective, so a failure
    must reach every rank alike (the injector's faults do).
    """
    report = RunReport()
    start = 0
    last = ckpt.latest_step(ckpt_dir)
    if last is not None:
        state, extra = ckpt.restore(ckpt_dir, last, state, mesh=mesh,
                                    specs=specs)
        start = int(extra.get("next_step", last))
        report.resumed_from = last
    for step in range(start, total_steps):
        done = False
        for attempt in range(max_retries + 1):
            batch = next_batch(step, attempt)
            try:
                if fail_injector is not None:
                    fail_injector(step, attempt)
                state, metrics = step_fn(state, batch, step)
                report.metrics.append(metrics)
                done = True
                break
            except Exception as e:
                if not is_retryable(e):
                    break       # fatal/bad input: skip, don't retry
                report.retries += 1
        if not done:
            report.failures_skipped += 1  # skip-and-log
        report.steps_run += 1
        if (step + 1) % ckpt_every == 0 or step == total_steps - 1:
            ckpt.save(ckpt_dir, step + 1, state,
                      extra=dict(next_step=step + 1), mesh=mesh,
                      specs=specs)
            if mesh is None or mesh.rank == 0:
                ckpt.prune(ckpt_dir, keep=keep)
    return state, report


# ---------------------------------------------------------------------------
# 2. estimator work queue (straggler mitigation)
# ---------------------------------------------------------------------------
@dataclass
class WorkUnit:
    unit_id: int            # == RNG fold index; identity of the work
    lease_worker: int | None = None
    lease_expiry: float = 0.0
    result: Any = None
    done: bool = False
    issues: int = 0
    failures: int = 0       # retryable faults reported against this unit
    fatal: str = ""         # first fatal error message (unit abandoned)


class WorkQueue:
    """Lease-based queue: over-decomposed units, deadline re-issue.

    Deterministic results: unit_id -> fold_in(base_key, unit_id) inside the
    worker, so a unit re-executed by a different worker returns the exact
    same chunk sum and duplicate completions are idempotent.
    """

    def __init__(self, n_units: int, lease_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.units = [WorkUnit(unit_id=i) for i in range(n_units)]
        self.lease_s = lease_s
        self.clock = clock

    def acquire(self, worker: int) -> int | None:
        """Lease the next available unit (unleased, expired, or undone)."""
        now = self.clock()
        for u in self.units:
            if u.done or u.fatal:
                continue
            if u.lease_worker is None or u.lease_expiry <= now:
                u.lease_worker = worker
                u.lease_expiry = now + self.lease_s
                u.issues += 1
                return u.unit_id
        return None

    def complete(self, unit_id: int, result: Any) -> bool:
        """First completion wins; duplicates are dropped (returns False)."""
        u = self.units[unit_id]
        if u.done:
            return False
        u.result = result
        u.done = True
        return True

    def fail(self, unit_id: int, exc: BaseException) -> str:
        """A worker reports its leased unit failed; returns the kind.

        Retryable failures release the lease immediately so the unit
        re-issues to the next ``acquire`` (no waiting out the deadline);
        anything else marks the unit fatally failed — it stops
        re-issuing, and ``results()`` raises naming it.  The decision is
        ``resilience.errors.classify``, the same taxonomy every other
        layer uses.
        """
        u = self.units[unit_id]
        kind = classify(exc)
        if u.done:
            return kind                 # a sibling already finished it
        if is_retryable(exc):
            u.failures += 1
            u.lease_worker = None       # eligible for immediate re-issue
            u.lease_expiry = 0.0
        elif not u.fatal:
            u.fatal = f"{type(exc).__name__}: {exc}"
        return kind

    @property
    def all_done(self) -> bool:
        return all(u.done or u.fatal for u in self.units)

    @property
    def reissues(self) -> int:
        return sum(max(0, u.issues - 1) for u in self.units)

    def results(self) -> list:
        if not self.all_done:
            raise RuntimeError("queue not drained")
        dead = [u for u in self.units if u.fatal]
        if dead:
            raise RuntimeError(
                f"{len(dead)} unit(s) failed fatally; first: "
                f"unit {dead[0].unit_id}: {dead[0].fatal}")
        return [u.result for u in self.units]

    @property
    def retryable_failures(self) -> int:
        return sum(u.failures for u in self.units)


def run_estimation_distributed(worker_fn: Callable[[int], Any],
                               n_units: int, n_workers: int = 4,
                               straggler_of: Callable[[int], bool]
                               | None = None,
                               lease_s: float = 0.05) -> tuple[list, WorkQueue]:
    """Simulated multi-worker drain of a WorkQueue (tests / CPU demo).

    ``worker_fn(unit_id)`` must be deterministic in unit_id.
    ``straggler_of(worker)`` -> True makes that worker hold leases past
    expiry (its results still arrive, but late -> dropped as duplicates).
    """
    q = WorkQueue(n_units, lease_s=lease_s)
    pending: list[tuple[float, int, int]] = []  # (ready_time, worker, unit)
    t = 0.0

    def clock() -> float:
        return t

    q.clock = clock
    while not q.all_done:
        # round-robin workers acquire + "compute"
        progressed = False
        for w in range(n_workers):
            uid = q.acquire(w)
            if uid is None:
                continue
            slow = straggler_of(w) if straggler_of else False
            delay = lease_s * 3 if slow else lease_s * 0.1
            pending.append((t + delay, w, uid))
            progressed = True
        # deliver whatever has finished by the next time tick
        t += lease_s * 0.5
        still = []
        for ready, w, uid in pending:
            if ready <= t:
                q.complete(uid, worker_fn(uid))
            else:
                still.append((ready, w, uid))
        pending = still
        if not progressed and not pending:
            t += lease_s  # let leases expire
    return q.results(), q
