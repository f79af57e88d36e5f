"""Overlapped execution: one dispatcher thread, fair tenant queues
(the port's copy of the JAX package's ``repro.gateway.scheduler``).

The gateway separates *intake* from *execution*.  The intake thread
parses wire lines and enqueues :class:`Work` items; this module's
:class:`FairScheduler` owns the single **dispatcher thread** that
executes them — so intake never blocks on a running drain, and a drain
for tenant A never blocks tenant B's enqueue.

Design constraints that shaped it:

* **One executor.**  Sessions and stream stores are not thread-safe
  against concurrent mutation, and the per-tenant engine-stats deltas
  the ``stats`` verb reports are only exact when execution is
  serialized.  All CUDA work (uploads, the weight DP, the windows) and
  all tenant lifecycle (open/close/evict) therefore happen on the
  dispatcher thread; the intake thread launches and synchronises
  nothing on the device.  Concurrency comes from overlapping intake +
  emit with execution, not from parallel drains.
* **Queues are keyed by NAME, resolved at dispatch.**  Intake must not
  dereference tenants: ``open_tenant`` is itself asynchronous (control
  queue), so work for a just-requested tenant can legally arrive before
  the open executes.  Control work always runs before tenant turns, so
  the open is guaranteed to precede the queued requests it races —
  and a name that never opens answers ``unknown tenant`` from the
  dispatcher instead of poisoning intake ordering.
* **Fairness.**  Names with pending work are served round-robin, one
  batch per turn: a tenant with a deep queue cannot starve the others.
  Consecutive *request* items at the head of a queue execute as ONE
  batch (one coalescing window -> one fused engine plan), so fairness
  never costs the tree-cohort fusion the engine provides.
* **Backpressure, never a silent stall.**  ``submit`` enforces the
  per-tenant pending quota at ENQUEUE time and raises
  :class:`~repro_torch.resilience.OverloadedError` — the intake loop answers
  ``{"ok": false, "error_kind": "overloaded"}`` immediately while the
  dispatcher keeps draining.  Shed work is never executed and never
  retried server-side.
* **Determinism is untouched.**  The scheduler decides WHEN work runs,
  never how its keys derive: chunk ``j`` of a request still draws
  ``fold_in(PRNGKey(seed), j)`` whatever the interleaving, so any
  tenant schedule produces bit-identical counts.
"""
from __future__ import annotations

import sys
import threading
from collections import deque
from dataclasses import dataclass, field

from .. import obs
from ..resilience import OverloadedError, classify


@dataclass
class Work:
    """One unit of dispatcher work.

    ``kind`` is ``"request"`` (batchable: consecutive requests on one
    tenant fuse into one submit window) or a verb executed alone
    (``"ingest"``/``"advance"``/``"subscribe"``/``"unsubscribe"``/
    ``"close_tenant"`` on a tenant queue; ``"open_tenant"`` on the
    control queue).  ``obj`` is the parsed wire object; ``tenant`` the
    routing name (None for control work).

    ``trace``/``t_enq`` are the telemetry hand-off across the
    intake -> dispatcher thread boundary: the intake thread's ambient
    trace id and enqueue timestamp ride the work item, so the
    dispatcher can re-enter the request's trace context and observe the
    queue-wait stage (``repro_stage_seconds{stage="queue_wait"}``).
    They never influence scheduling or execution.
    """

    kind: str
    obj: dict
    tenant: str | None = None
    trace: str | None = field(default_factory=lambda: obs.current_trace())
    t_enq: float = field(default_factory=lambda: obs.monotonic())


@dataclass
class SchedulerStats:
    turns: int = 0             # dispatcher serving turns taken
    batched: int = 0           # request items that shared a turn
    shed: int = 0              # submits refused by the quota
    max_overlap: int = 0       # peak names with pending work
    exec_failures: int = 0     # execute() raised (classified, loop lives)


class FairScheduler:
    """Single-dispatcher executor with round-robin tenant fairness.

    ``execute(work_or_batch)`` is injected by the serve loop and runs on
    the dispatcher thread only; it receives either one :class:`Work`
    (control/stream verbs) or a non-empty list of request-kind
    :class:`Work` items for one tenant name (a fused batch), and
    resolves names to live tenants itself.  It must handle its own
    per-item error reporting; an exception escaping it is classified,
    counted and logged — the dispatcher never dies with work queued
    behind the failure.
    """

    def __init__(self, execute, *, quota: int = 16):
        self.execute = execute
        self.quota = max(1, int(quota))
        self.stats = SchedulerStats()
        self._cv = threading.Condition()
        self._control: deque[Work] = deque()
        self._queues: dict[str, deque[Work]] = {}
        self._rr: deque[str] = deque()     # names awaiting a turn
        self._busy_name: str | None = None
        self._busy = False                 # dispatcher mid-execute
        self._stop = False
        self._thread = threading.Thread(target=self._run,
                                        name="gateway-dispatch", daemon=True)
        self._thread.start()

    # -- intake side -----------------------------------------------------
    def pending(self, name: str) -> int:
        """Queued + in-flight work items for a tenant name (the
        backpressure measure and the ``stats`` block's ``pending``)."""
        with self._cv:
            return self._pending_locked(name)

    def _pending_locked(self, name: str) -> int:
        return (len(self._queues.get(name, ()))
                + (1 if self._busy_name == name else 0))

    def submit(self, name: str, work: Work) -> None:
        """Enqueue tenant work; quota-full sheds with ``OverloadedError``."""
        with self._cv:
            if self._stop:
                raise RuntimeError("scheduler is stopped")
            n_pending = self._pending_locked(name)
            if n_pending >= self.quota:
                self.stats.shed += 1
                raise OverloadedError(
                    f"tenant {name!r} has {n_pending} pending "
                    f"(quota {self.quota}) — back off and resubmit")
            q = self._queues.get(name)
            if q is None:
                q = self._queues[name] = deque()
            q.append(work)
            if name not in self._rr:
                self._rr.append(name)
            self.stats.max_overlap = max(
                self.stats.max_overlap,
                len(self._rr) + (1 if self._busy_name is not None else 0))
            self._cv.notify_all()

    def submit_control(self, work: Work) -> None:
        """Enqueue pool-lifecycle work (``open_tenant``); never shed —
        the pool itself applies its capacity policy (idle-LRU evict or
        overloaded) when the work executes."""
        with self._cv:
            if self._stop:
                raise RuntimeError("scheduler is stopped")
            self._control.append(work)
            self._cv.notify_all()

    def barrier(self) -> None:
        """Block until every queued item has fully executed (the
        ``quit``/EOF drain-all point)."""
        with self._cv:
            self._cv.wait_for(lambda: self._stop or (
                not self._busy and not self._control and not self._rr))

    def stop(self) -> None:
        """Drain outstanding work, then stop the dispatcher thread."""
        self.barrier()
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join()

    # -- dispatcher side -------------------------------------------------
    def _take(self):
        """Next unit under the lock: control first (tenant opens precede
        the tenant work racing them), then the name at the head of the
        round-robin ring (requeued at the tail when work remains)."""
        if self._control:
            return self._control.popleft(), None
        while self._rr:
            name = self._rr.popleft()
            q = self._queues.get(name)
            if not q:
                self._queues.pop(name, None)
                continue
            if q[0].kind == "request":
                batch = []
                while q and q[0].kind == "request":
                    batch.append(q.popleft())
                self.stats.batched += max(0, len(batch) - 1)
                unit = batch
            else:
                unit = q.popleft()
            self._busy_name = name
            return unit, name
        return None, None

    def _run(self) -> None:
        while True:
            with self._cv:
                self._cv.wait_for(
                    lambda: self._stop or self._control or self._rr)
                if self._stop:
                    return
                unit, name = self._take()
                if unit is not None:
                    self._busy = True
            if unit is None:
                continue
            try:
                self.execute(unit)
            except Exception as e:
                # execute() reports per-item errors itself; anything
                # escaping is a serving-loop bug — classify + count so
                # the dispatcher survives with the queue intact
                self.stats.exec_failures += 1
                sys.stderr.write(f"gateway: dispatch failed "
                                 f"({classify(e)}): {e}\n")
            with self._cv:
                self.stats.turns += 1
                self._busy = False
                self._busy_name = None
                if name is not None:
                    q = self._queues.get(name)
                    if q and name not in self._rr:
                        self._rr.append(name)
                    elif not q:
                        self._queues.pop(name, None)
                self._cv.notify_all()
