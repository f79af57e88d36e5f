"""Host-side spans, trace-id propagation, the flight recorder and the
profile seam (the port's copy of the JAX package's ``repro.obs.trace``).

A **trace id** is minted once per unit of external work (a gateway wire
line, a ``Session.submit``, a ``StreamingSession.advance``) and rides
along every hop that serves it: intake thread → scheduler ``Work`` →
dispatcher drain → engine cohort dispatch → emitter thread.  Propagation
is explicit across threads (the gateway stores the id on the ``Work``
item and re-enters it via :class:`trace_context` on the dispatcher) and
ambient within one (a ``threading.local`` that :func:`span` consults).

A **span** times a host-side region.  It ALWAYS measures (the engine
reads ``elapsed_s`` for result metadata at every level); what the level
changes is recording:

* ``off``     — nothing is recorded anywhere (no ring append, no
  histogram update, no span-stack bookkeeping);
* ``metrics`` — spans that declare a ``stage=`` feed the
  ``repro_stage_seconds`` histogram family;
* ``trace``   — additionally every span/event lands in the bounded
  ring-buffer **flight recorder**, exported as NDJSON by the
  ``{"cmd": "trace"}`` wire verb or ``--trace-out PATH``.  Each record
  also carries ``ts_ns``, its start on the profiler's clock
  (:mod:`.clock`; anchored when the level becomes ``trace``).

**Device stages.**  At ``trace`` level each engine window attempt
(``engine.device``) enters a :class:`DeviceStages` (:func:`device_stages`),
and inside it :func:`stage` opens one :class:`DeviceSpan` per stage of
a chunk.  On a card each such span also records a pair of CUDA timing
events on the current stream; their ``device_ms`` is read, and the
records appended, when the owner closes after the window's one host
copy, so no sync is added.  An attempt that fails marks its stage
records with the error and drops their events.  Below ``trace``
:func:`device_stages` is a no-op context, and :func:`stage` then opens
nothing and creates no event.

The level and the ring's capacity are set in-process (:func:`set_level`,
:func:`set_ring`; the CLI's ``--obs`` and ``--obs-ring``): the port
reads no environment, so the defaults are the reference's knob defaults,
``off`` and 4096.

Spans never touch a sampling key: ids derive from a process counter
mixed through splitmix64 (no entropy, no wall clock), clock reads stay
on the host, and estimates are bit-identical at every level.

The profile seam arms a one-shot ``torch.profiler`` capture around the
next N engine windows (wire verb ``{"cmd": "profile"}``): CPU activity,
plus CUDA when the windows run on a card, started and stopped by the
engine on the thread that runs the windows, the trace exported as Chrome
JSON into the armed directory.  torch is imported there, lazily.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
from collections import deque

from .clock import perf_counter, profiler_ns, set_anchor
from .registry import REGISTRY

OFF, METRICS, TRACE = 0, 1, 2
_LEVEL_NAMES = {"off": OFF, "metrics": METRICS, "trace": TRACE}
DEFAULT_LEVEL = "off"
DEFAULT_RING = 4096
_LEVEL: int = _LEVEL_NAMES[DEFAULT_LEVEL]


def level() -> int:
    return _LEVEL


def level_name() -> str:
    return ("off", "metrics", "trace")[level()]


def enabled(min_level: int = METRICS) -> bool:
    return level() >= min_level


def set_level(value: str | None) -> None:
    """Set the obs level in-process (tests / CLI); None restores the
    default (``off``).  Becoming ``trace`` re-anchors the profiler's
    clock (``clock.set_anchor``)."""
    global _LEVEL
    if value is None:
        value = DEFAULT_LEVEL
    if value not in _LEVEL_NAMES:
        raise ValueError(f"obs level {value!r} "
                         f"(want {'|'.join(_LEVEL_NAMES)})")
    _LEVEL = _LEVEL_NAMES[value]
    if _LEVEL == TRACE:
        set_anchor()


# ---------------------------------------------------------------------------
# trace ids + ambient context
# ---------------------------------------------------------------------------
def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


_TRACE_SEQ = itertools.count(1)
_SPAN_SEQ = itertools.count(1)
_CTX = threading.local()


def new_trace() -> str:
    """Mint a trace id: process counter mixed through splitmix64 — no
    entropy, no wall-clock, deterministic per mint order."""
    n = next(_TRACE_SEQ)
    return f"{_splitmix64((os.getpid() << 32) ^ n):016x}"


def current_trace() -> str | None:
    return getattr(_CTX, "trace", None)


class trace_context:
    """Context manager: make ``tid`` the ambient trace on this thread."""

    __slots__ = ("tid", "_prev")

    def __init__(self, tid: str | None):
        self.tid = tid
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_CTX, "trace", None)
        _CTX.trace = self.tid
        return self

    def __exit__(self, *exc):
        _CTX.trace = self._prev
        return False


def _span_stack() -> list:
    stack = getattr(_CTX, "stack", None)
    if stack is None:
        stack = _CTX.stack = []
    return stack


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------
class FlightRecorder:
    """Bounded ring of span/event records (oldest overwritten first)."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._recorded = 0          # total appended (exceeds len once wrapped)

    def append(self, rec: dict) -> None:
        self._ring.append(rec)
        self._recorded += 1

    def __len__(self) -> int:
        return len(self._ring)

    @property
    def recorded(self) -> int:
        return self._recorded

    def records(self) -> list:
        return list(self._ring)

    def export_ndjson(self) -> str:
        recs = self.records()
        if not recs:
            return ""
        return "\n".join(json.dumps(r, sort_keys=True) for r in recs) + "\n"

    def clear(self) -> None:
        self._ring.clear()
        self._recorded = 0


RECORDER = FlightRecorder(DEFAULT_RING)


def set_ring(capacity: int) -> None:
    """Resize the flight recorder (the CLI's ``--obs-ring``), keeping
    its newest records."""
    capacity = int(capacity)
    if capacity < 1:
        raise ValueError(f"obs ring capacity must be >= 1, got {capacity}")
    RECORDER.capacity = capacity
    RECORDER._ring = deque(RECORDER._ring, maxlen=capacity)


_STAGE_SECONDS = REGISTRY.histogram(
    "repro_stage_seconds",
    "per-stage serving latency (intake, queue_wait, preprocess, drain, "
    "dispatch, device, emit, advance, wal_fsync)", labels=("stage",))
_STAGE_CHILDREN: dict = {}          # stage -> Histogram child (hot-path cache)


def _stage_hist(stage: str):
    h = _STAGE_CHILDREN.get(stage)
    if h is None:
        h = _STAGE_CHILDREN[stage] = _STAGE_SECONDS.labels(stage=stage)
    return h


class Span:
    """One timed host-side region (always times; records per level)."""

    __slots__ = ("name", "stage", "trace", "attrs", "span_id", "parent_id",
                 "t0", "elapsed_s", "_recording")

    def __init__(self, name: str, stage: str | None, trace: str | None,
                 attrs: dict):
        self.name = name
        self.stage = stage
        self.trace = trace
        self.attrs = attrs
        self.span_id = 0
        self.parent_id = 0
        self.t0 = 0.0
        self.elapsed_s = 0.0
        self._recording = level() >= TRACE

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        if self._recording:
            stack = _span_stack()
            if self.trace is None:
                self.trace = (stack[-1].trace if stack
                              else current_trace())
            self.span_id = next(_SPAN_SEQ)
            self.parent_id = stack[-1].span_id if stack else 0
            stack.append(self)
        elif self.trace is None:
            self.trace = current_trace()
        self.t0 = perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.elapsed_s = perf_counter() - self.t0
        lvl = level()
        if lvl >= METRICS and self.stage is not None:
            _stage_hist(self.stage).observe(self.elapsed_s)
        if self._recording:
            stack = _span_stack()
            if stack and stack[-1] is self:
                stack.pop()
            rec = {"name": self.name, "trace": self.trace,
                   "span": self.span_id, "parent": self.parent_id,
                   "t0": round(self.t0, 6),
                   "dur_s": round(self.elapsed_s, 9),
                   "thread": threading.current_thread().name,
                   "ts_ns": profiler_ns(self.t0)}
            if self.stage is not None:
                rec["stage"] = self.stage
            if exc_type is not None:
                rec["error"] = exc_type.__name__
            if self.attrs:
                rec["attrs"] = self.attrs
            self._emit(rec)
        return False

    def _emit(self, rec: dict) -> None:
        RECORDER.append(rec)


def span(name: str, *, stage: str | None = None, trace: str | None = None,
         **attrs) -> Span:
    """Open a span.  ``stage=`` feeds ``repro_stage_seconds`` at the
    metrics level; other kwargs become recorder attrs at trace level."""
    return Span(name, stage, trace, attrs)


def event(name: str, *, trace: str | None = None, **attrs) -> None:
    """Zero-duration recorder entry (trace level only) — e.g. per-window
    RSE-vs-samples trajectory points."""
    if level() < TRACE:
        return
    if trace is None:
        trace = current_trace()
    t = perf_counter()
    rec = {"name": name, "trace": trace, "span": next(_SPAN_SEQ),
           "parent": 0, "t0": round(t, 6), "dur_s": 0.0,
           "thread": threading.current_thread().name,
           "ts_ns": profiler_ns(t)}
    if attrs:
        rec["attrs"] = attrs
    RECORDER.append(rec)


def observe_stage(stage: str, dt: float, *, trace: str | None = None,
                  **attrs) -> None:
    """Record a DERIVED duration (e.g. queue-wait measured between two
    threads) into the stage histogram + flight recorder.  Its ``t0`` is
    when it was recorded, the end of the interval; its ``ts_ns`` is the
    start, ``dt`` before."""
    lvl = level()
    if lvl < METRICS:
        return
    _stage_hist(stage).observe(dt)
    if lvl >= TRACE:
        if trace is None:
            trace = current_trace()
        t = perf_counter()
        rec = {"name": f"stage.{stage}", "trace": trace,
               "span": next(_SPAN_SEQ), "parent": 0,
               "t0": round(t, 6), "dur_s": round(float(dt), 9),
               "thread": threading.current_thread().name, "stage": stage,
               "ts_ns": profiler_ns(t - float(dt))}
        if attrs:
            rec["attrs"] = attrs
        RECORDER.append(rec)


#: idle pairs of CUDA timing events by device index: a stage span takes
#: one and its window gives it back once read, so a traced window
#: creates and destroys no event after the first ones
_EVENT_PAIRS: dict = {}


def _event_pair(device_index: int) -> tuple:
    try:
        return _EVENT_PAIRS[device_index].pop()
    except (KeyError, IndexError):
        import torch
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))


class DeviceSpan(Span):
    """A stage of an engine chunk (``trace`` level): a :class:`Span`
    that, on a card, also records a CUDA timing event on its owner's
    stream at its start and at its end.  Its record goes to its
    :class:`DeviceStages` owner, which appends it once the events are
    complete."""

    __slots__ = ("_owner", "_events")

    def __init__(self, owner: "DeviceStages", name: str, attrs: dict):
        super().__init__(name, None, None, attrs)
        self._owner = owner
        self._events = None
        if self._recording and owner.stream is not None:
            self._events = _event_pair(owner.stream.device_index)

    def __enter__(self) -> "DeviceSpan":
        super().__enter__()
        if self._events is not None:
            self._events[0].record(self._owner.stream)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._events is not None:
            self._events[1].record(self._owner.stream)
        return super().__exit__(exc_type, exc, tb)

    def _emit(self, rec: dict) -> None:
        on = self._owner.stream
        self._owner.pending.append(
            (rec, self._events, None if on is None else on.device_index))


class DeviceStages:
    """The stage spans of one engine window attempt (``trace`` level).

    Entered around the window and its host copy, it is its thread's
    owner of stages: :func:`stages_at` points it at a chunk (on a card
    it takes the device's current stream, where the chunk's work and
    its events go) and :func:`stage` opens a :class:`DeviceSpan` of it
    whose attrs carry the chunk index.  On a clean exit every span's
    ``device_ms`` (on a card) is read from its events, which the copy
    has completed, the events go back to the pool and the records are
    appended to the flight recorder; on an error the records are marked
    with it and their events dropped."""

    __slots__ = ("pending", "stream", "chunk", "_prev")

    def __init__(self):
        self.pending: list = []
        self.stream = None
        self.chunk = 0
        self._prev = None

    def at(self, device, chunk: int) -> None:
        self.chunk = int(chunk)
        self.stream = None
        if device.type == "cuda":
            import torch
            self.stream = torch.cuda.current_stream(device)

    def __enter__(self) -> "DeviceStages":
        self._prev = getattr(_CTX, "stages", None)
        _CTX.stages = self
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        _CTX.stages = self._prev
        pending, self.pending = self.pending, []
        for rec, events, index in pending:
            if exc_type is not None:
                rec.setdefault("error", exc_type.__name__)
            elif events is not None:
                rec["device_ms"] = events[0].elapsed_time(events[1])
                _EVENT_PAIRS.setdefault(index, []).append(events)
            RECORDER.append(rec)
        return False


_NO_SPAN = contextlib.nullcontext()


def device_stages():
    """The stage owner of one engine window attempt: a
    :class:`DeviceStages` at ``trace``, else a shared no-op context
    (the one level read of an untraced attempt)."""
    return DeviceStages() if level() >= TRACE else _NO_SPAN


def stages_at(device, chunk: int) -> None:
    """Point this thread's :class:`DeviceStages`, if one is open, at
    chunk ``chunk`` on ``device``; without one, do nothing."""
    owner = getattr(_CTX, "stages", None)
    if owner is not None:
        owner.at(device, chunk)


def stage(name: str, **attrs):
    """A stage span of the current chunk (:class:`DeviceSpan`), or,
    outside a traced engine attempt, a shared no-op context that makes
    no event and records nothing."""
    owner = getattr(_CTX, "stages", None)
    if owner is None:
        return _NO_SPAN
    return DeviceSpan(owner, name, {"chunk": owner.chunk, **attrs})


def summary() -> dict:
    """Small obs block embedded in ``health`` / ``stats`` responses."""
    return {"level": level_name(), "spans": len(RECORDER),
            "recorded": RECORDER.recorded, "ring": RECORDER.capacity}


# ---------------------------------------------------------------------------
# torch.profiler capture seam ({"cmd": "profile", "windows": n})
# ---------------------------------------------------------------------------
_PROFILE = {"remaining": 0, "dir": None, "active": False, "error": None,
            "captured": 0, "file": None}
_PROFILE_LOCK = threading.Lock()
_PROFILER: list = []                # the running torch.profiler.profile
_PROFILE_SEQ = itertools.count(1)


def arm_profile(windows: int, logdir: str) -> dict:
    """Arm a one-shot device-level capture around the next N engine
    window dispatches."""
    windows = int(windows)
    if windows < 1:
        raise ValueError("profile windows must be >= 1")
    with _PROFILE_LOCK:
        if _PROFILE["active"] or _PROFILE["remaining"] > 0:
            raise RuntimeError("a profiler capture is already armed")
        _PROFILE.update(remaining=windows, dir=logdir, error=None,
                        captured=0, file=None)
    return {"armed": windows, "dir": logdir}


def profile_armed() -> bool:
    """Cheap pre-dispatch check (one dict read on the engine hot path)."""
    return _PROFILE["remaining"] > 0 or _PROFILE["active"]


def profile_window_start(cuda: bool = False) -> None:
    """Start the armed capture before an engine window (the engine calls
    it on the thread that runs its windows).  ``cuda`` adds CUDA
    activity (kernels through CUPTI) to the CPU's."""
    with _PROFILE_LOCK:
        if _PROFILE["active"] or _PROFILE["remaining"] <= 0:
            return
        try:
            from torch.profiler import ProfilerActivity, profile
            set_anchor()        # fresh for the profiler's own stamps
            acts = [ProfilerActivity.CPU]
            if cuda:
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.start()
            _PROFILER[:] = [prof]
            _PROFILE["active"] = True
        except Exception as e:          # profiler failure must not kill serving
            _PROFILE["error"] = f"{type(e).__name__}: {e}"
            _PROFILE["remaining"] = 0


def profile_window_end() -> None:
    """Count a captured window; after the last one stop the profiler and
    export its Chrome trace into the armed directory."""
    with _PROFILE_LOCK:
        if not _PROFILE["active"]:
            return
        _PROFILE["remaining"] -= 1
        _PROFILE["captured"] += 1
        if _PROFILE["remaining"] <= 0:
            prof = _PROFILER.pop()
            try:
                prof.stop()
                os.makedirs(_PROFILE["dir"], exist_ok=True)
                path = os.path.join(
                    _PROFILE["dir"],
                    f"profile_{os.getpid()}_{next(_PROFILE_SEQ)}.json")
                prof.export_chrome_trace(path)
                _PROFILE["file"] = path
            except Exception as e:
                _PROFILE["error"] = f"{type(e).__name__}: {e}"
            _PROFILE["active"] = False


def profile_status() -> dict:
    """The capture's state; ``file`` is the exported Chrome trace."""
    with _PROFILE_LOCK:
        return {k: _PROFILE[k] for k in
                ("remaining", "dir", "active", "error", "captured", "file")}
