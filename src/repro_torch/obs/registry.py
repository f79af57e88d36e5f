"""Typed metrics registry: counters, gauges, fixed log-bucket histograms.

The port's copy of the JAX package's ``repro.obs.registry``: for the
same sequence of operations :meth:`Registry.prometheus_text` gives the
reference's text byte for byte.

* **Monotonic for scrapers.**  Counters only move up; ``reset`` exists
  solely as a test seam (``Registry.reset_for_tests`` / the stats
  facades' ``reset()``) so tests can start from zero.  Closing a
  session zeroes no counter, so scrape deltas stay meaningful.
* **No allocation on the hot path.**  Histograms carry a preallocated
  bucket-count list over FIXED log2 bounds (1 µs · 2^i, i = 0..26, plus
  +Inf); ``observe`` is a ``bisect`` + two integer updates.  Labelled
  children are created once and cached: hot callers hold the child,
  not the family.
* **Stdlib only.**  ``repro_torch.resilience`` layers its stats on this
  module, so nothing here imports torch, numpy or a port package.

:class:`CounterBlock` is the attribute facade ``engine.STATS`` and
``resilience.STATS`` are built on: attribute reads return the live
counter value, ``stats.field += n`` increments the registry counter, and
every field doubles as a Prometheus series.
"""
from __future__ import annotations

import threading
from bisect import bisect_left


def _escape_label(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _format_labels(names: tuple, values: tuple) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{_escape_label(v)}"'
                     for n, v in zip(names, values))
    return "{" + inner + "}"


class Counter:
    """Monotonic integer counter (reset only via the test seam)."""

    __slots__ = ("name", "doc", "label_names", "label_values", "_value",
                 "_lock")

    def __init__(self, name: str, doc: str = "",
                 label_names: tuple = (), label_values: tuple = ()):
        self.name = name
        self.doc = doc
        self.label_names = label_names
        self.label_values = label_values
        self._value = 0
        self._lock = threading.Lock()

    @property
    def value(self) -> int:
        return self._value

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"{self.name}: counters are monotonic "
                             f"(inc({n}))")
        with self._lock:
            self._value += n

    def _reset(self, value: int = 0) -> None:
        """Test-only seam — scrapers rely on monotonicity."""
        with self._lock:
            self._value = value

    def _emit(self, out: list) -> None:
        out.append(f"{self.name}"
                   f"{_format_labels(self.label_names, self.label_values)}"
                   f" {self._value}")


class Gauge:
    """Last-write-wins float gauge."""

    __slots__ = ("name", "doc", "label_names", "label_values", "_value")

    def __init__(self, name: str, doc: str = "",
                 label_names: tuple = (), label_values: tuple = ()):
        self.name = name
        self.doc = doc
        self.label_names = label_names
        self.label_values = label_values
        self._value = 0.0

    @property
    def value(self) -> float:
        return self._value

    def set(self, v: float) -> None:
        self._value = float(v)

    def _reset(self, value: float = 0.0) -> None:
        self._value = value

    def _emit(self, out: list) -> None:
        out.append(f"{self.name}"
                   f"{_format_labels(self.label_names, self.label_values)}"
                   f" {format(self._value, 'g')}")


# fixed log2 latency bounds: 1 µs .. ~67 s, then +Inf
BUCKET_BOUNDS: tuple = tuple(1e-6 * (1 << i) for i in range(27))
N_BUCKETS = len(BUCKET_BOUNDS) + 1             # + the +Inf bucket


class Histogram:
    """Fixed log2-bucket latency histogram (seconds)."""

    __slots__ = ("name", "doc", "label_names", "label_values", "_counts",
                 "_sum", "_count", "_lock")

    def __init__(self, name: str, doc: str = "",
                 label_names: tuple = (), label_values: tuple = ()):
        self.name = name
        self.doc = doc
        self.label_names = label_names
        self.label_values = label_values
        self._counts = [0] * N_BUCKETS
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    @staticmethod
    def bucket_index(dt: float) -> int:
        """Smallest i with dt <= BUCKET_BOUNDS[i], else the +Inf bucket."""
        return bisect_left(BUCKET_BOUNDS, dt)

    def observe(self, dt: float) -> None:
        dt = float(dt)
        i = bisect_left(BUCKET_BOUNDS, dt)
        with self._lock:
            self._counts[i] += 1
            self._sum += dt
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def snapshot(self) -> dict:
        with self._lock:
            return {"counts": list(self._counts), "sum": self._sum,
                    "count": self._count}

    def _reset(self) -> None:
        with self._lock:
            self._counts = [0] * N_BUCKETS
            self._sum = 0.0
            self._count = 0

    def _emit(self, out: list) -> None:
        snap = self.snapshot()
        cum = 0
        for bound, n in zip(BUCKET_BOUNDS, snap["counts"]):
            cum += n
            labels = _format_labels(self.label_names + ("le",),
                                    self.label_values + (format(bound, "g"),))
            out.append(f"{self.name}_bucket{labels} {cum}")
        cum += snap["counts"][-1]
        labels = _format_labels(self.label_names + ("le",),
                                self.label_values + ("+Inf",))
        out.append(f"{self.name}_bucket{labels} {cum}")
        base = _format_labels(self.label_names, self.label_values)
        out.append(f"{self.name}_sum{base} {format(snap['sum'], 'g')}")
        out.append(f"{self.name}_count{base} {snap['count']}")


class Family:
    """A labelled metric family; ``labels(...)`` returns a cached child."""

    __slots__ = ("name", "doc", "label_names", "_cls", "_children", "_lock")

    def __init__(self, cls, name: str, doc: str, label_names: tuple):
        self.name = name
        self.doc = doc
        self.label_names = tuple(label_names)
        self._cls = cls
        self._children: dict = {}
        self._lock = threading.Lock()

    def labels(self, **kv):
        key = tuple(str(kv[n]) for n in self.label_names)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = self._cls(self.name, self.doc,
                                      self.label_names, key)
                    self._children[key] = child
        return child

    def children(self) -> list:
        return list(self._children.values())

    def _reset(self) -> None:
        for child in self.children():
            child._reset()

    def _emit(self, out: list) -> None:
        for key in sorted(self._children):
            self._children[key]._emit(out)


_TYPE_NAME = {Counter: "counter", Gauge: "gauge", Histogram: "histogram"}


class Registry:
    """Process-wide, name-keyed metric registry (idempotent declares)."""

    def __init__(self):
        self._metrics: dict = {}     # name -> metric or Family (insertion order)
        self._lock = threading.Lock()

    def _declare(self, cls, name: str, doc: str, labels: tuple):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                want_family = bool(labels)
                is_family = isinstance(existing, Family)
                ok = (is_family and want_family
                      and existing._cls is cls
                      and existing.label_names == tuple(labels)) or (
                          not is_family and not want_family
                          and type(existing) is cls)
                if not ok:
                    raise ValueError(
                        f"metric {name!r} re-declared with a different "
                        "type/label set")
                return existing
            metric = (Family(cls, name, doc, tuple(labels)) if labels
                      else cls(name, doc))
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, doc: str = "", labels: tuple = ()):
        return self._declare(Counter, name, doc, labels)

    def gauge(self, name: str, doc: str = "", labels: tuple = ()):
        return self._declare(Gauge, name, doc, labels)

    def histogram(self, name: str, doc: str = "", labels: tuple = ()):
        return self._declare(Histogram, name, doc, labels)

    def get(self, name: str):
        return self._metrics.get(name)

    def prometheus_text(self) -> str:
        """Prometheus text exposition (``text/plain; version=0.0.4``)."""
        out: list = []
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            cls = m._cls if isinstance(m, Family) else type(m)
            if m.doc:
                out.append(f"# HELP {m.name} {m.doc}")
            out.append(f"# TYPE {m.name} {_TYPE_NAME[cls]}")
            m._emit(out)
        return "\n".join(out) + "\n"

    def reset_for_tests(self) -> None:
        """Zero every metric — TEST-ONLY (scrapers need monotonicity)."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m._reset()


REGISTRY = Registry()


class CounterBlock:
    """Attribute-compatible facade over a block of registry counters.

    Subclasses declare ``_PREFIX`` and ``_FIELDS``; each field becomes a
    registry counter ``{prefix}_{field}_total``.  ``block.field`` reads
    the live value, ``block.field += n`` increments it, ``as_dict()``
    snapshots the block, and ``reset()`` is the TEST-ONLY seam (wire
    scrapers rely on counters being monotonic across cache clears and
    session teardown).  Instances sharing a prefix share the same
    underlying counters — a block is a *view*, not storage.
    """

    _PREFIX = "repro"
    _FIELDS: tuple = ()
    _DOCS: dict = {}

    def __init__(self, registry: Registry | None = None):
        reg = REGISTRY if registry is None else registry
        object.__setattr__(self, "_counters", {
            f: reg.counter(f"{self._PREFIX}_{f}_total",
                           self._DOCS.get(f, ""))
            for f in self._FIELDS})

    def __getattr__(self, name: str):
        counters = object.__getattribute__(self, "_counters")
        if name in counters:
            return counters[name].value
        raise AttributeError(name)

    def __setattr__(self, name: str, value) -> None:
        counters = object.__getattribute__(self, "_counters")
        c = counters.get(name)
        if c is None:
            raise AttributeError(
                f"{type(self).__name__} has no counter {name!r}")
        delta = int(value) - c.value
        if delta >= 0:
            c.inc(delta)
        else:
            c._reset(int(value))    # downward assignment = test-seam reset

    def as_dict(self) -> dict:
        counters = object.__getattribute__(self, "_counters")
        return {f: counters[f].value for f in self._FIELDS}

    def reset(self) -> None:
        """Zero the block — TEST-ONLY seam (see class docstring)."""
        counters = object.__getattribute__(self, "_counters")
        for c in counters.values():
            c._reset()
