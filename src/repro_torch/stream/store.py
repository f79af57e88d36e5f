"""Append-only streaming edge store with epoch snapshots (tier design).

The port's copy of the JAX package's ``repro.stream.store``: the same
tiers, eviction, merges, bucket floors and WAL records, so the same
batches give the reference's epochs and snapshot arrays.

Three tiers, coldest to hottest:

* **tail buffer** — ``ingest()`` appends raw ``(src, dst, t)`` batches to
  a mutable list; O(1) per batch, nothing is sorted or indexed here.
* **segments** — ``advance()`` (or an explicit ``compact()``) sorts the
  tail by time and seals it into an immutable segment; when more than
  ``max_segments`` accumulate they merge into one.  Sliding-window
  retention happens at compaction: edges older than ``t_max - horizon``
  are dropped with a single ``searchsorted`` cut per (time-sorted)
  segment.
* **snapshot** — ``advance()`` materializes the retained edges into a
  :class:`TemporalGraph` via ``from_edges`` (dedup + relabel + CSR
  build), pads it to power-of-two buckets (``core.graph.pad_snapshot``)
  and returns an :class:`Epoch`.

In the reference the padding lets epochs sharing buckets re-hit jax's
compiled programs; torch compiles nothing, so the port pads only to
give the reference's snapshots array for array (the estimates are the
same either way: pad edges carry zero weight).  Bucket floors
(``min_m_bucket`` etc.) keep early, small epochs from churning through
many tiny buckets while the stream warms up.

Determinism: an epoch's snapshot is a pure function of the multiset of
retained edges — ingest batching, segment boundaries and compaction
order cannot change it (``from_edges`` fully re-sorts and dedups).

Durability: an optional write-ahead log (``stream/wal.py``) makes the
store crash-safe.  Every accepted ``ingest()`` batch is logged (fsynced)
*before* the tail mutates and every completed ``advance()`` appends an
epoch manifest; :meth:`StreamStore.recover` rebuilds a store from the
log's valid prefix (truncating a torn tail) such that its next
``advance()`` is bit-identical to the uncrashed store's.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .. import obs
from ..core.graph import TemporalGraph, pad_snapshot


@dataclass
class Epoch:
    """One materialized snapshot of the stream."""

    index: int                  # 0-based advance counter
    graph: TemporalGraph        # padded snapshot (graph.live_m real edges)
    t_lo: int                   # oldest retained ORIGINAL timestamp
    t_hi: int                   # newest retained original timestamp
    m_real: int                 # live edges in the snapshot (post-dedup)
    n_real: int                 # live vertices
    evicted: int                # edges evicted by this advance
    ingested_total: int         # edges accepted since store creation
    evicted_total: int
    snapshot_s: float = 0.0     # wall-clock of this materialization

    @property
    def buckets(self) -> tuple[int, int, int]:
        g = self.graph
        return (g.m, g.n, g.num_pairs)


@dataclass
class _Segment:
    src: np.ndarray
    dst: np.ndarray
    t: np.ndarray               # non-decreasing


@dataclass
class StoreStats:
    ingested: int = 0           # edges accepted into the tail
    dropped: int = 0            # self-loops rejected at ingest
    evicted: int = 0            # edges aged out of the horizon
    compactions: int = 0
    merges: int = 0
    epochs: int = 0


class StreamStore:
    """Live edge ingestion + sliding-window epoch snapshots.

    ``horizon`` is the retention window in time units: at compaction,
    edges with ``t < t_max - horizon`` (``t_max`` = newest timestamp seen)
    are evicted.  ``None`` retains everything (a growing graph).

    ``wal`` names a write-ahead log file: accepted ingest batches are
    logged before the tail mutates, completed advances append an epoch
    manifest, and :meth:`recover` rebuilds from it after a crash.  Use
    ``recover`` (not the constructor) for a path that may hold history.
    """

    def __init__(self, horizon: int | None = None, *,
                 max_segments: int = 8, min_m_bucket: int = 1024,
                 min_n_bucket: int = 64, min_p_bucket: int = 256,
                 wal: str | None = None):
        if horizon is not None and horizon < 0:
            raise ValueError(f"horizon must be >= 0, got {horizon}")
        self.horizon = horizon
        self.max_segments = int(max_segments)
        self.min_m_bucket = int(min_m_bucket)
        self.min_n_bucket = int(min_n_bucket)
        self.min_p_bucket = int(min_p_bucket)
        self.stats = StoreStats()
        self._tail: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._tail_len = 0
        self._segments: list[_Segment] = []
        self._t_max: int | None = None      # newest timestamp ever seen
        self._epoch = 0
        self._wal = None
        if wal is not None:
            from .wal import Wal
            self._wal = Wal(wal)

    @property
    def wal(self):
        """The attached :class:`repro_torch.stream.wal.Wal`, or None."""
        return self._wal

    @classmethod
    def recover(cls, path: str, **kw) -> "StreamStore":
        """Rebuild a store from WAL ``path`` and keep logging to it.

        Replays the log's valid record prefix — ingest batches refill
        the tiers, advance manifests re-run compaction/eviction and bump
        the epoch counter (no snapshot is materialized during replay) —
        after TRUNCATING any torn tail a crash left behind.  Because an
        epoch snapshot is a pure function of the retained edge multiset,
        the recovered store's next ``advance()`` is bit-identical to the
        uncrashed store's.  A missing or empty file yields a fresh store
        with a new WAL at ``path``.  ``**kw`` are constructor arguments
        (``horizon=...`` etc.).
        """
        from ..resilience.retry import STATS as RSTATS
        from .wal import Wal, read_records

        records, good = read_records(path)
        if os.path.exists(path) and os.path.getsize(path) > good:
            with open(path, "r+b") as f:
                f.truncate(good)            # discard the torn tail
        store = cls(**kw)                   # no WAL yet: replay must not
        for kind, payload in records:       # re-log its own records
            if kind == "ingest":
                src, dst, t = payload
                store.ingest(src, dst, t)
            else:                           # advance manifest
                store.compact()
                store._epoch += 1
                store.stats.epochs += 1
        RSTATS.wal_replayed += len(records)
        store._wal = Wal(path)              # append past the valid prefix
        return store

    # -- ingestion -------------------------------------------------------
    def ingest(self, src, dst, t) -> int:
        """Append an edge batch (scalars or arrays) to the tail buffer.

        Self-loops are dropped (the graph model excludes them); returns
        the number of edges accepted.  O(batch) — no sorting or index
        work happens until ``advance()``/``compact()``.  Inputs are
        COPIED into the tail, so callers may reuse their batch buffers.
        """
        src = np.array(src, dtype=np.int64, copy=True, ndmin=1)
        dst = np.array(dst, dtype=np.int64, copy=True, ndmin=1)
        t = np.array(t, dtype=np.int64, copy=True, ndmin=1)
        if not (src.shape == dst.shape == t.shape) or src.ndim != 1:
            raise ValueError("ingest: src/dst/t must be equal-length 1-D")
        keep = src != dst
        dropped = int(src.size - keep.sum())
        if dropped:
            src, dst, t = src[keep], dst[keep], t[keep]
            self.stats.dropped += dropped
        if src.size == 0:
            return 0
        if self._wal is not None:
            # write-ahead: the FILTERED batch is durable before the tail
            # mutates, so an acknowledged ingest survives any crash
            self._wal.append_ingest(src, dst, t)
        self._tail.append((src, dst, t))
        self._tail_len += src.size
        tmax = int(t.max())
        if self._t_max is None or tmax > self._t_max:
            self._t_max = tmax
        self.stats.ingested += src.size
        return int(src.size)

    # -- tiers -----------------------------------------------------------
    @property
    def buffered(self) -> int:
        """Edges waiting in the mutable tail (not yet in a segment)."""
        return self._tail_len

    @property
    def retained(self) -> int:
        """Edges in sealed segments (pre-dedup) + the tail."""
        return sum(s.t.size for s in self._segments) + self._tail_len

    @property
    def epoch(self) -> int:
        """Epochs materialized so far (the next advance returns this)."""
        return self._epoch

    def compact(self) -> int:
        """Seal the tail into a segment, merge, evict; returns #evicted.

        Idempotent when the tail is empty and nothing has aged out.
        """
        if self._tail:
            src = np.concatenate([b[0] for b in self._tail])
            dst = np.concatenate([b[1] for b in self._tail])
            t = np.concatenate([b[2] for b in self._tail])
            self._tail, self._tail_len = [], 0
            order = np.argsort(t, kind="stable")
            self._segments.append(_Segment(src[order], dst[order], t[order]))
            self.stats.compactions += 1
        evicted = 0
        if self.horizon is not None and self._t_max is not None:
            watermark = self._t_max - self.horizon
            live: list[_Segment] = []
            for s in self._segments:
                cut = int(np.searchsorted(s.t, watermark, side="left"))
                evicted += cut
                if cut < s.t.size:
                    live.append(_Segment(s.src[cut:], s.dst[cut:],
                                         s.t[cut:]) if cut else s)
            self._segments = live
            self.stats.evicted += evicted
        if len(self._segments) > self.max_segments:
            src = np.concatenate([s.src for s in self._segments])
            dst = np.concatenate([s.dst for s in self._segments])
            t = np.concatenate([s.t for s in self._segments])
            order = np.argsort(t, kind="stable")
            self._segments = [_Segment(src[order], dst[order], t[order])]
            self.stats.merges += 1
        return evicted

    # -- snapshots -------------------------------------------------------
    def advance(self) -> Epoch:
        """Compact, evict, and materialize the next epoch snapshot."""
        t0 = obs.perf_counter()
        evicted = self.compact()
        total = sum(s.t.size for s in self._segments)
        if total == 0:
            raise ValueError(
                "advance() on an empty stream (nothing retained — "
                "ingest edges first, or widen the horizon)")
        src = np.concatenate([s.src for s in self._segments])
        dst = np.concatenate([s.dst for s in self._segments])
        t = np.concatenate([s.t for s in self._segments])
        g = TemporalGraph.from_edges(src, dst, t)
        m_real, n_real = g.m, g.n
        g = pad_snapshot(g, m_floor=self.min_m_bucket,
                         n_floor=self.min_n_bucket,
                         p_floor=self.min_p_bucket)
        epoch = Epoch(
            index=self._epoch, graph=g,
            t_lo=int(t.min()), t_hi=int(t.max()),
            m_real=m_real, n_real=n_real, evicted=evicted,
            ingested_total=self.stats.ingested,
            evicted_total=self.stats.evicted,
            snapshot_s=obs.perf_counter() - t0)
        self._epoch += 1
        self.stats.epochs += 1
        if self._wal is not None:
            # logged AFTER the snapshot exists (at-least-once): a crash
            # in between re-runs a pure function of the same retained
            # multiset on recovery — bit-identical either way
            self._wal.append_advance(epoch.index)
        return epoch
