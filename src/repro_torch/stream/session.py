"""Standing motif queries over a live edge stream.

Torch counterpart of ``repro.stream.session`` (its docstring holds the
design notes).  A :class:`StreamingSession` couples a
:class:`~repro_torch.stream.store.StreamStore` with the session API:
``subscribe()`` registers a :class:`StandingQuery` (motif + delta +
budget) once, and every ``advance()`` materializes the next epoch
snapshot and re-estimates all standing queries against it through a
fresh ``api.Session`` over that snapshot.

What carries across epochs: the frozen ``EstimateConfig`` (its device
checked once, at construction) and the built kernels.  What does not:
the device arrays, ``Weights`` and tree selection.  Each advance closes
the old epoch's session and drops it, so its arrays are freed, and
re-plans on the new snapshot exactly as a cold ``estimate()`` would.

**Epoch determinism contract** (the reference's): the count reported
for standing query ``Q`` at epoch ``e`` is bit-identical to a cold
``estimate(epoch.graph, Q.motif, Q.delta, Q.k, seed=Q.seed)`` on that
epoch's snapshot, and to one on the unpadded retained graph.  Standing
queries whose trees share a structural signature fuse into one tree
cohort per window; fusion never changes bits.

Telemetry: an advance is an intake point (it mints or inherits a trace
id) and records the ``stream.advance`` span (stage ``advance``) with
``stream.estimate`` (the standing queries' drain) inside it; their
``elapsed_s`` are the result's ``advance_s`` and ``estimate_s``.

The data mesh (``mesh=``): every epoch's fresh ``Session`` gets it, so
each epoch copies its snapshot and Weights once to every distinct
device of the mesh other than shard 0's (none on a mesh whose shards
share one card); the copies go with the epoch's session, since a padded
snapshot is new every epoch.
"""
from __future__ import annotations

from dataclasses import dataclass

from .. import obs
from ..api.config import EstimateConfig
from ..api.session import MAX_WITNESSES, Request, Session
from ..core.engine import shard_devices
from ..core.estimator import EstimateResult
from ..core.motif import TemporalMotif, get_motif
from .store import Epoch, StreamStore


@dataclass(frozen=True)
class StandingQuery:
    """One registered query, re-estimated on every epoch.

    ``motif`` accepts catalog names, inline edge-list specs
    ("0-1,1-2,2-0") or a ``TemporalMotif``.  ``seed`` is re-used verbatim
    each epoch, so the per-epoch estimate equals a cold ``estimate()``
    with that seed on the epoch's snapshot.  ``target_rse``/``k_max``
    make the per-epoch budget adaptive (session semantics).
    ``witnesses=n`` asks every epoch's result for up to ``n`` accepted
    full-match edge tuples (``EstimateResult.witnesses``: the
    deterministic reservoir, so same seed + same snapshot means the
    same witnesses).
    """

    motif: TemporalMotif | str
    delta: int
    k: int
    seed: int = 0
    target_rse: float | None = None
    k_max: int | None = None
    name: str | None = None
    witnesses: int = 0

    def __post_init__(self) -> None:
        if isinstance(self.motif, str):
            get_motif(self.motif)     # validate eagerly, not at advance
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.delta < 0:
            raise ValueError(f"delta must be >= 0, got {self.delta}")
        if not 0 <= self.witnesses <= MAX_WITNESSES:
            raise ValueError(f"witnesses must be in [0, {MAX_WITNESSES}], "
                             f"got {self.witnesses}")

    @property
    def label(self) -> str:
        if self.name:
            return self.name
        return self.motif if isinstance(self.motif, str) else self.motif.name


@dataclass
class EpochResult:
    """Everything one ``advance()`` produced."""

    epoch: Epoch
    results: dict[int, EstimateResult]    # subscription id -> result
    advance_s: float = 0.0                # snapshot + plan + estimate
    estimate_s: float = 0.0               # the standing-query drain alone


@dataclass
class StreamStats:
    epochs: int = 0
    queries_run: int = 0
    subscribe_calls: int = 0
    advance_s_total: float = 0.0


class StreamingSession:
    """A persistent estimation service over a LIVE graph::

        ss = StreamingSession(horizon=100_000)      # device="cuda"
        qid = ss.subscribe(StandingQuery("M5-3", delta=4_000, k=1 << 14))
        ss.ingest(src, dst, t)              # repeatedly, as edges arrive
        er = ss.advance()                   # epoch 0
        print(er.results[qid].estimate, er.results[qid].rse)

    ``store`` injects an existing :class:`StreamStore` (otherwise one is
    built from ``horizon`` + ``store_kw``); ``config`` is applied to
    every epoch's session, and its ``device`` ("cuda" by default) is
    where each snapshot lives and the kernels run; ``mesh`` (a data mesh
    of that device type) shards every epoch's windows.  ``session`` is the
    CURRENT epoch's ``api.Session`` (None before the first advance);
    ad-hoc one-shot requests go through :meth:`query`.
    """

    def __init__(self, store: StreamStore | None = None,
                 config: EstimateConfig | None = None, *,
                 horizon: int | None = None, mesh=None, **store_kw):
        if store is not None and (horizon is not None or store_kw):
            raise ValueError("pass either an existing store OR "
                             "horizon/store kwargs, not both")
        self.config = (config or EstimateConfig()).resolve()
        shard_devices(mesh, self.config.device)    # checked once, here
        self.mesh = mesh
        self.store = store if store is not None else StreamStore(
            horizon=horizon, **store_kw)
        self.session: Session | None = None
        self.epoch: Epoch | None = None
        self.stats = StreamStats()
        self._queries: dict[int, StandingQuery] = {}
        self._next_qid = 0
        self._closed = False

    # -- lifecycle -------------------------------------------------------
    def __enter__(self) -> "StreamingSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Close the current epoch's session and drop it: its device
        arrays and Weights are freed with it."""
        if not self._closed:
            if self.session is not None:
                self.session.close()
                self.session = None
            self._closed = True

    # -- subscriptions ---------------------------------------------------
    def subscribe(self, query: StandingQuery) -> int:
        """Register a standing query; returns its subscription id."""
        if self._closed:
            raise RuntimeError("StreamingSession is closed")
        qid = self._next_qid
        self._next_qid += 1
        self._queries[qid] = query
        self.stats.subscribe_calls += 1
        return qid

    def unsubscribe(self, qid: int) -> StandingQuery:
        return self._queries.pop(qid)

    @property
    def queries(self) -> dict[int, StandingQuery]:
        return dict(self._queries)

    # -- stream plumbing -------------------------------------------------
    def ingest(self, src, dst, t) -> int:
        if self._closed:
            raise RuntimeError("StreamingSession is closed")
        return self.store.ingest(src, dst, t)

    # -- epochs ----------------------------------------------------------
    def advance(self) -> EpochResult:
        """Materialize the next epoch and re-estimate standing queries.

        The old epoch's session is closed and dropped BEFORE the new
        snapshot goes to the device, so two epochs' arrays never share
        the card.
        """
        if self._closed:
            raise RuntimeError("StreamingSession is closed")
        # an advance is an intake point: mint (or inherit) a trace id so
        # the epoch's snapshot/plan/drain spans chain together
        tid = obs.current_trace() or (
            obs.new_trace() if obs.enabled(obs.TRACE) else None)
        with obs.trace_context(tid), \
                obs.span("stream.advance", stage="advance",
                         queries=len(self._queries)) as sp_adv:
            epoch = self.store.advance()
            if self.session is not None:
                self.session.close()
                self.session = None
            self.session = Session(epoch.graph, self.config, mesh=self.mesh)
            self.epoch = epoch
            sp_adv.set(epoch=epoch.index)
            results: dict[int, EstimateResult] = {}
            with obs.span("stream.estimate") as sp_est:
                if self._queries:
                    items = list(self._queries.items())
                    handles = self.session.submit_many([
                        Request(motif=q.motif, delta=int(q.delta),
                                k=int(q.k), seed=int(q.seed),
                                target_rse=q.target_rse, k_max=q.k_max,
                                witnesses=int(q.witnesses))
                        for _, q in items])
                    for (qid, _), h in zip(items, handles):
                        results[qid] = h.result()
        dt = sp_adv.elapsed_s
        self.stats.epochs += 1
        self.stats.queries_run += len(results)
        self.stats.advance_s_total += dt
        return EpochResult(epoch=epoch, results=results, advance_s=dt,
                           estimate_s=sp_est.elapsed_s)

    # -- ad-hoc queries --------------------------------------------------
    def query(self, request: Request) -> EstimateResult:
        """One-shot request against the CURRENT epoch's snapshot."""
        if self.session is None:
            raise RuntimeError("no epoch materialized yet — ingest edges "
                               "and advance() first")
        return self.session.submit(request).result()
