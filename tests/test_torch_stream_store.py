"""The port's stream store and WAL against the reference's.

The same edge batches through both packages' ``StreamStore`` give equal
epochs, ``StoreStats`` and padded snapshots, across eviction, segment
merges and bucket changes; the WAL files are byte-equal and each
package recovers the other's log; recovery from every truncation point
of a log gives the reference's store; and a ``wal.fsync`` fault leaves
the tail as the reference leaves it.
"""
from __future__ import annotations

import dataclasses
import shutil

import numpy as np
import pytest

import repro.api  # noqa: F401  (repro.stream imports through repro.api)
from repro.resilience import FaultInjector as RFaultInjector
from repro.resilience import FaultSpec as RFaultSpec
from repro.resilience import TransientError as RTransientError
from repro.resilience import seeded_hits as rseeded_hits
from repro.resilience.retry import STATS as RRSTATS
from repro.stream import StreamStore as RStore
from repro.stream.wal import read_records as rread_records
from repro_torch.resilience import (STATS, FaultInjector, FaultSpec,
                                    TransientError, seeded_hits)
from repro_torch.stream import StreamStore
from repro_torch.stream.wal import read_records

# small bucket floors and two segments: the buckets change as the
# window fills and slides, and segments merge
STORE = dict(horizon=9_000, max_segments=2, min_m_bucket=64,
             min_n_bucket=16, min_p_bucket=32)
EPOCH = ("index", "t_lo", "t_hi", "m_real", "n_real", "evicted",
         "ingested_total", "evicted_total", "buckets")


def _batches(seed: int = 0, n_batches: int = 8, size: int = 150):
    """Edge batches in loosely increasing time, with self-loops and
    repeated (src, dst, t) tuples, as a live stream delivers them."""
    r = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        src = r.integers(0, 40, size)
        dst = r.integers(0, 40, size)
        t = b * 2_500 + r.integers(0, 4_000, size)
        src[:5], dst[:5], t[:5] = src[5:10], dst[5:10], t[5:10]
        out.append((src, dst, t))
    return out


def _same_epoch(got, want) -> None:
    for f in EPOCH:
        assert getattr(got, f) == getattr(want, f), f
    for f in dataclasses.fields(want.graph):
        a, b = getattr(got.graph, f.name), getattr(want.graph, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


def _same_state(got, want) -> None:
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)
    assert (got.epoch, got.buffered, got.retained) == \
        (want.epoch, want.buffered, want.retained)


def _drive(store, batches, advance_every: int = 1):
    epochs = []
    for i, (src, dst, t) in enumerate(batches):
        store.ingest(src, dst, t)
        if (i + 1) % advance_every == 0:
            epochs.append(store.advance())
    return epochs


@pytest.mark.parametrize("advance_every", [1, 3])
@pytest.mark.parametrize("floors", [{}, dict(min_m_bucket=1, min_n_bucket=1,
                                             min_p_bucket=1)],
                         ids=["floors", "no-floors"])
def test_epochs_and_stats_equal_reference(advance_every, floors):
    batches = _batches()
    cfg = {**STORE, **floors}
    want_store, got_store = RStore(**cfg), StreamStore(**cfg)
    want = _drive(want_store, batches, advance_every)
    got = _drive(got_store, batches, advance_every)
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        _same_epoch(g, w)
    _same_state(got_store, want_store)
    assert got_store.stats.evicted > 0 and got_store.stats.dropped > 0
    if advance_every == 1:
        assert got_store.stats.merges > 0
        assert len({e.buckets for e in got}) > 1


def test_scalar_ingest_compact_and_refusals_as_the_reference():
    want, got = RStore(**STORE), StreamStore(**STORE)
    for s in (want, got):
        assert s.ingest(3, 3, 10) == 0            # a self-loop only
        assert s.ingest(1, 2, 10) == 1
        assert s.compact() == 0
    _same_state(got, want)
    for bad in (lambda S: S(horizon=-1),
                lambda S: S().ingest([1, 2], [3], [4]),
                lambda S: S().advance()):
        with pytest.raises(ValueError) as w:
            bad(RStore)
        with pytest.raises(ValueError) as g:
            bad(StreamStore)
        assert str(g.value) == str(w.value)


def _logged(store_cls, path, batches):
    store = store_cls(wal=str(path), **STORE)
    epochs = _drive(store, batches, advance_every=2)
    store.wal.close()
    return epochs


def test_wal_files_are_byte_equal(tmp_path):
    batches = _batches(1)
    _logged(RStore, tmp_path / "ref.wal", batches)
    _logged(StreamStore, tmp_path / "port.wal", batches)
    ref = (tmp_path / "ref.wal").read_bytes()
    assert ref.startswith(b"TWAL\x01") and len(ref) > 1000
    assert (tmp_path / "port.wal").read_bytes() == ref


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_each_package_recovers_the_others_wal(tmp_path, writer):
    """Recovery replays ingests and advance manifests; the recovered
    store's next ingest and advance equal the uncrashed store's."""
    batches = _batches(2)
    head, tail = batches[:5], batches[5:]
    path = tmp_path / "w.wal"
    _logged(RStore if writer == "reference" else StreamStore, path, head)
    copy = tmp_path / "copy.wal"
    shutil.copy(path, copy)
    STATS.reset()
    got = StreamStore.recover(str(path), **STORE)
    want = RStore.recover(str(copy), **STORE)
    assert STATS.wal_replayed == len(read_records(str(path))[0]) > 0
    _same_state(got, want)
    for src, dst, t in tail:
        got.ingest(src, dst, t)
        want.ingest(src, dst, t)
        _same_epoch(got.advance(), want.advance())
    got.wal.close()
    want.wal.close()
    assert path.read_bytes() == copy.read_bytes()


def test_recovery_at_every_truncation_point(tmp_path):
    """A log cut at any byte past its 5-byte header recovers to the
    reference's store (the torn record dropped, the file truncated to
    the valid prefix), and at every record boundary the next advance
    equals the reference's too; a cut inside the header is refused by
    both."""
    path = tmp_path / "full.wal"
    _logged(StreamStore, path, _batches(3, n_batches=4, size=20))
    data = path.read_bytes()
    _, good = read_records(str(path))
    assert good == len(data)
    boundaries = set()
    for cut in range(len(data) + 1):
        mine, theirs = tmp_path / "a.wal", tmp_path / "b.wal"
        mine.write_bytes(data[:cut])
        theirs.write_bytes(data[:cut])
        if 0 < cut < 5:
            for read in (read_records, rread_records):
                with pytest.raises(ValueError, match="not a WAL file"):
                    read(str(mine))
            continue
        recs, off = read_records(str(mine))
        rrecs, roff = rread_records(str(theirs))
        assert off == roff and len(recs) == len(rrecs), cut
        got = StreamStore.recover(str(mine), **STORE)
        want = RStore.recover(str(theirs), **STORE)
        _same_state(got, want)
        assert mine.read_bytes() == theirs.read_bytes()
        if off == cut and got.retained:
            boundaries.add(cut)
            _same_epoch(got.advance(), want.advance())
        got.wal.close()
        want.wal.close()
    assert len(boundaries) >= 6


def test_recovery_refuses_a_foreign_file(tmp_path):
    path = tmp_path / "x.wal"
    path.write_bytes(b"not a wal file")
    for store_cls in (StreamStore, RStore):
        with pytest.raises(ValueError, match="not a WAL file"):
            store_cls.recover(str(path))
    assert path.read_bytes() == b"not a wal file"


def test_fsync_fault_leaves_the_tail_untouched(tmp_path):
    """The second ingest's fsync fails: the batch is not acknowledged and
    the tail does not take it, in both packages; the record written
    before the sync is replayed on recovery (at-least-once), also in
    both."""
    batches = _batches(4, n_batches=3, size=30)
    results = {}
    for name, store_cls, inj, spec, exc in (
            ("ref", RStore, RFaultInjector, RFaultSpec, RTransientError),
            ("port", StreamStore, FaultInjector, FaultSpec,
             TransientError)):
        path = tmp_path / f"{name}.wal"
        store = store_cls(wal=str(path), **STORE)
        store.ingest(*batches[0])
        before = (store.buffered, store.stats.ingested, store.wal.records)
        with inj([spec("wal.fsync", hits=(0,))]) as fi:
            with pytest.raises(exc, match="injected fault at wal.fsync"):
                store.ingest(*batches[1])
        assert fi.log == [("wal.fsync", "", 0, True)]
        assert (store.buffered, store.stats.ingested,
                store.wal.records) == before
        store.ingest(*batches[2])
        store.wal.close()
        results[name] = (path.read_bytes(), store_cls.recover(str(path),
                                                              **STORE))
    assert results["port"][0] == results["ref"][0]
    got, want = results["port"][1], results["ref"][1]
    _same_state(got, want)
    assert got.stats.ingested == sum(int((src != dst).sum())
                                     for src, dst, _ in batches)


def test_seeded_hits_and_stats_as_the_reference():
    for seed in (0, 7, 2 ** 63 + 5):
        for rate in (0.0, 0.3, 1.0):
            assert seeded_hits(seed, 50, rate) == rseeded_hits(seed, 50, rate)
    with pytest.raises(ValueError, match="rate must be in"):
        seeded_hits(0, 5, 1.5)
    assert set(STATS.as_dict()) == set(RRSTATS.as_dict())
