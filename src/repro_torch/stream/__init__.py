"""Streaming graph subsystem of the PyTorch port: live ingestion, epoch
snapshots, standing queries.

Torch counterpart of ``repro.stream`` (its docstring is the canonical
guide)::

    from repro_torch.stream import StandingQuery, StreamingSession

    ss = StreamingSession(horizon=100_000)        # device="cuda"
    qid = ss.subscribe(StandingQuery("M5-3", delta=4_000, k=1 << 14))

    ss.ingest(src, dst, t)          # O(batch) append, repeatedly
    er = ss.advance()               # epoch 0: snapshot + re-estimate
    res = er.results[qid]
    print(er.epoch.index, res.estimate, res.rse)

``StreamStore`` (tiers, eviction, merges, power-of-two padded
snapshots), ``StandingQuery`` / ``StreamingSession``, ``replay_edge_list``
/ ``replay_epochs`` (the CLI's ``--stream-replay``) and ``Wal`` (the
CLI's ``--serve --stream --wal PATH``) keep the reference's names,
checks, file format and numbers: each standing query's count at epoch
``e`` equals a cold ``estimate()`` on that epoch's snapshot, bit for bit.
Pass ``config=EstimateConfig(device="cpu")`` to run on the CPU.
"""
from .replay import replay_edge_list, replay_epochs
from .session import (EpochResult, StandingQuery, StreamingSession,
                      StreamStats)
from .store import Epoch, StoreStats, StreamStore
from .wal import Wal

__all__ = [
    "Epoch", "EpochResult", "StandingQuery", "StoreStats", "StreamStats",
    "StreamStore", "StreamingSession", "Wal", "replay_edge_list",
    "replay_epochs",
]
