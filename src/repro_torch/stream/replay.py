"""Replay recorded edge-list files as a live stream (the port's copy of
the JAX package's ``repro.stream.replay``).

Bridges the offline loaders (``graphs.loader.iter_edge_batches``) onto a
:class:`StreamStore` / :class:`StreamingSession`: feed a file through in
bounded batches, advancing an epoch every ``advance_every`` batches —
the offline rehearsal of a production stream (and the CLI's
``--stream-replay`` backend).
"""
from __future__ import annotations

from typing import Callable, Iterator

from ..graphs.loader import iter_edge_batches
from .session import EpochResult, StreamingSession
from .store import StreamStore


def replay_edge_list(store: StreamStore, path: str,
                     batch_size: int = 65536) -> int:
    """Ingest every edge of ``path`` into ``store``; returns #accepted.

    No epochs are advanced — pair with ``store.advance()`` (or use
    ``replay_epochs`` for the advance-as-you-go loop).
    """
    total = 0
    for src, dst, t in iter_edge_batches(path, batch_size):
        total += store.ingest(src, dst, t)
    return total


def replay_epochs(session: StreamingSession, path: str,
                  batch_size: int = 65536, advance_every: int = 1,
                  on_epoch: Callable[[EpochResult], None] | None = None,
                  ) -> Iterator[EpochResult]:
    """Replay ``path`` through a streaming session, one epoch per
    ``advance_every`` ingested batches (plus a final epoch for any
    leftover partial batch).  Yields each :class:`EpochResult` (and calls
    ``on_epoch`` first, when given) — a generator so callers can stop the
    replay early by simply not consuming further epochs.
    """
    if advance_every < 1:
        raise ValueError(f"advance_every must be >= 1, got {advance_every}")
    since_advance = 0
    for src, dst, t in iter_edge_batches(path, batch_size):
        session.ingest(src, dst, t)
        since_advance += 1
        if since_advance >= advance_every:
            since_advance = 0
            er = session.advance()
            if on_epoch is not None:
                on_epoch(er)
            yield er
    if since_advance and session.store.buffered:
        er = session.advance()
        if on_epoch is not None:
            on_epoch(er)
        yield er
