"""Crash-safe write-ahead log for the streaming edge store (the port's
copy of the JAX package's ``repro.stream.wal``: the same bytes, so a
log written by either package recovers in the other).

Binary layout: a 5-byte header (``TWAL`` magic + version byte) followed
by length-prefixed, checksummed records::

    record := type:u8 | length:u32le | crc32:u32le | payload[length]

Two record types:

* ``ingest`` (1) — the FILTERED edge batch (post self-loop drop) as the
  three ``int64`` little-endian arrays ``src | dst | t`` concatenated
  (``length`` is divisible by 24; ``n = length // 24``).  Appended
  write-ahead: the record is durable *before* the in-memory tail
  mutates, so a crash never loses an acknowledged batch.
* ``advance`` (2) — the epoch manifest ``{"epoch": i}`` as UTF-8 JSON,
  appended only *after* the snapshot materialized (at-least-once: a
  crash between materialization and the log entry re-runs a pure
  function of the same retained multiset, which is bit-identical).

Recovery (:meth:`repro_torch.stream.store.StreamStore.recover`) replays the
valid record prefix and TRUNCATES the torn tail: a record whose header
is incomplete, whose payload is short, or whose CRC32 mismatches marks
the end of the durable history — everything after it is discarded, which
is exactly the SIGKILL contract (acknowledged records survive; the
in-flight record vanishes as if never sent).

Durability: every append ends with ``flush`` + ``os.fsync`` through the
``wal.fsync`` fault-injection site, so the chaos suite can kill the
process at the sync boundary of every record.
"""
from __future__ import annotations

import json
import os
import struct
import zlib

import numpy as np

from .. import obs
from ..resilience import fire
from ..resilience.retry import STATS as RSTATS

MAGIC = b"TWAL"
VERSION = 1
_HEADER = MAGIC + bytes([VERSION])
_REC = struct.Struct("<BII")        # type, payload length, crc32

REC_INGEST = 1
REC_ADVANCE = 2


def _encode(rec_type: int, payload: bytes) -> bytes:
    return _REC.pack(rec_type, len(payload), zlib.crc32(payload)) + payload


class Wal:
    """Appender over one WAL file.

    ``Wal(path)`` creates the file (with header) if absent or empty and
    otherwise appends at the current end — callers that may hold a torn
    file (crash recovery) must truncate to the valid prefix FIRST via
    :func:`read_records`; :meth:`StreamStore.recover` does exactly that.
    """

    def __init__(self, path: str):
        self.path = path
        self.records = 0            # records appended by THIS process
        exists = os.path.exists(path) and os.path.getsize(path) > 0
        self._f = open(path, "ab")
        if not exists:
            self._f.write(_HEADER)
            self._f.flush()
            os.fsync(self._f.fileno())

    @property
    def offset(self) -> int:
        """Current durable end-of-log byte offset."""
        return self._f.tell()

    def _append(self, rec_type: int, payload: bytes) -> None:
        if self._f.closed:
            raise ValueError("WAL is closed")
        self._f.write(_encode(rec_type, payload))
        with obs.span("wal.fsync", stage="wal_fsync"):
            self._f.flush()
            fire("wal.fsync")
            os.fsync(self._f.fileno())
        self.records += 1
        RSTATS.wal_records += 1

    def append_ingest(self, src, dst, t) -> None:
        payload = (np.asarray(src).astype("<i8").tobytes()
                   + np.asarray(dst).astype("<i8").tobytes()
                   + np.asarray(t).astype("<i8").tobytes())
        self._append(REC_INGEST, payload)

    def append_advance(self, epoch: int) -> None:
        self._append(REC_ADVANCE,
                     json.dumps({"epoch": int(epoch)}).encode("utf-8"))

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


def read_records(path: str) -> tuple[list, int]:
    """Parse the valid record prefix of a WAL file.

    Returns ``(records, good_offset)`` where ``records`` is a list of
    ``("ingest", (src, dst, t))`` / ``("advance", epoch)`` tuples and
    ``good_offset`` is the byte offset just past the last intact record
    — the truncation point for crash recovery.  A missing or empty file
    yields ``([], 0)``; a foreign header yields ``ValueError`` (refusing
    to replay — or silently truncate — a file that is not a WAL).
    """
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        return [], 0
    if not data:
        return [], 0
    if not data.startswith(_HEADER):
        raise ValueError(f"{path}: not a WAL file (bad magic/version)")
    records: list = []
    pos = len(_HEADER)
    while True:
        if pos + _REC.size > len(data):
            break                                   # torn header
        rec_type, length, crc = _REC.unpack_from(data, pos)
        payload = data[pos + _REC.size: pos + _REC.size + length]
        if len(payload) < length or zlib.crc32(payload) != crc:
            break                                   # torn / corrupt payload
        if rec_type == REC_INGEST:
            if length % 24 != 0:
                break                               # corrupt but crc-valid?
            n = length // 24
            arr = np.frombuffer(payload, dtype="<i8")
            records.append(("ingest",
                            (arr[:n].astype(np.int64),
                             arr[n:2 * n].astype(np.int64),
                             arr[2 * n:].astype(np.int64))))
        elif rec_type == REC_ADVANCE:
            records.append(("advance",
                            int(json.loads(payload.decode("utf-8"))["epoch"])))
        else:
            break                                   # unknown type: stop
        pos += _REC.size + length
    return records, pos
