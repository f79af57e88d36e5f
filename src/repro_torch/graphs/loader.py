"""Edge-list IO for temporal graphs (own copy of ``repro.graphs.loader``;
files written by either package load in the other).

Text format (SNAP-style): one ``src dst t`` triple per line, '#' comments;
``.gz``-compressed text is read transparently.  Binary format: ``.npz``
with src/dst/t arrays (order-of-magnitude faster to load; the cache of
choice for repeated runs).

``iter_edge_batches`` is the streaming reader: it yields bounded
``(src, dst, t)`` batches without ever materializing the whole file —
the replay path of a live edge stream.
"""
from __future__ import annotations

import gzip
import os
from typing import IO, Iterator

import numpy as np

from ..core.graph import TemporalGraph


def _open_text(path: str) -> IO:
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path)


def load_edge_list(path: str, cache: bool = True) -> TemporalGraph:
    """Load ``src dst t`` text (optionally ``.gz``) or ``.npz``;
    transparently caches text→npz next to the source file."""
    if path.endswith(".npz"):
        z = np.load(path)
        return TemporalGraph.from_edges(z["src"], z["dst"], z["t"])
    # cache under the FULL name (x.txt.npz / x.txt.gz.npz): a directory
    # holding both x.txt and x.txt.gz must not share one cache file
    npz = path + ".npz"
    if cache and os.path.exists(npz) and (
            os.path.getmtime(npz) >= os.path.getmtime(path)):
        return load_edge_list(npz)
    with _open_text(path) as f:
        data = np.loadtxt(f, dtype=np.int64, comments="#")
    if data.ndim == 1:
        data = data[None, :]
    if data.shape[1] < 3:
        raise ValueError(f"{path}: need 'src dst t' columns")
    g = TemporalGraph.from_edges(data[:, 0], data[:, 1], data[:, 2])
    if cache:
        try:
            np.savez_compressed(npz, src=data[:, 0], dst=data[:, 1],
                                t=data[:, 2])
        except OSError:
            pass
    return g


def iter_edge_batches(path: str, batch_size: int = 65536
                      ) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Stream ``(src, dst, t)`` int64 batches of <= ``batch_size`` edges.

    Reads text / ``.gz`` text line-by-line (bounded memory regardless of
    file size) and ``.npz`` by slicing; preserves file order, skips blank
    and '#'-comment lines.  The batches concatenate to exactly what
    ``load_edge_list`` would parse.
    """
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    if path.endswith(".npz"):
        z = np.load(path)
        src = np.asarray(z["src"], dtype=np.int64)
        dst = np.asarray(z["dst"], dtype=np.int64)
        t = np.asarray(z["t"], dtype=np.int64)
        for lo in range(0, len(src), batch_size):
            hi = lo + batch_size
            yield src[lo:hi], dst[lo:hi], t[lo:hi]
        return
    rows: list[tuple[int, int, int]] = []
    with _open_text(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 3:
                raise ValueError(f"{path}:{ln}: need 'src dst t' columns")
            rows.append((int(parts[0]), int(parts[1]), int(parts[2])))
            if len(rows) >= batch_size:
                a = np.asarray(rows, dtype=np.int64)
                rows = []
                yield a[:, 0], a[:, 1], a[:, 2]
    if rows:
        a = np.asarray(rows, dtype=np.int64)
        yield a[:, 0], a[:, 1], a[:, 2]


def save_edge_list(g: TemporalGraph, path: str) -> None:
    if path.endswith(".npz"):
        np.savez_compressed(path, src=g.src, dst=g.dst, t=g.t)
    elif path.endswith(".gz"):
        with gzip.open(path, "wt") as f:
            np.savetxt(f, np.stack([g.src, g.dst, g.t], axis=1), fmt="%d")
    else:
        np.savetxt(path, np.stack([g.src, g.dst, g.t], axis=1), fmt="%d")
