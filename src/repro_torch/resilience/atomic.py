"""Crash-safe file writes: temp file + ``os.replace``.

A crash mid-write must never leave a torn file at the real path: the
engine's resume checkpoints go through here, so a killed process leaves
either the previous complete checkpoint or the new complete one.  The
``checkpoint.write`` injection site fires MID temp-file write (half the
payload on disk), so the chaos tests can show the torn state stays
confined to the ``.tmp`` side of the rename.
"""
from __future__ import annotations

import json
import os

from .faultinject import fire


def atomic_write_json(path: str, obj) -> None:
    """Serialize ``obj`` to ``path`` such that ``path`` is always either
    absent, the previous complete content, or the new complete content."""
    data = json.dumps(obj)
    tmp = path + ".tmp"
    mid = len(data) // 2
    with open(tmp, "w") as f:
        f.write(data[:mid])
        fire("checkpoint.write", tag=path)
        f.write(data[mid:])
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
