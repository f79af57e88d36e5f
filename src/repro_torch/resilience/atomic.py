"""Crash-safe file writes: temp file + ``os.replace``.

A crash mid-write must never leave a torn file at the real path: the
engine's resume checkpoints go through here, so a killed process leaves
either the previous complete checkpoint or the new complete one.
"""
from __future__ import annotations

import json
import os


def atomic_write_json(path: str, obj) -> None:
    """Serialize ``obj`` to ``path`` such that ``path`` is always either
    absent, the previous complete content, or the new complete content."""
    data = json.dumps(obj)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
