"""Deadline line reader for the NDJSON serve loop.

Own copy of ``repro.gateway.io.LineSource``: the select-based reader the
serve loop uses for coalescing-window timeouts.  It always runs at least
one zero-wait ``select``/drain pass first, so a complete line already
sitting in the OS pipe buffer is returned even at an expired deadline,
and a client trickling bytes still cannot hold the caller past its
total deadline.
"""
from __future__ import annotations

import os
import select
import time
from typing import IO


class LineSource:
    """Line reader with total-deadline timeouts over a file object.

    Real pipes/ttys go through ``select`` + ``os.read`` on the raw fd
    (Python-level buffering would hide buffered lines from ``select``);
    fd-less streams (``io.StringIO`` in tests) fall back to plain
    ``readline``, treating all input as immediately available.

    ``readline(timeout)`` -> line str WITH its trailing newline (so a
    blank line is ``"\\n"``, distinguishable from EOF), ``None`` on
    timeout, ``""`` only at EOF.  The timeout is a TOTAL deadline for
    producing one line, not a per-select re-arm — and bytes already
    available on the fd are always drained before the deadline is
    enforced, so ``readline(0)`` returns a buffered complete line
    instead of timing out on it.
    """

    def __init__(self, f: IO):
        self._f = f
        try:
            self._fd: int | None = f.fileno()
        except (AttributeError, OSError, ValueError):
            self._fd = None
        self._buf = b""
        self._eof = False

    def readline(self, timeout: float | None = None) -> str | None:
        if self._fd is None:
            return self._f.readline()          # "" only at EOF
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if b"\n" in self._buf:
                line, _, self._buf = self._buf.partition(b"\n")
                return line.decode("utf-8", "replace") + "\n"
            if self._eof:
                line, self._buf = self._buf, b""
                return line.decode("utf-8", "replace")  # "" at true EOF
            # a zero wait still reports already-readable fds, so this
            # select-before-deadline order is what makes readline(0)
            # drain buffered bytes instead of returning None on them
            wait = (None if deadline is None
                    else max(0.0, deadline - time.monotonic()))
            ready, _, _ = select.select([self._fd], [], [], wait)
            if not ready:
                return None                    # true timeout: fd is idle
            data = os.read(self._fd, 1 << 16)
            if not data:
                self._eof = True
            else:
                self._buf += data
