"""Gateway I/O primitives: deadline line reader + threaded NDJSON emitter
(own copies of ``repro.gateway.io``).

:class:`LineSource` is the select-based reader the serve loops use for
coalescing-window timeouts.  It always runs at least one zero-wait
``select``/drain pass first, so a complete line already sitting in the
OS pipe buffer is returned even at an expired deadline, and a client
trickling bytes still cannot hold the caller past its total deadline.

:class:`Emitter` owns the response stream on its own thread: responses
queue and the thread writes them, so a slow or stalled client blocks
only the emitter, while intake keeps parsing and the dispatcher keeps
draining tenants.  Write failures (the ``serve.write`` fault site
included) are classified and counted in ``STATS.emit_failures``, never
raised into the serving threads.
"""
from __future__ import annotations

import json
import os
import queue
import select
import sys
import threading
from typing import IO

from .. import obs
from ..resilience import STATS as RSTATS
from ..resilience import classify, fire


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
        deadline = None if timeout is None else obs.monotonic() + timeout
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
                    else max(0.0, deadline - obs.monotonic()))
            ready, _, _ = select.select([self._fd], [], [], wait)
            if not ready:
                return None                    # true timeout: fd is idle
            data = os.read(self._fd, 1 << 16)
            if not data:
                self._eof = True
            else:
                self._buf += data


class Emitter:
    """Threaded NDJSON writer: ``emit(obj)`` never blocks on the client.

    One daemon thread drains a FIFO queue to ``out`` (one JSON object
    per line, flushed).  Per-caller enqueue order is preserved: the
    dispatcher emits a tenant's responses in execution order, so each
    tenant's stream stays FIFO even though tenants interleave.

    ``close()`` flushes the queue and joins the thread; emit failures
    are counted + classified, and the emitter keeps draining so one torn
    write never wedges the queue.
    """

    def __init__(self, out: IO):
        self._out = out
        self._q: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._run,
                                        name="gateway-emit", daemon=True)
        self._thread.start()

    def emit(self, obj: dict) -> None:
        # the caller's ambient trace rides along so the writer thread's
        # emit span chains to the request that produced the response
        self._q.put((obj, obs.current_trace()))

    def close(self) -> None:
        """Drain everything queued, then stop the writer thread."""
        self._q.put(None)
        self._thread.join()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            obj, tid = item
            try:
                with obs.span("gateway.emit", stage="emit", trace=tid):
                    fire("serve.write")
                    self._out.write(json.dumps(obj) + "\n")
                    self._out.flush()
            except Exception as e:
                # a client that hung up must not kill the server; the
                # loss is counted and classified for health
                RSTATS.emit_failures += 1
                sys.stderr.write(f"gateway: response write failed "
                                 f"({classify(e)}): {e}\n")
