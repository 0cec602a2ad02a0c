"""Always-on host-side span recorder — an own copy of the JAX package's
`telemetry/spans.py` recorder: a thread-safe bounded ring of
(name, category, start_ns, dur_ns, tid[, args]) tuples, cheap enough to
leave on (one `monotonic_ns()` pair and a deque append per span). When
full, the oldest span is evicted. The serving batcher records one
"dispatch" span per flush; the checkpoint manager records
`checkpoint_save_dispatch`, `checkpoint_restore` and `checkpoint_wait`
(the JAX names) under category "checkpoint", through `span` and
`record`.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Iterator, List, Optional, Tuple

SpanTuple = Tuple[str, str, int, int, int]


class SpanRecorder:
    """Thread-safe bounded ring buffer of spans."""

    def __init__(self, capacity: int = 8192):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._buf: deque = deque(maxlen=int(capacity))
        self._lock = threading.Lock()

    def record(self, name: str, category: str, start_ns: int,
               dur_ns: int, args: Optional[dict] = None) -> None:
        """Append one completed span; `args` (a small JSON-able dict) rides
        along only when given."""
        tid = threading.get_ident()
        with self._lock:
            if args is None:
                self._buf.append((name, category, int(start_ns),
                                  int(dur_ns), tid))
            else:
                self._buf.append((name, category, int(start_ns),
                                  int(dur_ns), tid, args))

    def snapshot(self) -> List[SpanTuple]:
        """Copy of the buffer contents, oldest first."""
        with self._lock:
            return list(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()


_default = SpanRecorder()


def get_recorder() -> SpanRecorder:
    return _default


def record(name: str, category: str, start_ns: int, dur_ns: int,
           args: Optional[dict] = None) -> None:
    _default.record(name, category, start_ns, dur_ns, args)


@contextlib.contextmanager
def span(name: str, category: str) -> Iterator[None]:
    """Record the enclosed block as one span of the default recorder."""
    t0 = time.monotonic_ns()
    try:
        yield
    finally:
        _default.record(name, category, t0, time.monotonic_ns() - t0)
