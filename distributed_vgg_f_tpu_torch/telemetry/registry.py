"""Process-wide counter/gauge registry — an own copy of the JAX package's
`telemetry/registry.py` holding counters and gauges only.

- **counters** — monotonically increasing (`inc(name)`); `counter(name)`
  pre-creates one at 0 so a visible zero reads as "instrumented, nothing
  happened".
- **gauges** — last-write-wins instantaneous values (`set_gauge`).

Names follow `<subsystem>/<metric>` (e.g. `serving/requests`). The
checkpoint layer's and the snapshot cache's counters keep the JAX
package's names (`CHECKPOINT_COUNTERS`, checkpoint/manager.py;
`SNAPSHOT_COUNTERS`, data/snapshot_cache.py). Stdlib only.
"""

from __future__ import annotations

import threading
from typing import Dict

#: The checkpoint manager's counters (JAX `checkpoint/manager.py:155–161,
#: 210–212, 296, 343–345, 406–407`): durable saves dispatched, I/O
#: retries and failures, newest-intact fallbacks, restores and their ns,
#: and the ns spent in `wait()`. `ingest_state/saves` (the iterator blobs
#: that rode a save) is data/iterator_state.py's.
CHECKPOINT_COUNTERS = ("checkpoint/saves", "checkpoint/save_retries",
                       "checkpoint/save_failures",
                       "checkpoint/integrity_fallbacks",
                       "checkpoint/restores", "checkpoint/restore_ns",
                       "checkpoint/wait_ns")

#: The snapshot cache's counters (JAX `data/snapshot_cache.py:671–674`):
#: warm items served from the store, items that missed it (repaired or
#: filled), and the payload bytes served (data/snapshot_cache.py).
SNAPSHOT_COUNTERS = ("prefetch/snapshot_hits", "prefetch/snapshot_misses",
                     "prefetch/snapshot_bytes")


class TelemetryRegistry:
    """Thread-safe named counters + gauges."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}

    def counter(self, name: str) -> None:
        """Pre-create a counter at 0: a visible zero."""
        with self._lock:
            self._counters.setdefault(name, 0)

    def inc(self, name: str, value: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def gauge(self, name: str, default=None):
        with self._lock:
            return self._gauges.get(name, default)

    def counter_value(self, name: str, default=None):
        with self._lock:
            return self._counters.get(name, default)

    def reset(self) -> None:
        """Drop every counter and gauge (tests)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()


_default = TelemetryRegistry()


def get_registry() -> TelemetryRegistry:
    return _default


def inc(name: str, value: float = 1) -> None:
    """Add `value` to counter `name` of the default registry."""
    _default.inc(name, value)
