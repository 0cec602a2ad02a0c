"""Process-wide counter/gauge registry — an own copy of the JAX package's
`telemetry/registry.py` holding counters and gauges only.

- **counters** — monotonically increasing (`inc(name)`); `counter(name)`
  pre-creates one at 0 so a visible zero reads as "instrumented, nothing
  happened".
- **gauges** — last-write-wins instantaneous values (`set_gauge`).

Names follow `<subsystem>/<metric>` (e.g. `serving/requests`). Stdlib
only.
"""

from __future__ import annotations

import threading
from typing import Dict


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

