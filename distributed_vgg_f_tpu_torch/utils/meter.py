"""Throughput meter with an injectable clock — an own copy of the JAX
package's ``utils/meter.py``. Alongside the cumulative rate it keeps a
rolling rate over the last `window` updates, which shows the transient
stalls a cumulative average hides."""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Optional


class ThroughputMeter:
    def __init__(self, num_chips: int,
                 clock: Callable[[], float] = time.monotonic,
                 window: int = 20):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.num_chips = max(1, num_chips)
        self.window = int(window)
        self._clock = clock
        self.reset()

    def reset(self) -> None:
        self._start = self._clock()
        self._examples = 0
        self._steps = 0
        # (time, cumulative examples) after each update, seeded with the
        # start: `window` updates back needs window+1 anchor points
        self._history: deque = deque(maxlen=self.window + 1)
        self._history.append((self._start, 0))

    def update(self, num_examples: int) -> None:
        self._examples += num_examples
        self._steps += 1
        self._history.append((self._clock(), self._examples))

    @property
    def elapsed(self) -> float:
        return max(self._clock() - self._start, 1e-9)

    @property
    def images_per_sec(self) -> float:
        return self._examples / self.elapsed

    @property
    def images_per_sec_per_chip(self) -> float:
        return self.images_per_sec / self.num_chips

    @property
    def steps_per_sec(self) -> float:
        return self._steps / self.elapsed

    @property
    def window_images_per_sec(self) -> Optional[float]:
        """Rate over (at most) the last `window` updates; None before the
        first update."""
        if len(self._history) < 2:
            return None
        t0, n0 = self._history[0]
        t1, n1 = self._history[-1]
        return (n1 - n0) / max(t1 - t0, 1e-9)

    def snapshot(self) -> dict:
        out = {
            "images_per_sec": self.images_per_sec,
            "images_per_sec_per_chip": self.images_per_sec_per_chip,
            "steps_per_sec": self.steps_per_sec,
        }
        window_rate = self.window_images_per_sec
        if window_rate is not None:
            out["window_images_per_sec"] = window_rate
        return out
