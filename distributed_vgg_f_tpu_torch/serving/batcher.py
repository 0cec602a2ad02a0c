"""Dynamic batcher — bounded admission, max-latency + max-batch flush,
shed-not-collapse overload behaviour.

A request admitted while a batch forms waits at most `window_ms` for
company, and a burst that fills `max_batch` flushes at once. Both flush
conditions are tested from the OLDEST queued request, so the window is a
per-request latency bound.

Overload: the admission queue is bounded (`queue_limit`). A full queue
rejects the new arrival with `OverloadShed`, which the HTTP layer turns
into a typed 503, instead of queueing without bound. Queued requests older
than `reap_after_s` are expired (their clients already got a 504) instead
of run.

Shutdown drains: `close()` stops admission (new arrivals shed with
``kind="draining"``) while the flush loop keeps flushing until the queue is
empty, so every in-flight request is answered.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from distributed_vgg_f_tpu_torch import telemetry

#: Latencies retained between housekeeping polls.
_LATENCY_RING = 8192


class OverloadShed(RuntimeError):
    """Admission refused — bounded queue full (kind="shed") or the server
    is draining (kind="draining"). Carries the typed-503 payload fields."""

    def __init__(self, kind: str, queue_depth: int, queue_limit: int):
        super().__init__(f"admission refused ({kind}): queue "
                         f"{queue_depth}/{queue_limit}")
        self.kind = kind
        self.queue_depth = int(queue_depth)
        self.queue_limit = int(queue_limit)


class _Pending:
    """One admitted request riding the queue."""

    __slots__ = ("image", "event", "probs", "error", "bucket",
                 "t_submit", "t_done")

    def __init__(self, image: np.ndarray):
        self.image = image
        self.event = threading.Event()
        self.probs: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.bucket: Optional[int] = None
        self.t_submit = time.monotonic()
        self.t_done: Optional[float] = None


class DynamicBatcher:
    """Bounded admission queue + one flush thread over a PredictEngine."""

    def __init__(self, engine, *, max_batch: int, window_ms: float,
                 queue_limit: int, reap_after_s: Optional[float] = None,
                 registry=None):
        if int(max_batch) > engine.buckets[-1]:
            raise ValueError(
                f"max_batch={max_batch} exceeds the engine's top bucket "
                f"{engine.buckets[-1]}")
        self.engine = engine
        self.max_batch = int(max_batch)
        self.queue_limit = int(queue_limit)
        # None = never reap (direct-submit callers own waiting)
        self.reap_after_s = None if reap_after_s is None \
            else float(reap_after_s)
        self.window_ms = max(1, int(round(window_ms)))
        self._reg = registry if registry is not None \
            else telemetry.get_registry()
        self._cond = threading.Condition()
        self._q: deque = deque()
        self._closed = False
        self._drained = threading.Event()
        self._shed_total = 0
        self._admitted_total = 0
        self._completed_total = 0
        self._reaped_total = 0
        self._queue_peak_life = 0
        self._latencies: deque = deque(maxlen=_LATENCY_RING)
        self._bucket_counts: Dict[int, int] = {}
        self._prev = {"shed": 0, "admitted": 0}
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"serving-batcher-{engine.model_name}")
        self._thread.start()

    # --------------------------------------------------------------- admission
    def submit(self, image: np.ndarray) -> _Pending:
        """Admit one request or shed it. Raises OverloadShed on a full
        queue / draining server; the caller owns turning that into a 503."""
        with self._cond:
            if self._closed:
                self._shed_total += 1
                self._reg.inc("serving/shed")
                raise OverloadShed("draining", len(self._q),
                                   self.queue_limit)
            if len(self._q) >= self.queue_limit:
                self._shed_total += 1
                self._reg.inc("serving/shed")
                raise OverloadShed("shed", len(self._q), self.queue_limit)
            pending = _Pending(image)
            self._q.append(pending)
            self._admitted_total += 1
            self._reg.inc("serving/admitted")
            self._queue_peak_life = max(self._queue_peak_life, len(self._q))
            self._cond.notify_all()
        return pending

    # -------------------------------------------------------------- flush loop
    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._q and not self._closed:
                    self._cond.wait()
                if not self._q and self._closed:
                    self._drained.set()
                    return
                self._reap_expired_locked()
                if not self._q:
                    continue
                if not self._closed:
                    # flush when the batch fills OR the oldest request's
                    # wait reaches the window; draining skips the wait
                    head = self._q[0].t_submit
                    while len(self._q) < self.max_batch \
                            and not self._closed:
                        remaining = head + self.window_ms / 1e3 \
                            - time.monotonic()
                        if remaining <= 0:
                            break
                        self._cond.wait(remaining)
                self._reap_expired_locked()
                group = [self._q.popleft()
                         for _ in range(min(len(self._q), self.max_batch))]
            if group:
                self._flush(group)

    def _reap_expired_locked(self) -> None:
        """Expire queue-head requests older than the reap horizon instead
        of spending engine time on them (the oldest sit at the head)."""
        if self.reap_after_s is None:
            return
        now = time.monotonic()
        while self._q and now - self._q[0].t_submit > self.reap_after_s:
            p = self._q.popleft()
            p.error = TimeoutError(
                f"expired in the admission queue after "
                f"{now - p.t_submit:.1f}s (> reap_after_s="
                f"{self.reap_after_s})")
            p.t_done = now
            self._reaped_total += 1
            p.event.set()

    def _flush(self, group: List[_Pending]) -> None:
        images = np.stack([p.image for p in group])
        t0_ns = time.monotonic_ns()
        try:
            probs, bucket = self.engine.run(images)
        except Exception as e:  # noqa: BLE001 — answer every request
            self._reg.inc("serving/errors")
            for p in group:
                p.error = e
                p.t_done = time.monotonic()
                p.event.set()
            return
        telemetry.record(f"serving_flush_{self.engine.model_name}",
                         "dispatch", t0_ns, time.monotonic_ns() - t0_ns)
        n = len(group)
        self._reg.inc("serving/batches")
        self._reg.inc("serving/batch_images", n)
        self._reg.inc("serving/padded_images", bucket - n)
        t_done = time.monotonic()
        with self._cond:
            self._bucket_counts[bucket] = \
                self._bucket_counts.get(bucket, 0) + 1
            self._completed_total += n
            for p in group:
                self._latencies.append((t_done - p.t_submit) * 1e3)
        for i, p in enumerate(group):
            p.probs = probs[i]
            p.bucket = bucket
            p.t_done = t_done
            p.event.set()

    # ------------------------------------------------------------ housekeeping
    def window_stats(self) -> dict:
        """Evidence since the previous poll: shed/admitted deltas, the
        queue depth, and the completed latencies drained from the ring."""
        with self._cond:
            shed = self._shed_total - self._prev["shed"]
            admitted = self._admitted_total - self._prev["admitted"]
            self._prev = {"shed": self._shed_total,
                          "admitted": self._admitted_total}
            lat = list(self._latencies)
            self._latencies.clear()
            depth = len(self._q)
        return {"shed": shed, "admitted": admitted, "queue_depth": depth,
                "latencies_ms": lat}

    def describe(self) -> dict:
        """Live admission state + lifetime totals."""
        with self._cond:
            return {"queue_depth": len(self._q),
                    "queue_peak": self._queue_peak_life,
                    "queue_limit": self.queue_limit,
                    "window_ms": self.window_ms,
                    "max_batch": self.max_batch,
                    "admitted_total": self._admitted_total,
                    "shed_total": self._shed_total,
                    "completed_total": self._completed_total,
                    "reaped_total": self._reaped_total,
                    "bucket_occupancy": {str(k): v for k, v in
                                         sorted(self._bucket_counts.items())},
                    "draining": self._closed}

    # ------------------------------------------------------------------ close
    def close(self, timeout: float = 30.0) -> None:
        """Stop admission, flush everything still queued, join the loop —
        every in-flight request is answered before this returns."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._drained.wait(timeout)
        self._thread.join(timeout)
