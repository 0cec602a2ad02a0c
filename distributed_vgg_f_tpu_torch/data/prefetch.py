"""Device prefetch: land each batch on the card ahead of the step — the
counterpart of the JAX package's ``data/prefetch.py``
`DevicePrefetchIterator` (:50), rebuilt for CUDA streams. The JAX
package's synchronous `maybe_prefetch` (:477) path (depth 0) has no
counterpart: the trainer's feed always runs at least one batch ahead.

A worker thread owns a ring of `buffer_size + 1` pinned host slots. For
each batch it

1. waits until the slot's previous host-to-device copy has finished (the
   CUDA event recorded after that copy);
2. fills the slot: `source.next_into(images, labels)` when the source has
   it (the native decoder writes straight into the pinned memory; ctypes
   drops the GIL for the call), else `next(source)` copied in;
3. enqueues the copies, `non_blocking`, into fresh device tensors on a side
   stream of its own, so they overlap the step running on the compute
   stream;
4. records an event on the side stream and queues (device batch, event),
   at most `buffer_size` batches ahead.

`__next__` makes the consumer's current stream wait on the batch's event
and calls `record_stream` on each of its tensors, so the caching allocator
does not hand the memory back to the side stream until the step that
reads it has run.

On the CPU (only when `device="cpu"` is asked for) the same thread and
queue run with no streams: each batch is decoded into fresh tensors the
consumer owns. Without a card and without that request the constructor
raises (device.py).

The consumer side is also the data watchdog: with `batch_timeout_s` > 0,
`__next__` waits that long, then retries with the wait doubling,
`timeout_retries` times, then raises DataStallError. A worker thread
that dies without delivering a batch or an error is detected regardless
and raises DataStallError too. Exceptions of the source, StopIteration
included, reach the consumer at the matching `next()`.

Counters and gauges (`prefetch/`): `batches`, `wait_ns` (the consumer's
wait), `timeouts`, `dead_workers`, `source_batches`, `device_put_bytes`;
`queue_depth`, `bytes_in_flight`. Spans: "source_next" and "device_put"
(category "infeed_source", the worker), "prefetch_wait" ("infeed", the
consumer).
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Dict, Optional

import torch

from distributed_vgg_f_tpu_torch.device import resolve_device
from distributed_vgg_f_tpu_torch.resilience.errors import DataStallError
from distributed_vgg_f_tpu_torch.telemetry import get_registry, record


class _WaitTimeout(Exception):
    """One bounded wait elapsed (not yet the retries-exhausted stall)."""


class _Slot:
    """One pinned host buffer per batch key (`spec`: key -> (shape,
    dtype)), and the event recorded after the last copy out of it (None
    before the first)."""

    def __init__(self, spec):
        self.tensors = {k: torch.empty(shape, dtype=dtype, pin_memory=True)
                        for k, (shape, dtype) in spec.items()}
        self.copied: Optional[torch.cuda.Event] = None

    def wait_free(self) -> None:
        if self.copied is not None:
            self.copied.synchronize()


class DevicePrefetchIterator:
    """Wraps a host-batch source; yields batches of tensors on `device`,
    up to `buffer_size` ahead of the consumer. `close()` stops the worker
    and drops the buffered batches and the pinned slots; it does not close
    the source."""

    _POLL_S = 0.1      # liveness-check granularity while blocked
    _JOIN_S = 10.0     # how long close() waits for the worker

    def __init__(self, source, device="cuda", buffer_size: int = 2,
                 batch_timeout_s: float = 0.0, timeout_retries: int = 2):
        if buffer_size < 1:
            raise ValueError(f"buffer_size must be >= 1, got {buffer_size}")
        if batch_timeout_s < 0 or timeout_retries < 0:
            raise ValueError(
                f"batch_timeout_s/timeout_retries must be >= 0, got "
                f"{batch_timeout_s}/{timeout_retries}")
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self._source = source
        self._batch_timeout = batch_timeout_s
        self._timeout_retries = timeout_retries
        self._batches_delivered = 0
        self._queue: queue.Queue = queue.Queue(maxsize=buffer_size)
        self._closed = threading.Event()
        #: the worker's pinned ring (CUDA only), filled on first use
        self._slots: list = []
        self._num_slots = buffer_size + 1
        self._stream = (torch.cuda.Stream(device=self.device) if self._cuda
                        else None)
        reg = get_registry()
        for name in ("batches", "wait_ns", "timeouts", "dead_workers",
                     "source_batches", "device_put_bytes"):
            reg.counter(f"prefetch/{name}")
        reg.set_gauge("prefetch/queue_depth", 0)
        reg.set_gauge("prefetch/bytes_in_flight", 0)
        self._bytes_lock = threading.Lock()
        self._bytes_in_flight = 0
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="device-prefetch")
        self._thread.start()

    # ------------------------------------------------------------ worker
    @property
    def stream(self) -> Optional[torch.cuda.Stream]:
        """The side stream the copies run on (None on the CPU)."""
        return self._stream

    def _slot(self, n: int, spec) -> _Slot:
        if len(self._slots) < self._num_slots:
            self._slots.append(_Slot(spec))
        slot = self._slots[n % self._num_slots]
        slot.wait_free()
        return slot

    def _host_batch(self, n: int) -> Dict[str, torch.Tensor]:
        """Batch n in host tensors: slot n's pinned buffers on the card,
        fresh tensors on the CPU."""
        source = self._source
        next_into = getattr(source, "next_into", None)
        if next_into is not None:
            shape = tuple(source.image_shape)
            spec = {"image": (shape, getattr(torch, source.image_dtype)),
                    "label": (shape[:1], torch.int32)}
            if self._cuda:
                out = self._slot(n, spec).tensors
            else:
                out = {k: torch.empty(sh, dtype=dt)
                       for k, (sh, dt) in spec.items()}
            next_into(out["image"], out["label"])
            return out
        batch = {k: torch.as_tensor(v) for k, v in next(self._iter).items()}
        if not self._cuda:
            return batch
        out = self._slot(n, {k: (t.shape, t.dtype)
                             for k, t in batch.items()}).tensors
        for k, t in batch.items():
            out[k].copy_(t)
        return out

    def _worker(self) -> None:
        reg = get_registry()
        ctx = (torch.cuda.device(self.device) if self._cuda
               else contextlib.nullcontext())
        try:
            with ctx:
                if getattr(self._source, "next_into", None) is None:
                    self._iter = iter(self._source)
                n = 0
                while not self._closed.is_set():
                    t0 = time.monotonic_ns()
                    try:
                        host = self._host_batch(n)
                    except StopIteration:
                        break
                    record("source_next", "infeed_source", t0,
                           time.monotonic_ns() - t0)
                    reg.inc("prefetch/source_batches")
                    if self._closed.is_set():
                        return
                    nbytes = sum(t.nbytes for t in host.values())
                    t0 = time.monotonic_ns()
                    event = None
                    if self._cuda:
                        with torch.cuda.stream(self._stream):
                            batch = {k: t.to(self.device, non_blocking=True)
                                     for k, t in host.items()}
                            event = torch.cuda.Event()
                            event.record(self._stream)
                        self._slots[n % self._num_slots].copied = event
                    else:
                        batch = host
                    record("device_put", "infeed_source", t0,
                           time.monotonic_ns() - t0)
                    reg.inc("prefetch/device_put_bytes", nbytes)
                    # counted before the put: the consumer may take it (and
                    # subtract) the moment it lands
                    self._add_in_flight(nbytes)
                    if not self._put(("batch", batch, event, nbytes)):
                        self._add_in_flight(-nbytes)
                        return
                    reg.set_gauge("prefetch/queue_depth",
                                  self._queue.qsize())
                    n += 1
            self._put(("stop", StopIteration()))
        except BaseException as exc:  # noqa: BLE001 — relayed to consumer
            self._put(("error", exc))

    def _add_in_flight(self, nbytes: int) -> None:
        with self._bytes_lock:
            # clamped: close() may have zeroed the count meanwhile
            self._bytes_in_flight = max(0, self._bytes_in_flight + nbytes)
            get_registry().set_gauge("prefetch/bytes_in_flight",
                                     self._bytes_in_flight)

    def _put(self, item) -> bool:
        """Put with periodic close checks; False if closed first."""
        while not self._closed.is_set():
            try:
                self._queue.put(item, timeout=self._POLL_S)
                return True
            except queue.Full:
                continue
        return False

    # ---------------------------------------------------------- consumer
    def __iter__(self) -> "DevicePrefetchIterator":
        return self

    def _stall(self, message: str) -> DataStallError:
        get_registry().inc("resilience/data_stall_errors")
        return DataStallError(message)

    def _get(self, timeout: Optional[float]):
        """One bounded wait in liveness-checking slices: DataStallError the
        moment the worker is dead with nothing queued, _WaitTimeout when
        `timeout` elapses."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            try:
                return self._queue.get(timeout=self._POLL_S)
            except queue.Empty:
                if not self._thread.is_alive() and self._queue.empty():
                    get_registry().inc("prefetch/dead_workers")
                    raise self._stall(
                        f"device-prefetch worker thread died without "
                        f"delivering a batch or an error (after "
                        f"{self._batches_delivered} batches): the host "
                        f"loader is gone") from None
                if deadline is not None and time.monotonic() >= deadline:
                    raise _WaitTimeout from None

    def __next__(self):
        if self._closed.is_set():
            raise StopIteration
        t_wait = time.monotonic_ns()
        if self._batch_timeout <= 0:
            item = self._get(None)
        else:
            timeout, waited = self._batch_timeout, 0.0
            for _ in range(self._timeout_retries + 1):
                try:
                    item = self._get(timeout)
                    break
                except _WaitTimeout:
                    get_registry().inc("prefetch/timeouts")
                    waited += timeout
                    timeout *= 2
            else:
                raise self._stall(
                    f"input pipeline stalled: no batch within {waited:.1f}s "
                    f"across {self._timeout_retries + 1} watchdog attempts "
                    f"(train.data_timeout_s={self._batch_timeout}, "
                    f"doubling; {self._batches_delivered} batches delivered "
                    f"before the stall): the host loader is hung or too "
                    f"slow — check the decode threads and storage, or raise "
                    f"train.data_timeout_s")
        kind = item[0]
        if kind != "batch":
            self.close()
            if kind == "stop":
                raise StopIteration
            raise item[1]
        _, batch, event, nbytes = item
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for t in batch.values():
                t.record_stream(consumer)
        self._batches_delivered += 1
        dt = time.monotonic_ns() - t_wait
        record("prefetch_wait", "infeed", t_wait, dt)
        reg = get_registry()
        reg.inc("prefetch/batches")
        reg.inc("prefetch/wait_ns", dt)
        reg.set_gauge("prefetch/queue_depth", self._queue.qsize())
        self._add_in_flight(-nbytes)
        return batch

    @property
    def worker_alive(self) -> bool:
        return self._thread.is_alive()

    def _drain(self) -> None:
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                return

    def close(self) -> None:
        """Stop the worker (joined, unless it is wedged inside the source
        for longer than `_JOIN_S`), drop buffered batches and release the
        pinned slots once their copies have finished."""
        self._closed.set()
        self._drain()  # a worker blocked in put() sees the flag
        if self._thread.is_alive() \
                and threading.current_thread() is not self._thread:
            self._thread.join(timeout=self._JOIN_S)
        self._drain()
        with self._bytes_lock:
            self._bytes_in_flight = 0
            get_registry().set_gauge("prefetch/bytes_in_flight", 0)
        get_registry().set_gauge("prefetch/queue_depth", 0)
        if self._thread.is_alive():
            # wedged in the source: its slot may still be written to
            get_registry().inc("prefetch/dead_workers")
            return
        for slot in self._slots:
            slot.wait_free()
        self._slots = []

    def __del__(self):  # pragma: no cover — best-effort cleanup
        try:
            self.close()
        except Exception:
            pass

