"""Read-ahead stages between the host source and the step — the
counterparts of the JAX package's ``data/prefetch.py``
`DevicePrefetchIterator` (:50, with `set_buffer_size` :274) and
`HostPrefetchIterator` (:309), rebuilt for CUDA streams. The JAX
package's synchronous `maybe_prefetch` (:477) path (depth 0) has no
counterpart: the trainer's feed always runs at least one batch ahead.

**Device stage.** A worker thread keeps pinned host slots (up to
`buffer_size + 1`). For each batch it

1. takes a slot: a new one while the ring is below its size, else the
   slot released longest ago, after the CUDA event recorded behind its
   last host-to-device copy (a free list, so a resize never reuses a slot
   whose copy is still queued);
2. fills it: `source.next_into(images, labels)` when the source has it
   (the native decoder writes straight into the pinned memory; ctypes
   drops the GIL for the call), else `next(source)` copied in;
3. enqueues the copies, `non_blocking`, into fresh device tensors on a side
   stream of its own, so they overlap the step running on the compute
   stream;
4. records an event on the side stream, releases the slot with it, and
   queues (device batch, event), at most `buffer_size` batches ahead.

A source that lends its own pinned buffers (`lends_buffers`: the host
stage below) skips steps 1–2: the device stage copies from the lent
buffers and hands each back with its copy's event.

`__next__` makes the consumer's current stream wait on the batch's event
and calls `record_stream` on each of its tensors, so the caching allocator
does not hand the memory back to the side stream until the step that
reads it has run. `set_buffer_size(n)` moves the queue bound at once:
growing lets the worker run further ahead (and adds slots as it needs
them), shrinking only stops new puts until the consumer has drained
below the new bound; no queued batch is dropped.

**Host stage** (`HostPrefetchIterator`, built by the trainer only while
the ingest autotuner is active): a worker thread reads `depth` batches
ahead of the device stage, `set_depth(n)` resizable. Over a source with
`next_into` it owns the batch buffers (pinned on the card): the source
decodes into them and the device stage copies out of them, with no host
copy between; a buffer returns to the stage's pool with the device
copy's event and is filled again only after that event. Over any other
source it queues the source's own batches (`next(source)`), so a source
that recycles its output arrays (`reuses_output_buffers`) is refused.

On the CPU (only when `device="cpu"` is asked for) the same threads and
queues run with no streams and no pinned memory: each batch is decoded
into fresh tensors the consumer owns. Without a card and without that
request the device stage's constructor raises (device.py). On the card a
pinned allocation that fails raises; nothing falls back to pageable
memory.

The consumer side is also the data watchdog: with `batch_timeout_s` > 0,
`__next__` waits that long, then retries with the wait doubling,
`timeout_retries` times, then raises DataStallError. A worker thread
that dies without delivering a batch or an error is detected regardless
and raises DataStallError too. Exceptions of the source, StopIteration
included, reach the consumer at the matching `next()`.

Counters and gauges (`prefetch/`): `batches`, `wait_ns` (the consumer's
wait), `timeouts`, `dead_workers`, `source_batches`, `device_put_bytes`,
`host_batches`; `queue_depth`, `bytes_in_flight`, `host_queue_depth`,
`pinned_bytes` (the pinned host memory both stages hold). Spans:
"source_next" and "device_put" (category "infeed_source", the device
worker), "host_prefetch_next" ("infeed_source", the host worker),
"prefetch_wait" ("infeed", the consumer).
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional, Tuple

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
        _add_pinned(self.nbytes)

    @property
    def nbytes(self) -> int:
        return sum(t.nbytes for t in self.tensors.values())

    def wait_free(self) -> None:
        if self.copied is not None:
            self.copied.synchronize()


_pinned_lock = threading.Lock()
_pinned_bytes = 0


def _add_pinned(nbytes: int) -> None:
    """The `prefetch/pinned_bytes` gauge: the pinned host memory the
    stages' slots hold now."""
    global _pinned_bytes
    with _pinned_lock:
        _pinned_bytes += nbytes
        get_registry().set_gauge("prefetch/pinned_bytes", _pinned_bytes)


def _keep(event) -> None:
    """The release of a batch nothing reuses (fresh CPU tensors)."""


def _release_slots(slots) -> None:
    """Wait for each pinned slot's last copy, then drop it from the
    pinned-bytes gauge (the caller drops its references)."""
    for slot in slots:
        slot.wait_free()
        _add_pinned(-slot.nbytes)


def _resize(q: queue.Queue, n: int) -> int:
    """Set a queue's bound (at least 1) and wake a producer blocked on the
    old one; returns the bound now in force. A shrink drops nothing."""
    n = max(1, int(n))
    with q.mutex:
        q.maxsize = n
        q.not_full.notify_all()
    return n


def _source_spec(source):
    """The (shape, dtype) of each key of a `next_into` source's batch."""
    shape = tuple(source.image_shape)
    return {"image": (shape, getattr(torch, source.image_dtype)),
            "label": (shape[:1], torch.int32)}


class DevicePrefetchIterator:
    """Wraps a host-batch source; yields batches of tensors on `device`,
    up to `buffer_size` ahead of the consumer (`set_buffer_size` moves the
    bound mid-stream). `close()` stops the worker and drops the buffered
    batches and the pinned slots; it does not close the source."""

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
        #: the worker's pinned slots (CUDA only), made as the ring needs
        #: them, and those released with their copy's event, oldest first
        self._slots: list = []
        self._free: deque = deque()
        self._stream = (torch.cuda.Stream(device=self.device) if self._cuda
                        else None)
        reg = get_registry()
        for name in ("batches", "wait_ns", "timeouts", "dead_workers",
                     "source_batches", "device_put_bytes"):
            reg.counter(f"prefetch/{name}")
        _add_pinned(0)
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

    @property
    def buffer_size(self) -> int:
        """The queue bound: device batches kept ahead of the consumer."""
        return self._queue.maxsize

    def set_buffer_size(self, n: int) -> int:
        """Resize the ring mid-stream (the autotuner's
        `prefetch_to_device` knob; JAX `prefetch.py:277`). Growing wakes a
        worker blocked on the old bound; shrinking drops nothing, the queue
        just refuses puts until the consumer has drained below it. The
        pinned slots follow the bound up, never down. Returns the bound
        now in force."""
        return _resize(self._queue, n)

    def _take_slot(self, spec) -> _Slot:
        """A new slot while there are fewer than `buffer_size + 1`, else
        the one released longest ago, once its copy has finished."""
        if len(self._slots) < self._queue.maxsize + 1 or not self._free:
            slot = _Slot(spec)
            self._slots.append(slot)
            return slot
        slot = self._free.popleft()
        slot.wait_free()
        return slot

    def _host_batch(self) -> Tuple[Dict[str, torch.Tensor],
                                   Callable[[object], None]]:
        """The next batch in host tensors and the callable that releases
        them with their copy's event: a pinned slot (or a buffer the
        source lends) on the card, fresh tensors on the CPU."""
        source = self._source
        if getattr(source, "lends_buffers", False):
            return source.next_lent()
        next_into = getattr(source, "next_into", None)
        if next_into is not None:
            spec = _source_spec(source)
            if self._cuda:
                slot = self._take_slot(spec)
                out = slot.tensors
            else:
                out = {k: torch.empty(sh, dtype=dt)
                       for k, (sh, dt) in spec.items()}
            next_into(out["image"], out["label"])
        else:
            batch = {k: torch.as_tensor(v)
                     for k, v in next(self._iter).items()}
            if not self._cuda:
                return batch, _keep
            slot = self._take_slot({k: (t.shape, t.dtype)
                                    for k, t in batch.items()})
            out = slot.tensors
            for k, t in batch.items():
                out[k].copy_(t)
        if not self._cuda:
            return out, _keep
        return out, lambda event: self._release(slot, event)

    def _release(self, slot: _Slot, event) -> None:
        slot.copied = event
        self._free.append(slot)

    def _worker(self) -> None:
        reg = get_registry()
        ctx = (torch.cuda.device(self.device) if self._cuda
               else contextlib.nullcontext())
        try:
            with ctx:
                if not (getattr(self._source, "lends_buffers", False)
                        or getattr(self._source, "next_into", None)):
                    self._iter = iter(self._source)
                while not self._closed.is_set():
                    t0 = time.monotonic_ns()
                    try:
                        host, release = self._host_batch()
                    except StopIteration:
                        break
                    record("source_next", "infeed_source", t0,
                           time.monotonic_ns() - t0)
                    reg.inc("prefetch/source_batches")
                    if self._closed.is_set():
                        release(None)
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
                    else:
                        batch = host
                    release(event)
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
        slots, self._slots = self._slots, []
        self._free.clear()
        _release_slots(slots)

    def __del__(self):  # pragma: no cover — best-effort cleanup
        try:
            self.close()
        except Exception:
            pass


class HostPrefetchIterator:
    """A host read-ahead stage between the source and the device stage:
    a worker thread keeps up to `depth` batches ready (`set_depth` moves
    the bound mid-stream). Over a `next_into` source feeding a card
    (`device` a CUDA device) the stage owns pinned buffers, lends them to
    the device stage (`lends_buffers`, `next_lent`) and fills one again
    only after the device copy's event came back with it; for the CPU
    (`device` None or "cpu") each batch is decoded into fresh tensors the
    consumer owns. Over another source it queues the source's own
    batches. `close()` stops the worker
    and drops the queued batches; it does not close the source."""

    _POLL_S = 0.1
    _JOIN_S = 10.0

    def __init__(self, source, depth: int = 2, device=None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if getattr(source, "reuses_output_buffers", False):
            raise ValueError(
                "host prefetch requires caller-owned batches, but this "
                "iterator recycles its output buffers")
        self._source = source
        self._device = (torch.device("cpu") if device is None
                        else resolve_device(device))
        self._into = getattr(source, "next_into", None) is not None
        #: the batches are this stage's pinned buffers, handed back with
        #: the event of the copy out of them (`next_lent`)
        self.lends_buffers = self._into and self._device.type == "cuda"
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._closed = threading.Event()
        self._pool = threading.Condition()
        self._slots: list = []           # every pinned buffer set made
        self._free: deque = deque()      # released, oldest first
        reg = get_registry()
        reg.counter("prefetch/host_batches")
        reg.set_gauge("prefetch/host_queue_depth", 0)
        _add_pinned(0)
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="host-prefetch")
        self._thread.start()

    @property
    def depth(self) -> int:
        return self._queue.maxsize

    def set_depth(self, n: int) -> int:
        """Resize the read-ahead mid-stream (the autotuner's
        `host_prefetch` knob; JAX `prefetch.py:357`), as
        DevicePrefetchIterator.set_buffer_size: growing wakes the worker,
        shrinking drops nothing. Returns the bound now in force."""
        n = _resize(self._queue, n)
        with self._pool:
            self._pool.notify_all()
        return n

    def decode_errors(self) -> int:
        fn = getattr(self._source, "decode_errors", None)
        return fn() if callable(fn) else 0

    # ------------------------------------------------------------ worker
    def _take(self, spec) -> Optional[_Slot]:
        """A pinned buffer set: the one released longest ago (after its
        copy's event), else a new one while fewer than `depth + 2` exist
        (`depth` queued, one filling, one with the device stage), else
        wait for a release. None once closed."""
        with self._pool:
            while not self._closed.is_set():
                if self._free:
                    slot = self._free.popleft()
                    break
                if len(self._slots) < self._queue.maxsize + 2:
                    slot = _Slot(spec)
                    self._slots.append(slot)
                    return slot
                self._pool.wait(self._POLL_S)
            else:
                return None
        slot.wait_free()
        return slot

    def _release(self, slot: _Slot, event) -> None:
        with self._pool:
            slot.copied = event
            self._free.append(slot)
            self._pool.notify_all()

    def _worker(self) -> None:
        ctx = (torch.cuda.device(self._device) if self.lends_buffers
               else contextlib.nullcontext())
        with ctx:
            self._work()

    def _work(self) -> None:
        reg = get_registry()
        try:
            if self._into:
                spec = _source_spec(self._source)
            else:
                it = iter(self._source)
            while not self._closed.is_set():
                t0 = time.monotonic_ns()
                if self.lends_buffers:
                    slot = self._take(spec)
                    if slot is None:
                        return
                    batch = slot.tensors
                elif self._into:
                    slot = None
                    batch = {k: torch.empty(sh, dtype=dt)
                             for k, (sh, dt) in spec.items()}
                try:
                    if self._into:
                        try:
                            self._source.next_into(batch["image"],
                                                   batch["label"])
                        except BaseException:
                            if slot is not None:
                                self._release(slot, None)
                            raise
                    else:
                        batch, slot = next(it), None
                except StopIteration:
                    break
                record("host_prefetch_next", "infeed_source", t0,
                       time.monotonic_ns() - t0)
                reg.inc("prefetch/host_batches")
                if not self._put(("batch", batch, slot)):
                    return
                reg.set_gauge("prefetch/host_queue_depth",
                              self._queue.qsize())
            self._put(("stop", StopIteration(), None))
        except BaseException as exc:  # noqa: BLE001 — relayed to consumer
            self._put(("error", exc, None))

    def _put(self, item) -> bool:
        while not self._closed.is_set():
            try:
                self._queue.put(item, timeout=self._POLL_S)
                return True
            except queue.Full:
                continue
        return False

    # ---------------------------------------------------------- consumer
    def __iter__(self) -> "HostPrefetchIterator":
        return self

    def _get(self):
        if self._closed.is_set():
            raise StopIteration
        while True:
            try:
                item = self._queue.get(timeout=self._POLL_S)
                break
            except queue.Empty:
                if self._closed.is_set():
                    raise StopIteration from None
                if not self._thread.is_alive() and self._queue.empty():
                    reg = get_registry()
                    reg.inc("prefetch/dead_workers")
                    reg.inc("resilience/data_stall_errors")
                    raise DataStallError(
                        "host-prefetch worker thread died without "
                        "delivering a batch or an error") from None
        kind, payload, slot = item
        if kind == "batch":
            get_registry().set_gauge("prefetch/host_queue_depth",
                                     self._queue.qsize())
            return payload, slot
        self.close()
        if kind == "stop":
            raise StopIteration
        raise payload

    def __next__(self):
        """The next batch, the consumer's to keep. A stage that lends its
        buffers is read through `next_lent` only."""
        if self.lends_buffers:
            raise TypeError("this host stage lends its pinned buffers: "
                            "read it through next_lent()")
        batch, _ = self._get()
        return batch

    def next_lent(self) -> Tuple[Dict[str, torch.Tensor],
                                 Callable[[object], None]]:
        """(batch, give_back): the stage's own buffers, which the caller
        copies out of and hands back with `give_back(event)`, the CUDA
        event recorded after its copies (None when nothing was copied)."""
        batch, slot = self._get()
        if slot is None:
            return batch, _keep
        return batch, lambda event: self._release(slot, event)

    def _drain(self) -> None:
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                return

    def close(self) -> None:
        """Stop the worker (joined, unless it is wedged inside the source
        for longer than `_JOIN_S`), drop the queued batches and release the
        pinned buffers once their copies have finished."""
        self._closed.set()
        self._drain()
        with self._pool:
            self._pool.notify_all()
        if self._thread.is_alive() \
                and threading.current_thread() is not self._thread:
            self._thread.join(timeout=self._JOIN_S)
        self._drain()
        get_registry().set_gauge("prefetch/host_queue_depth", 0)
        if self._thread.is_alive():
            return   # wedged in the source: a buffer may be written to
        with self._pool:
            slots, self._slots = self._slots, []
            self._free.clear()
        _release_slots(slots)

    def __del__(self):  # pragma: no cover — best-effort cleanup
        try:
            self.close()
        except Exception:
            pass
