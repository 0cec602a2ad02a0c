"""Position-exact resumable ingest — the counterpart of the JAX package's
``data/iterator_state.py`` (`epoch_of` :106, `ResumableIngest` :136,
`restore_from_blob` :419).

The native train stream is a pure function of (seed, position), so the
whole iterator state is a small JSON blob:

    {"kind": "ingest_iterator_state", "version": 1,
     "cursor": <next batch the trainer will consume>,
     "epoch": cursor // batches_per_epoch,
     "shuffle": {"algo": "splitmix64", "seed": S, "epoch": E},
     "source_cursor": <next batch the source will decode>,
     "in_flight": [cursor .. source_cursor),   # the read-ahead set
     ...and the stream's identity (seed, batches_per_epoch, wire, ingest)}

A cursor is always the next item to emit: the batch at cursor k*N opens
epoch k (`epoch_of`).

`ResumableIngest` wraps what `build_dataset` returns and counts the source
cursor over `__next__` and `next_into` draws alike; the prefetch stages
above it (data/prefetch.py) hold `source_cursor - cursor` batches already
drawn. `capture_state` writes the blob each checkpoint carries and
`restore_from_blob` validates one (telemetry/schema.py), checks its
identity and seeks a fresh ingest to its cursor, so a refill draws exactly
the in-flight batches again. `num_threads`/`set_num_threads` forward the
decode pool's size (the autotuner's thread knob). The live rebuild and
the wire knob wait for ROADMAP A17, which ports the host wires.

Two locks: a draw holds the draw lock for as long as the source decodes
(up to a whole batch's decode on a decode-bound host), while the cursor
lock is held only to read or bump the count. The trainer thread's
receipts (`capture_state`, `window_receipt`, `cursor`) take the cursor
lock alone, so a train record or a save never waits for a decode in
flight; a seek and `close` take both, so neither lands inside a draw.

Counters (`ingest_state/`): `saves`, `restores`, `transplanted_items`,
`rebuilds`.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, List, Optional

from distributed_vgg_f_tpu_torch.telemetry import get_registry, schema

log = logging.getLogger(__name__)

#: Blob format version; an unknown version restores like no blob at all.
ITERATOR_STATE_VERSION = 1

#: `kind` tag of the blob.
BLOB_KIND = "ingest_iterator_state"

#: Identity fields a restore checks against the live run before trusting
#: a blob's cursor.
IDENTITY_FIELDS = ("seed", "batches_per_epoch", "ingest")

#: The blob's `ingest` label: the stream is decoded locally (the JAX
#: package's service client, which labels its own, is not ported).
INGEST_LABEL = "local"


def epoch_of(cursor: int, batches_per_epoch: int) -> int:
    """The cursor -> epoch map: the batch AT cursor k*N is the first batch
    of epoch k (a cursor is never "last emitted")."""
    return int(cursor) // max(1, int(batches_per_epoch))


def _register_counters() -> None:
    reg = get_registry()
    for name in ("saves", "restores", "transplanted_items", "rebuilds"):
        reg.counter(f"ingest_state/{name}")


def _wire_of(inner) -> str:
    """The wire the source ships, as a blob receipt."""
    dtype = getattr(inner, "image_dtype", None)
    if dtype == "uint8":
        return "u8"
    if dtype == "bfloat16":
        return "host_bf16"
    return "host_f32"


class ResumableIngest:
    """Cursor-counting surface over the trainer's host-batch source,
    between `build_dataset` and the prefetch stages. The cursor moves
    once a draw has returned, so a receipt taken during a draw counts it
    as not yet drawn."""

    supports_state = True

    def __init__(self, factory: Callable[[object], object], data_cfg, *,
                 seed: int, batches_per_epoch: int):
        self._seed = int(seed)
        self._batches_per_epoch = max(1, int(batches_per_epoch))
        self._draw_lock = threading.Lock()   # held across a draw
        self._lock = threading.Lock()        # the cursor, briefly
        self._cursor = 0   # next SOURCE draw
        self._started = False
        self._closed = False
        self._decode_errors_closed = 0
        _register_counters()
        self._inner = factory(data_cfg)
        self._wire = _wire_of(self._inner)

    # ------------------------------------------------------------ iterator
    def __iter__(self) -> "ResumableIngest":
        return self

    def __next__(self):
        with self._draw_lock:
            if self._closed:
                raise StopIteration
            self._started = True
            batch = next(self._inner)
            with self._lock:
                self._cursor += 1
            return batch

    @property
    def next_into(self):
        """The source's `next_into(images, labels)`, counted like a draw
        of `__next__`; AttributeError when the source has none."""
        inner_next_into = self._inner.next_into

        def next_into(images, labels) -> None:
            with self._draw_lock:
                if self._closed:
                    raise StopIteration
                self._started = True
                inner_next_into(images, labels)
                with self._lock:
                    self._cursor += 1
        return next_into

    @property
    def image_shape(self):
        return self._inner.image_shape

    @property
    def image_dtype(self):
        return self._inner.image_dtype

    @property
    def cursor(self) -> int:
        """Next batch the SOURCE will draw."""
        with self._lock:
            return self._cursor

    # ------------------------------------------------------------- resume
    def restore_state(self, step: int) -> bool:
        """Seek to "next batch = step" before the first draw; False when
        the source cannot seek (the caller replays instead)."""
        with self._draw_lock:
            if self._started:
                return False
            fn = getattr(self._inner, "restore_state", None)
            if not (getattr(self._inner, "supports_state", False)
                    and callable(fn) and fn(int(step))):
                return False
            with self._lock:
                self._cursor = int(step)
            return True

    def capture_state(self, next_step: int) -> Dict[str, object]:
        """The blob at the step barrier: `next_step` is the batch the
        trainer consumes next; everything the source drew past it is the
        in-flight set."""
        with self._lock:
            cursor = int(next_step)
            source_cursor = max(self._cursor, cursor)
            epoch = epoch_of(cursor, self._batches_per_epoch)
            return {
                "kind": BLOB_KIND,
                "version": ITERATOR_STATE_VERSION,
                "cursor": cursor,
                "epoch": epoch,
                "batches_per_epoch": self._batches_per_epoch,
                "seed": self._seed,
                "shuffle": {"algo": "splitmix64", "seed": self._seed,
                            "epoch": epoch},
                "source_cursor": source_cursor,
                "in_flight": list(range(cursor, source_cursor)),
                "wire": self._wire,
                "ingest": INGEST_LABEL,
                "rebuilds": 0,  # no live rebuild yet (ROADMAP A17)
            }

    def window_receipt(self, next_step: int) -> Dict[str, object]:
        """The per-window `iterator_state` block of a train record."""
        with self._lock:
            source_cursor = max(self._cursor, int(next_step))
            return {
                "cursor": int(next_step),
                "source_cursor": source_cursor,
                "in_flight": source_cursor - int(next_step),
                "epoch": epoch_of(int(next_step), self._batches_per_epoch),
                "rebuilds": 0,
                "wire": self._wire,
            }

    # -------------------------------------------------------- forwarding
    def num_threads(self) -> Optional[int]:
        """The source's decode-pool size, or None when it has no pool."""
        fn = getattr(self._inner, "num_threads", None)
        return fn() if callable(fn) else None

    def set_num_threads(self, n: int) -> Optional[int]:
        """Resize the source's decode pool mid-stream (the stream is the
        same at any size); the now-active size, or None when refused."""
        fn = getattr(self._inner, "set_num_threads", None)
        return fn(int(n)) if callable(fn) else None

    def decode_errors(self) -> int:
        fn = getattr(self._inner, "decode_errors", None)
        live = int(fn()) if callable(fn) else 0
        return self._decode_errors_closed + live

    def close(self) -> None:
        with self._draw_lock:
            if self._closed:
                return
            self._closed = True
            fn = getattr(self._inner, "decode_errors", None)
            if callable(fn):
                self._decode_errors_closed += int(fn())
            close = getattr(self._inner, "close", None)
            if callable(close):
                close()
            self._inner = None

    def __del__(self):  # pragma: no cover — best-effort cleanup
        try:
            self.close()
        except Exception:
            pass


def restore_from_blob(ingest, blob, *, step: int,
                      expect: Optional[Dict[str, object]] = None) \
        -> Optional[Dict[str, object]]:
    """Resume through a blob: validate it (schema, version, its cursor
    against the checkpoint's `step`, the stream identity in `expect`),
    seek `ingest` to the cursor and return the restore receipt — or None
    when the blob cannot be trusted or the seek is refused, and the caller
    replays instead. Seeking to `cursor` makes the refill draw exactly
    the blob's in-flight batches; `ingest_state/transplanted_items` counts
    them."""
    errors: List[str] = []
    schema.validate_iterator_state_blob(blob, "checkpoint.extra", errors)
    if errors:
        log.warning("iterator_state: checkpoint blob failed validation "
                    "(%s) — falling back to replay resume", errors[:3])
        return None
    if int(blob.get("version", -1)) != ITERATOR_STATE_VERSION:
        log.warning("iterator_state: blob version %s unknown (have %d) — "
                    "treating as receipt-absent", blob.get("version"),
                    ITERATOR_STATE_VERSION)
        return None
    if int(blob["cursor"]) != int(step):
        log.warning("iterator_state: blob cursor %s != checkpoint step %d — "
                    "falling back to replay resume", blob["cursor"], step)
        return None
    for field in IDENTITY_FIELDS:
        if expect and field in expect and field in blob \
                and blob[field] != expect[field]:
            log.warning("iterator_state: blob %s=%r but this run expects %r "
                        "— different stream, falling back to replay resume",
                        field, blob[field], expect[field])
            return None
    if not (getattr(ingest, "supports_state", False)
            and ingest.restore_state(int(blob["cursor"]))):
        return None
    transplanted = len(blob.get("in_flight") or [])
    reg = get_registry()
    reg.inc("ingest_state/restores")
    reg.inc("ingest_state/transplanted_items", transplanted)
    return {"cursor": int(blob["cursor"]),
            "epoch": int(blob["epoch"]),
            "transplanted_items": transplanted,
            "replayed_batches": 0,
            "wire": blob.get("wire")}
