"""Validator of the iterator-state blob — an own copy of the JAX
package's ``telemetry/schema.py validate_iterator_state_blob`` (:194).
Stdlib only."""

from __future__ import annotations

from typing import Any, List

#: Legal `wire` receipts in iterator-state blobs.
_ITER_STATE_WIRES = ("host_f32", "host_bf16", "u8")


def validate_iterator_state_blob(blob: Any, where: str,
                                 errors: List[str]) -> None:
    """Append to `errors` every way `blob` breaks the shape
    `ResumableIngest.capture_state` writes (data/iterator_state.py):
    integer fields, the epoch equal to cursor // batches_per_epoch (the
    cursor is the next batch to emit), the splitmix64 shuffle record, the
    in-flight set exactly [cursor, source_cursor), and a known wire."""
    if not isinstance(blob, dict):
        errors.append(f"{where}: 'iterator_state' not an object")
        return
    if blob.get("kind") != "ingest_iterator_state":
        errors.append(f"{where}: 'kind' {blob.get('kind')!r} != "
                      "'ingest_iterator_state'")
    for key in ("version", "cursor", "epoch", "batches_per_epoch", "seed",
                "source_cursor", "rebuilds"):
        v = blob.get(key)
        if not isinstance(v, int) or isinstance(v, bool):
            errors.append(f"{where}: missing integer '{key}'")
    cursor, bpe = blob.get("cursor"), blob.get("batches_per_epoch")
    if isinstance(cursor, int) and isinstance(bpe, int) and bpe >= 1 \
            and isinstance(blob.get("epoch"), int):
        # the batch AT cursor k*N opens epoch k
        if blob["epoch"] != cursor // bpe:
            errors.append(f"{where}: epoch {blob['epoch']} != "
                          f"cursor//batches_per_epoch ({cursor // bpe}) — "
                          "cursor is next-item-to-emit, not last-emitted")
    shuffle = blob.get("shuffle")
    if not isinstance(shuffle, dict) \
            or shuffle.get("algo") != "splitmix64" \
            or not isinstance(shuffle.get("seed"), int) \
            or not isinstance(shuffle.get("epoch"), int):
        errors.append(f"{where}: 'shuffle' not "
                      "{algo: 'splitmix64', seed: int, epoch: int}")
    inflight = blob.get("in_flight")
    if not isinstance(inflight, list) \
            or not all(isinstance(c, int) for c in inflight):
        errors.append(f"{where}: 'in_flight' not a list of integers")
    elif isinstance(cursor, int) \
            and isinstance(blob.get("source_cursor"), int):
        if inflight != list(range(cursor, blob["source_cursor"])):
            errors.append(
                f"{where}: in_flight != [cursor, source_cursor) — the "
                "read-ahead transplant set must be exactly the undelivered "
                "source draws")
    wire = blob.get("wire")
    if wire is not None and wire not in _ITER_STATE_WIRES:
        errors.append(f"{where}: 'wire' {wire!r} not one of "
                      f"{_ITER_STATE_WIRES}")
