"""Record-shape validators — own copies of the JAX package's
``telemetry/schema.py`` checks the port's records need: the metrics JSONL
the trainer writes through utils/logging.py MetricLogger
(`validate_metrics_record`, `validate_metrics_jsonl`: one strict JSON
object per line, an `event` string, a known `schema_version` major, no
non-finite value anywhere, the train record's `stall`, `augment`,
`comm` and `iterator_state` blocks typed, and the autotuner's `autotune`
block and `autotune_armed` receipt: JAX's `validate_autotune_actuation`,
`_block` and `_receipt`), and the checkpoint's iterator-state blob
(`validate_iterator_state_blob`). The port's records never carry the
elastic and critical-path blocks (ROADMAP A13b, A14c), so this validator
does not check them. Each `validate_*` appends error strings
(empty = valid). Stdlib only."""

from __future__ import annotations

import json
import math
from typing import Any, List

#: Record-schema version stamped into every JSONL record. A MAJOR bump
#: means a reader of the old shape would misread the new one; MINOR bumps
#: are additive. Validators accept any minor of a known major and an
#: absent version, and refuse unknown majors.
SCHEMA_VERSION = "1.0"
KNOWN_SCHEMA_MAJORS = (1,)

#: Legal `wire` receipts in iterator-state blobs and blocks.
_ITER_STATE_WIRES = ("host_f32", "host_bf16", "u8")

#: Legal gradient-exchange sharding bases of the `comm` block.
_COMM_SHARDINGS = ("dp", "zero1", "zero2", "zero3")


def validate_schema_version(value: Any, path: str,
                            errors: List[str]) -> None:
    """None (a record without a version) is legal; a present value must
    be a "MAJOR.MINOR" string of a known major."""
    if value is None:
        return
    if not isinstance(value, str):
        errors.append(f"{path}: schema_version not a string "
                      f"({type(value).__name__})")
        return
    try:
        major = int(value.split(".", 1)[0])
    except ValueError:
        errors.append(f"{path}: schema_version {value!r} not MAJOR.MINOR")
        return
    if major not in KNOWN_SCHEMA_MAJORS:
        errors.append(
            f"{path}: unknown schema_version major {major} (known: "
            f"{KNOWN_SCHEMA_MAJORS}) — this reader predates the record; "
            "refusing to guess at its shape")


def _strict_loads(text: str):
    """json.loads refusing the non-standard NaN/Infinity/-Infinity
    tokens that a naive json.dumps of a non-finite float emits."""

    def _bad(token: str):
        raise ValueError(f"JSON-illegal constant {token!r}")

    return json.loads(text, parse_constant=_bad)


def _check_finite(value: Any, path: str, errors: List[str]) -> None:
    """Recursively refuse non-finite floats, non-string keys and
    non-JSON values."""
    if isinstance(value, float) and not math.isfinite(value):
        errors.append(f"{path}: non-finite float {value!r}")
    elif isinstance(value, dict):
        for k, v in value.items():
            if not isinstance(k, str):
                errors.append(f"{path}.{k}: non-string key")
            _check_finite(v, f"{path}.{k}", errors)
    elif isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            _check_finite(v, f"{path}[{i}]", errors)
    elif value is not None and not isinstance(value, (str, int, float,
                                                      bool)):
        errors.append(f"{path}: non-JSON value of type "
                      f"{type(value).__name__}")


def _nonneg_int(v: Any) -> bool:
    return isinstance(v, int) and not isinstance(v, bool) and v >= 0


def _nonneg_number(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool) \
        and v >= 0

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


def validate_iterator_state_block(block: Any, where: str,
                                  errors: List[str]) -> None:
    """The train record's per-window `iterator_state` block
    (`ResumableIngest.window_receipt`)."""
    if not isinstance(block, dict):
        errors.append(f"{where}: 'iterator_state' not an object")
        return
    for key in ("cursor", "source_cursor", "in_flight", "epoch",
                "rebuilds"):
        if not _nonneg_int(block.get(key)):
            errors.append(f"{where}: '{key}' not a non-negative integer")
    wire = block.get("wire")
    if wire is not None and wire not in _ITER_STATE_WIRES:
        errors.append(f"{where}: 'wire' {wire!r} not one of "
                      f"{_ITER_STATE_WIRES}")


def validate_augment_block(block: Any, where: str,
                           errors: List[str]) -> None:
    """The train record's `augment` block (`AugmentConfig.describe`):
    `enabled` and `host_flips_disabled` booleans, the knobs typed."""
    if not isinstance(block, dict):
        errors.append(f"{where}: 'augment' not an object")
        return
    for key in ("enabled", "host_flips_disabled"):
        if not isinstance(block.get(key), bool):
            errors.append(f"{where}: missing boolean '{key}'")
    if "hflip" in block and not isinstance(block["hflip"], bool):
        errors.append(f"{where}: 'hflip' not a boolean")
    for key in ("crop_jitter", "rand_ops"):
        v = block.get(key)
        if v is not None and not _nonneg_int(v):
            errors.append(f"{where}: '{key}' not a non-negative integer")
    for key in ("mixup_alpha", "cutmix_alpha"):
        v = block.get(key)
        if v is not None and not _nonneg_number(v):
            errors.append(f"{where}: '{key}' not a non-negative number")
    v = block.get("rand_magnitude")
    if v is not None and (not _nonneg_number(v) or v > 1):
        errors.append(f"{where}: 'rand_magnitude' not in [0, 1]")


def validate_comm_block(block: Any, where: str,
                        errors: List[str]) -> None:
    """The train record's `comm` block (train/step.py `comm_meta`): the
    sharding basis, whether the exchange is bucketed, the bucket count
    and size, the collective payload bytes a step, the micro-batch count
    and the param all-gathers a step (0 under dp, ZeRO-1/2's one trailing
    re-sync, one a bucket under ZeRO-3's just-in-time gather)."""
    if not isinstance(block, dict):
        errors.append(f"{where}: 'comm' not an object")
        return
    sharding = block.get("sharding")
    if sharding not in _COMM_SHARDINGS:
        errors.append(f"{where}: 'sharding' {sharding!r} not one of "
                      f"{_COMM_SHARDINGS}")
    if not isinstance(block.get("bucketed"), bool):
        errors.append(f"{where}: missing boolean 'bucketed'")
    v = block.get("buckets")
    if not _nonneg_int(v) or v < 1:
        errors.append(f"{where}: 'buckets' not a positive integer")
    if not _nonneg_number(block.get("bucket_mb")):
        errors.append(f"{where}: 'bucket_mb' not a non-negative number")
    for key in ("wire_bytes", "scatter_bytes", "gather_bytes",
                "allreduce_bytes"):
        v = block.get(key)
        if key == "wire_bytes" and v is None:
            errors.append(f"{where}: missing 'wire_bytes'")
        if v is not None and not _nonneg_int(v):
            errors.append(f"{where}: '{key}' not a non-negative integer")
    v = block.get("grad_accum_steps")
    if v is not None and (not _nonneg_int(v) or v < 1):
        errors.append(f"{where}: 'grad_accum_steps' not a positive integer")
    v = block.get("gathers")
    if v is not None and not _nonneg_int(v):
        errors.append(f"{where}: 'gathers' not a non-negative integer")


#: The stall verdicts (telemetry/stall.py VERDICTS, duplicated so this
#: module stays a leaf).
_STALL_VERDICTS = ("guard_stalled", "checkpoint_bound", "infeed_bound",
                   "compute_bound")

#: Knobs the ingest autotuner may steer (data/autotune.py) and the
#: serving admission controller's, as in JAX's schema.
_AUTOTUNE_KNOBS = ("native_threads", "host_prefetch", "prefetch_to_device",
                   "restart_fanout", "wire_u8", "batch_window_ms")
_AUTOTUNE_BLOCKED = ("hysteresis", "cooldown", "rail")


def validate_stall_block(block: Any, where: str, errors: List[str]) -> None:
    """A train record's `stall` block (telemetry/stall.py classify): a
    known verdict, the infeed and checkpoint fractions in [0, 1], and the
    optional guard skips, queue depth and eval seconds typed."""
    if not isinstance(block, dict):
        errors.append(f"{where}: 'stall' not an object")
        return
    if block.get("verdict") not in _STALL_VERDICTS:
        errors.append(f"{where}: 'verdict' {block.get('verdict')!r} not one "
                      f"of {_STALL_VERDICTS}")
    for key in ("infeed_fraction", "checkpoint_fraction"):
        v = block.get(key)
        if not _nonneg_number(v) or v > 1.0:
            errors.append(f"{where}: '{key}' not a number in [0, 1]")
    v = block.get("guard_skips")
    if v is not None and (not _nonneg_int(v) or v == 0):
        errors.append(f"{where}: 'guard_skips' not a positive integer")
    for key in ("queue_depth", "eval_seconds"):
        v = block.get(key)
        if v is not None and not _nonneg_number(v):
            errors.append(f"{where}: '{key}' not a non-negative number")


def validate_autotune_actuation(act: Any, where: str,
                                errors: List[str]) -> None:
    """One actuation record: the unit of the `autotune` block's
    `actuations` and of `describe()`'s history."""
    if not isinstance(act, dict):
        errors.append(f"{where}: not an object")
        return
    if act.get("knob") not in _AUTOTUNE_KNOBS:
        errors.append(f"{where}: 'knob' {act.get('knob')!r} not one of "
                      f"{_AUTOTUNE_KNOBS}")
    if act.get("direction") not in ("up", "down"):
        errors.append(f"{where}: 'direction' {act.get('direction')!r} not "
                      "'up'|'down'")
    for key in ("from", "to", "window"):
        if not isinstance(act.get(key), int):
            errors.append(f"{where}: missing integer '{key}'")


def validate_autotune_block(block: Any, where: str,
                            errors: List[str]) -> None:
    """The per-window `autotune` block of a train record
    (IngestAutotuner.observe's shape): every move the controller makes
    can be audited from the records alone."""
    if not isinstance(block, dict):
        errors.append(f"{where}: 'autotune' not an object")
        return
    if not isinstance(block.get("window"), int):
        errors.append(f"{where}: missing integer 'window'")
    if not isinstance(block.get("settled"), bool):
        errors.append(f"{where}: missing boolean 'settled'")
    knobs = block.get("knobs")
    if knobs is not None:
        if not isinstance(knobs, dict):
            errors.append(f"{where}: 'knobs' not an object")
        else:
            for name, v in knobs.items():
                if name not in _AUTOTUNE_KNOBS:
                    errors.append(f"{where}.knobs: unknown knob {name!r}")
                if not isinstance(v, int):
                    errors.append(f"{where}.knobs.{name}: not an integer")
    blocked = block.get("blocked")
    if blocked is not None and blocked not in _AUTOTUNE_BLOCKED:
        errors.append(f"{where}: 'blocked' {blocked!r} not one of "
                      f"{_AUTOTUNE_BLOCKED}")
    acts = block.get("actuations")
    if acts is not None:
        if not isinstance(acts, list):
            errors.append(f"{where}: 'actuations' not a list")
        else:
            for i, act in enumerate(acts):
                validate_autotune_actuation(act, f"{where}.actuations[{i}]",
                                            errors)


def validate_autotune_receipt(receipt: Any, where: str,
                              errors: List[str]) -> None:
    """IngestAutotuner.describe's shape: the `autotune_armed` record."""
    if not isinstance(receipt, dict):
        errors.append(f"{where}: 'autotune' not an object")
        return
    if not isinstance(receipt.get("enabled"), bool):
        errors.append(f"{where}: missing boolean 'enabled'")
    if receipt.get("enabled"):
        if not isinstance(receipt.get("settled"), bool):
            errors.append(f"{where}: missing boolean 'settled'")
        if not isinstance(receipt.get("actuations_total"), int):
            errors.append(f"{where}: missing integer 'actuations_total'")
        hist = receipt.get("history")
        if hist is not None:
            if not isinstance(hist, list):
                errors.append(f"{where}: 'history' not a list")
            else:
                for i, act in enumerate(hist):
                    validate_autotune_actuation(
                        act, f"{where}.history[{i}]", errors)



def validate_metrics_record(record: Any) -> List[str]:
    """One MetricLogger record, already parsed."""
    errors: List[str] = []
    if not isinstance(record, dict):
        return [f"record is {type(record).__name__}, expected object"]
    event = record.get("event")
    if not isinstance(event, str) or not event:
        errors.append("missing/empty 'event' string")
    validate_schema_version(record.get("schema_version"), "record", errors)
    if "autotune" in record:
        validate_autotune_block(record["autotune"], "record", errors)
    if event == "autotune_armed":
        validate_autotune_receipt(record, "record", errors)
    if event == "train":
        for key, check in (("stall", validate_stall_block),
                           ("augment", validate_augment_block),
                           ("comm", validate_comm_block),
                           ("iterator_state",
                            validate_iterator_state_block)):
            if key in record:
                check(record[key], "record", errors)
    _check_finite(record, "record", errors)
    return errors


def validate_metrics_jsonl(path: str, max_errors: int = 20) -> List[str]:
    """Every line of the file parses strictly and validates."""
    errors: List[str] = []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                record = _strict_loads(line)
            except ValueError as e:
                errors.append(f"line {lineno}: {e}")
            else:
                errors.extend(f"line {lineno}: {err}"
                              for err in validate_metrics_record(record))
            if len(errors) >= max_errors:
                errors.append("... (truncated)")
                break
    return errors
