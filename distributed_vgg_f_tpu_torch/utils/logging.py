"""Structured metrics logging — an own copy of the JAX package's
``utils/logging.py MetricLogger`` without its TensorBoard sink (the
card's host has no tensorflow or tensorboard package; ROADMAP A14).

One JSONL record per event, stamped with `schema_version`
(telemetry/schema.py), plus a compact stdout line. Records are
spec-legal JSON: a non-finite float (a NaN loss is what the resilience
layer logs) is written as ``null`` with a sibling ``<key>_nonfinite``
string naming what it was, since ``json.dumps`` would otherwise emit
bare ``NaN`` tokens that strict parsers refuse. Nested mappings go into
the record and stay off the stdout line.
"""

from __future__ import annotations

import json
import logging
import math
import os
import sys
from typing import IO, Mapping, Optional

from distributed_vgg_f_tpu_torch.telemetry.schema import SCHEMA_VERSION

log = logging.getLogger("dvggf_torch")


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def _nonfinite_name(v: float) -> str:
    if math.isnan(v):
        return "nan"
    return "inf" if v > 0 else "-inf"


def _sanitize(value):
    """A JSON-legal deep copy: non-finite floats become None, and a dict
    entry gains a sibling `<key>_nonfinite` string naming what it was."""
    if isinstance(value, float) and not math.isfinite(value):
        return None
    if isinstance(value, Mapping):
        out = {}
        for k, v in value.items():
            k = str(k)
            if isinstance(v, float) and not math.isfinite(v):
                out[k] = None
                out[f"{k}_nonfinite"] = _nonfinite_name(v)
            else:
                out[k] = _sanitize(v)
        return out
    if isinstance(value, (list, tuple)):
        return [_sanitize(v) for v in value]
    return value


def _to_py(v):
    """A tensor or numpy scalar as its Python value."""
    if hasattr(v, "item"):
        try:
            return v.item()
        except (TypeError, ValueError, RuntimeError):
            return str(v)
    return v


class MetricLogger:
    """Writes one JSONL record per event and mirrors a compact line to
    `stream`. Only rank 0 constructs one in a multi-process run.

    A context manager: ``with MetricLogger(...) as logger`` closes the
    file on the way out of a crashing run, so the records on disk are
    complete up to the failure."""

    def __init__(self, jsonl_path: Optional[str] = None,
                 stream: IO = sys.stdout):
        self._stream = stream
        self._file: Optional[IO] = None
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
            self._file = open(jsonl_path, "a", buffering=1)

    def log(self, event: str, metrics: Mapping[str, object]) -> None:
        record = {"event": event, "schema_version": SCHEMA_VERSION,
                  **{k: _to_py(v) for k, v in metrics.items()}}
        if self._file is not None:
            # allow_nan=False: a non-finite value the sanitizer missed
            # fails here, at the write, instead of poisoning the archive
            self._file.write(json.dumps(_sanitize(record), allow_nan=False)
                             + "\n")
        pairs = " ".join(f"{k}={_fmt(v)}" for k, v in record.items()
                         if k not in ("event", "schema_version")
                         and not isinstance(v, Mapping))
        print(f"[{event}] {pairs}", file=self._stream, flush=True)

    def close(self) -> None:
        """Flush and close the file once; safe to call again. Never
        raises (it runs in `__exit__` of a crashing run, whose error it
        must not mask): a failure is logged."""
        file, self._file = self._file, None
        if file is None:
            return
        try:
            file.flush()
        except OSError as e:
            log.warning("MetricLogger flush failed: %r", e)
        try:
            file.close()
        except OSError as e:
            log.warning("MetricLogger close failed: %r", e)

    def __enter__(self) -> "MetricLogger":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
