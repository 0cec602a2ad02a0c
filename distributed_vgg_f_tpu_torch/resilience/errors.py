"""Typed failures of the port's resilience layer — own copies of the JAX
package's ``resilience/errors.py`` classes the port raises: the data
stall, the checkpoint integrity failure and the layout-receipt
mismatch."""

from __future__ import annotations


class ResilienceError(RuntimeError):
    """Base class for every failure the resilience layer diagnoses."""


class DataStallError(ResilienceError):
    """The input pipeline stopped producing batches: the per-batch watchdog
    timed out through all its backoff retries, or the prefetch worker thread
    died without delivering a batch or an error (data/prefetch.py)."""


class CheckpointIntegrityError(ResilienceError):
    """A checkpoint failed its manifest verification and no intact fallback
    exists (or an explicitly requested step is corrupt). Restoring it would
    fail deep inside the read, or worse, silently load partial state
    (checkpoint/manager.py)."""


class GeometryReceiptError(ResilienceError, ValueError):
    """The checkpoint's opt-layout receipt names a geometry that does not
    reproduce against the live parameters: WRONG LAYOUT (saved for a
    different model, shard count or bucket size), not corrupt bytes — the
    integrity manifests already verified the bytes
    (checkpoint/retopology.py). Also a ValueError, as in the JAX
    package."""
