"""Typed failures of the port's resilience layer — own copies of the JAX
package's ``resilience/errors.py`` classes the port raises."""

from __future__ import annotations


class ResilienceError(RuntimeError):
    """Base class for every failure the resilience layer diagnoses."""


class DataStallError(ResilienceError):
    """The input pipeline stopped producing batches: the per-batch watchdog
    timed out through all its backoff retries, or the prefetch worker thread
    died without delivering a batch or an error (data/prefetch.py)."""
