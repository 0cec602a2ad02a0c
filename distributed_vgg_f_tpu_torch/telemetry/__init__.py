"""Telemetry of the port: span recorder (telemetry/spans.py) and
counter/gauge registry (telemetry/registry.py). Stdlib only."""

from __future__ import annotations

from distributed_vgg_f_tpu_torch.telemetry.registry import (
    TelemetryRegistry,
    get_registry,
)
from distributed_vgg_f_tpu_torch.telemetry.spans import (
    SpanRecorder,
    get_recorder,
    record,
)

__all__ = ["SpanRecorder", "TelemetryRegistry", "get_recorder",
           "get_registry", "record", "reset"]


def reset() -> None:
    """Clear the default recorder AND registry (tests)."""
    get_recorder().clear()
    get_registry().reset()
