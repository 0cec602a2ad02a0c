"""Telemetry of the port: span recorder (telemetry/spans.py) and
counter/gauge registry (telemetry/registry.py). Stdlib only."""

from __future__ import annotations

from distributed_vgg_f_tpu_torch.telemetry.registry import (
    TelemetryRegistry,
    get_registry,
    inc,
)
from distributed_vgg_f_tpu_torch.telemetry.spans import (
    SpanRecorder,
    get_recorder,
    record,
    span,
)

__all__ = ["SpanRecorder", "TelemetryRegistry", "get_recorder",
           "get_registry", "inc", "record", "reset", "span"]


def reset() -> None:
    """Clear the default recorder AND registry (tests)."""
    get_recorder().clear()
    get_registry().reset()
