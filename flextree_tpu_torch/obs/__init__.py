"""Telemetry the serving engine reports through: the metrics registry and
the flight recorder (the port's copies of ``flextree_tpu.obs``'s)."""

from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    WindowedHistogram,
)
from .recorder import (
    FlightRecorder,
    current_recorder,
    flight_recorder,
    record_event,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "WindowedHistogram",
    "MetricsRegistry",
    "FlightRecorder",
    "current_recorder",
    "flight_recorder",
    "record_event",
]
