"""Telemetry the serving engine and the gradient sync report through: the
metrics registry, the flight recorder and the bucket-plan provenance (the
port's copies of ``flextree_tpu.obs``'s)."""

from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    WindowedHistogram,
)
from .provenance import bucket_provenance, topo_spec
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
    "bucket_provenance",
    "topo_spec",
]
