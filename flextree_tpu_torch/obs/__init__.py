"""Telemetry the serving tier and the gradient sync report through: the
metrics registry and its Prometheus exposition, the flight recorder and
the bucket-plan provenance (the port's copies of ``flextree_tpu.obs``'s)."""

from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    WindowedHistogram,
    prometheus_exposition,
)
from .provenance import bucket_provenance, topo_spec
from .recorder import (
    FlightRecorder,
    current_recorder,
    dump_current,
    flight_recorder,
    get_registry,
    install_signal_dump,
    record_event,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "WindowedHistogram",
    "MetricsRegistry",
    "prometheus_exposition",
    "FlightRecorder",
    "current_recorder",
    "dump_current",
    "flight_recorder",
    "get_registry",
    "install_signal_dump",
    "record_event",
    "bucket_provenance",
    "topo_spec",
]
