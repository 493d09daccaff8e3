"""Telemetry the serving tier and the gradient sync report through: the
metrics registry, its cross-process window readers and its Prometheus
exposition, the flight recorder, the bucket-plan provenance, the per-step
span clock (:mod:`.stepclock`, the probe-free feedback's measurement), and
the cross-rank timeline (:mod:`.timeline`; ``python -m
flextree_tpu_torch.obs`` merges, validates and summarizes a run's obs
directory, tables its residuals and pools many runs' with ``fleet``) — the
port's copies of ``flextree_tpu.obs``'s."""

from .metrics import (
    Counter,
    FrozenWindow,
    Gauge,
    Histogram,
    MetricsRegistry,
    WindowedHistogram,
    load_window,
    merged_window_percentile,
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
    use_recorder,
)
from .stepclock import StepPlan, StepSample, StepSpanClock, plan_from_capture

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "WindowedHistogram",
    "MetricsRegistry",
    "FrozenWindow",
    "load_window",
    "merged_window_percentile",
    "prometheus_exposition",
    "FlightRecorder",
    "current_recorder",
    "dump_current",
    "flight_recorder",
    "get_registry",
    "install_signal_dump",
    "record_event",
    "use_recorder",
    "bucket_provenance",
    "topo_spec",
    "StepPlan",
    "StepSample",
    "StepSpanClock",
    "plan_from_capture",
]
