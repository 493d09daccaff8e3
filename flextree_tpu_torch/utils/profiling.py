"""Named communication spans and span ledgers.

The port's copy of the part of ``flextree_tpu/utils/profiling.py`` that the
bucketed gradient sync reaches:

- :func:`comm_span` names one bucket's collectives: a
  ``torch.profiler.record_function`` range (where JAX has
  ``jax.named_scope``), so the bucket shows as one range over its fold and
  copy kernels in a ``torch.profiler`` trace; it feeds every active
  :class:`SpanLedger` and plan capture and the ambient flight recorder
  (:func:`..obs.record_event`, a no-op while none is installed);
- :class:`SpanLedger` / :func:`span_ledger` sum the ``_{n}B`` payload
  suffixes of the spans entered (:func:`span_bytes`);
  :func:`plan_capture` collects the spans that carry plan provenance;
- :func:`exposed_split` cuts a train step's sync time into the part that
  extended the step and the part that ran under the backward;
- :class:`Ewma` is the step-duration average the runtime supervisor
  publishes in each heartbeat.

One difference from the JAX package: a JAX span fires once, while the
step is traced, and never again for the compiled step; PyTorch runs
eagerly, so a span fires and records on every call.  A ledger or
capture therefore sees every bucket of every step run under it.
"""

from __future__ import annotations

import contextlib
import re

import torch

__all__ = [
    "comm_span",
    "span_bytes",
    "SpanLedger",
    "span_ledger",
    "plan_capture",
    "exposed_split",
    "Ewma",
]


class SpanLedger:
    """The names of the :func:`comm_span` scopes entered while it is active
    (``with span_ledger() as ledger``).  Bucket-sync span names carry their
    payload bytes as a ``_{nbytes}B`` suffix (``ft_bucket*``), so the
    ledger attributes the bytes each bucket carried."""

    def __init__(self):
        self.spans: list[str] = []

    def record(self, name: str) -> None:
        self.spans.append(name)

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(self.spans)

    def total_bytes(self, prefix: str = "") -> int:
        """Sum of the ``_{n}B`` suffixes of recorded spans with ``prefix``."""
        return sum(span_bytes(name) or 0 for name in self.spans
                   if name.startswith(prefix))


#: The byte-attribution suffix: the LAST ``_``-separated token must be
#: exactly ``{digits}B``.  Anchored, so a name whose final token merely
#: ends in ``B`` (``..._fooB``, ``..._0xB``) never counts.
_BYTES_SUFFIX = re.compile(r"_(\d+)B$")


def span_bytes(name: str) -> int | None:
    """The ``_{n}B`` payload suffix of a span name, or None."""
    m = _BYTES_SUFFIX.search(name)
    return int(m.group(1)) if m else None


_ACTIVE_LEDGERS: list[SpanLedger] = []

#: active plan captures: every ``comm_span`` entered with a provenance
#: payload appends ``(name, provenance)`` to each
_ACTIVE_PLAN_CAPTURES: list[list] = []


@contextlib.contextmanager
def span_ledger():
    """Collect every ``comm_span`` entered in this block into a
    :class:`SpanLedger` (reentrant: nested ledgers all record)."""
    ledger = SpanLedger()
    _ACTIVE_LEDGERS.append(ledger)
    try:
        yield ledger
    finally:
        _ACTIVE_LEDGERS.remove(ledger)


@contextlib.contextmanager
def plan_capture():
    """Collect every provenance-carrying ``comm_span`` entered in this
    block as ``(name, provenance_dict)`` pairs: the bucket plan of the
    steps run under it, one entry a bucket, axis and call."""
    cap: list = []
    _ACTIVE_PLAN_CAPTURES.append(cap)
    try:
        yield cap
    finally:
        _ACTIVE_PLAN_CAPTURES.remove(cap)


def exposed_split(step_ms: float, nosync_step_ms: float,
                  comm_total_ms: float) -> tuple[float, float]:
    """``(exposed_ms, hidden_ms)`` of a train step's sync time.

    ``exposed`` is the step's time over its sync-free twin's: the sync time
    that extended the step.  ``hidden`` is the rest of ``comm_total_ms``
    (the sync's own time): sync time that ran under the backward instead.
    Both are clamped at 0: on a noisy host the differences can cross zero,
    and a negative exposure means "fully hidden", not negative time."""
    exposed = max(float(step_ms) - float(nosync_step_ms), 0.0)
    hidden = max(float(comm_total_ms) - exposed, 0.0)
    return exposed, hidden


@contextlib.contextmanager
def comm_span(name: str, provenance: dict | None = None):
    """A named communication span: a ``torch.profiler.record_function``
    range over the collectives run inside it.

    Each bucket of the fused gradient sync (:mod:`..parallel.bucketing`)
    runs under an ``ft_bucket{i}_{axis}_{k}leaves_{bytes}B`` span.  The
    span feeds the active :class:`SpanLedger`\\ s and the flight recorder:
    ``provenance`` (the plan behind the span,
    :func:`..obs.provenance.bucket_provenance`) makes the recorded event a
    ``bucket_planned`` one carrying the plan and its predicted cost, and
    feeds the active :func:`plan_capture`\\ s; without it the event is a
    bare ``collective``."""
    from ..obs import record_event

    for ledger in _ACTIVE_LEDGERS:
        ledger.record(name)
    if provenance is not None:
        for cap in _ACTIVE_PLAN_CAPTURES:
            cap.append((name, provenance))
        record_event("bucket_planned", name=name, **provenance)
    else:
        record_event("collective", name=name, bytes=span_bytes(name))
    with torch.profiler.record_function(name):
        yield


class Ewma:
    """Exponentially-weighted moving average — the per-rank step-duration
    signal the runtime supervision layer classifies stragglers from.

    Each rank folds its step wall-times into an EWMA (``alpha`` weights
    the newest sample) and publishes it in its heartbeat
    (``runtime.supervisor.Supervisor``); the reader's
    ``MembershipView`` flags ranks whose EWMA is an outlier against the
    peer median.  An EWMA rather than the last sample so one noisy step
    (GC pause, page fault) doesn't flap the classification.
    """

    def __init__(self, alpha: float = 0.2):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self.value: float | None = None
        self.count = 0

    def update(self, sample: float) -> float:
        self.value = (
            sample
            if self.value is None
            else self.alpha * sample + (1.0 - self.alpha) * self.value
        )
        self.count += 1
        return self.value
