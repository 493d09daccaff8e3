"""Metrics registry: counters / gauges / fixed-bucket histograms.

The port's own copy of ``flextree_tpu/obs/metrics.py``: the
instruments, the cross-process window readers (:class:`FrozenWindow`,
:func:`load_window`, :func:`merged_window_percentile`) and the
Prometheus text exposition (:func:`prometheus_exposition`, what the
serving front door and ``python -m flextree_tpu_torch.obs metrics
--prom`` export).

The registry replaces the ad-hoc accounting that accreted around the
runtime and serving layers (per-request stamp lists, scattered EWMA
plumbing, hand-rolled dict counters) with three bounded-memory
instruments and ONE stable JSON snapshot shape, so every report —
``run_report.json``, the serving pool report, bench artifacts — can be a
*view* over the same numbers instead of a parallel bookkeeping path.

Memory is bounded by construction: a counter/gauge is one float, a
histogram is a fixed bucket array (values land in the bucket whose upper
edge first contains them; an overflow bucket catches the tail) plus
running count/sum/min/max.  Percentiles are answered from the buckets —
exact to within one bucket's resolution, which is the honest granularity
an always-on layer can afford (the NumPy-oracle test in
``tests/test_obs.py`` pins the error bound).

Thread-safe: instruments are updated from step loops, daemon heartbeat
threads, and serving rounds concurrently; each mutation takes one short
lock.
"""

from __future__ import annotations

import math
import threading
import time

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "WindowedHistogram",
    "FrozenWindow",
    "MetricsRegistry",
    "DEFAULT_MS_BUCKETS",
    "load_window",
    "merged_window_percentile",
    "prometheus_exposition",
]

# injection point for the windowed-histogram tests (patch this, not
# time.monotonic): interval rotation is pure arithmetic over it, the same
# pattern runtime.supervisor._wall / serving.engine._now use
_now = time.monotonic

#: Default latency bucket upper edges (milliseconds): ~1-2-5 decades from
#: 100 µs to 100 s — wide enough for TTFTs and train steps alike.  13
#: buckets + overflow = bounded whatever the workload does.
DEFAULT_MS_BUCKETS = (
    0.1, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0,
    100.0, 500.0, 1_000.0, 10_000.0, 100_000.0,
)


class Counter:
    """Monotonic count.  ``inc`` rejects negative deltas — a counter that
    can go down is a gauge wearing a costume."""

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, delta: float = 1.0) -> None:
        if delta < 0:
            raise ValueError(f"counter delta must be >= 0, got {delta}")
        with self._lock:
            self._value += delta

    @property
    def value(self) -> float:
        return self._value

    def to_payload(self):
        v = self._value
        return int(v) if float(v).is_integer() else v


class Gauge:
    """Last-written value (queue depth, free blocks, alive replicas)."""

    def __init__(self):
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def add(self, delta: float) -> None:
        with self._lock:
            self._value += float(delta)

    @property
    def value(self) -> float:
        return self._value

    def to_payload(self):
        v = self._value
        return int(v) if float(v).is_integer() else v


def _bucket_percentile(q, edges, counts, count, minv, maxv) -> float:
    """The shared percentile-from-buckets interpolation: cumulative
    histograms and windowed snapshots must answer from ONE definition, or
    the arbiter's breach check and ``engine.report()`` could disagree
    about the same samples."""
    if count == 0:
        return math.nan
    target = q / 100.0 * count
    cum = 0
    for i, c in enumerate(counts):
        if c == 0:
            continue
        lo_edge = 0.0 if i == 0 else edges[i - 1]
        hi_edge = edges[i] if i < len(edges) else maxv
        if cum + c >= target:
            frac = (target - cum) / c
            lo = max(lo_edge, minv if minv is not None else lo_edge)
            return min(lo + frac * (hi_edge - lo), hi_edge)
        cum += c
    return maxv if maxv is not None else math.nan


class Histogram:
    """Fixed-bucket histogram: ``buckets`` are increasing upper edges; an
    implicit overflow bucket catches values past the last edge."""

    def __init__(self, buckets=DEFAULT_MS_BUCKETS):
        edges = tuple(float(b) for b in buckets)
        if not edges or any(nxt <= prev for nxt, prev in zip(edges[1:], edges)):
            raise ValueError(f"bucket edges must strictly increase: {edges}")
        self.edges = edges
        self.counts = [0] * (len(edges) + 1)  # +1: overflow
        self.count = 0
        self.sum = 0.0
        self.min: float | None = None
        self.max: float | None = None
        self._lock = threading.Lock()

    def _bucket_index(self, value: float) -> int:
        # linear scan: bucket lists are ~a dozen edges and most samples
        # land early; a bisect would save nothing measurable
        i = 0
        for i, edge in enumerate(self.edges):  # noqa: B007
            if value <= edge:
                break
        else:
            i = len(self.edges)
        return i

    def observe(self, value: float) -> None:
        value = float(value)
        i = self._bucket_index(value)
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.sum += value
            self.min = value if self.min is None else min(self.min, value)
            self.max = value if self.max is None else max(self.max, value)

    def percentile(self, q: float) -> float:
        """The ``q``-th percentile (0..100), answered from the buckets:
        linear interpolation inside the bucket the target rank lands in,
        so the error is bounded by that bucket's width.  Overflow-bucket
        answers clamp to the observed max (the one exact statistic the
        histogram keeps past the last edge)."""
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile must be in [0, 100], got {q}")
        return _bucket_percentile(
            q, self.edges, self.counts, self.count, self.min, self.max
        )

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else math.nan

    def to_payload(self) -> dict:
        return {
            "count": self.count,
            "sum": round(self.sum, 6),
            "min": self.min,
            "max": self.max,
            "mean": round(self.mean, 6) if self.count else None,
            "p50": round(self.percentile(50), 6) if self.count else None,
            "p95": round(self.percentile(95), 6) if self.count else None,
            "p99": round(self.percentile(99), 6) if self.count else None,
            "buckets": {
                (str(e) if i < len(self.edges) else "+inf"): c
                for i, (e, c) in enumerate(
                    zip(self.edges + (math.inf,), self.counts)
                )
                if c
            },
        }


class _WindowSlot:
    """One interval's sub-histogram: bucket counts + running stats, keyed
    by its absolute interval index so stale slots invalidate lazily."""

    __slots__ = ("k", "counts", "count", "sum", "min", "max")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets
        self.reset(-1)

    def reset(self, k: int) -> None:
        self.k = k
        for i in range(len(self.counts)):
            self.counts[i] = 0
        self.count = 0
        self.sum = 0.0
        self.min: float | None = None
        self.max: float | None = None


class WindowedHistogram(Histogram):
    """A :class:`Histogram` that ALSO answers over a rolling window.

    The cumulative view (everything :class:`Histogram` offers) dilutes a
    fresh breach after a long quiet run — a thousand healthy TTFTs drown
    the ten bad ones an SLO check needs to see *now*.  The windowed view
    keeps a ring of ``intervals`` per-interval sub-histograms (absolute
    interval index = ``now // interval_s``; a slot whose index fell out
    of the window reads as empty), so :meth:`window_percentile` answers
    over the last ``interval_s * intervals`` seconds only, with the SAME
    bucket interpolation as the cumulative percentile — the arbiter's
    breach check and ``engine.report()`` share one definition by
    construction.

    Memory stays bounded: the ring is ``intervals × (edges + 1)`` ints
    regardless of traffic.  The clock is the module's ``_now`` hook
    (monotonic; injectable for tests), or an explicit ``now=`` for
    deterministic replay.
    """

    def __init__(
        self,
        buckets=DEFAULT_MS_BUCKETS,
        *,
        interval_s: float = 1.0,
        intervals: int = 10,
    ):
        super().__init__(buckets)
        if interval_s <= 0 or intervals < 1:
            raise ValueError(
                f"need interval_s > 0 and intervals >= 1, got "
                f"{interval_s}/{intervals}"
            )
        self.interval_s = float(interval_s)
        self.intervals = int(intervals)
        self._slots = [
            _WindowSlot(len(self.edges) + 1) for _ in range(self.intervals)
        ]

    @property
    def window_s(self) -> float:
        return self.interval_s * self.intervals

    def observe(self, value: float, now: float | None = None) -> None:
        # one edge scan and ONE lock acquisition for both views: a
        # concurrent snapshot must never see the sample in the cumulative
        # count but not the window (or pay a second lock on the hot path)
        value = float(value)
        now = _now() if now is None else now
        k = int(now // self.interval_s)
        i = self._bucket_index(value)
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.sum += value
            self.min = value if self.min is None else min(self.min, value)
            self.max = value if self.max is None else max(self.max, value)
            slot = self._slots[k % self.intervals]
            if slot.k != k:
                slot.reset(k)
            slot.counts[i] += 1
            slot.count += 1
            slot.sum += value
            slot.min = value if slot.min is None else min(slot.min, value)
            slot.max = value if slot.max is None else max(slot.max, value)

    def window_counts(self, now: float | None = None):
        """Merged ``(counts, count, sum, min, max)`` over the live window
        — slots whose interval index fell behind ``now`` by more than
        ``intervals`` read as empty (lazy expiry: nothing rotates on a
        quiet histogram)."""
        now = _now() if now is None else now
        k = int(now // self.interval_s)
        counts = [0] * (len(self.edges) + 1)
        count, total = 0, 0.0
        minv: float | None = None
        maxv: float | None = None
        with self._lock:
            for slot in self._slots:
                if not (k - self.intervals < slot.k <= k) or slot.count == 0:
                    continue
                for i, c in enumerate(slot.counts):
                    counts[i] += c
                count += slot.count
                total += slot.sum
                if slot.min is not None:
                    minv = slot.min if minv is None else min(minv, slot.min)
                if slot.max is not None:
                    maxv = slot.max if maxv is None else max(maxv, slot.max)
        return counts, count, total, minv, maxv

    def window_percentile(self, q: float, now: float | None = None) -> float:
        """The ``q``-th percentile over the rolling window (NaN when the
        window holds no samples — the caller decides what "no evidence"
        means; the arbiter treats it as in-SLO)."""
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile must be in [0, 100], got {q}")
        counts, count, _, minv, maxv = self.window_counts(now)
        return _bucket_percentile(q, self.edges, counts, count, minv, maxv)

    def window_count(self, now: float | None = None) -> int:
        return self.window_counts(now)[1]

    def window_slots(self, now: float | None = None) -> list[dict]:
        """The live slots as ``{"age", "counts", "count", "sum", "min",
        "max"}`` dicts, ``age`` = how many whole intervals the slot sits
        behind ``now`` (0 = the current interval).  Ages, not absolute
        interval indices: the ring is keyed off this process's monotonic
        clock, which no other process shares — relative age plus a wall
        stamp is the only coordinate a cross-process reader can use."""
        now = _now() if now is None else now
        k = int(now // self.interval_s)
        out: list[dict] = []
        with self._lock:
            for slot in self._slots:
                if not (k - self.intervals < slot.k <= k) or slot.count == 0:
                    continue
                out.append({
                    "age": k - slot.k,
                    "counts": list(slot.counts),
                    "count": slot.count,
                    "sum": round(slot.sum, 6),
                    "min": slot.min,
                    "max": slot.max,
                })
        out.sort(key=lambda s: s["age"])
        return out

    def to_payload(self) -> dict:
        p = super().to_payload()
        counts, count, total, minv, maxv = self.window_counts()
        p["window"] = {
            "seconds": round(self.window_s, 6),
            "count": count,
            "min": minv,
            "max": maxv,
            "mean": round(total / count, 6) if count else None,
            "p50": round(
                _bucket_percentile(50, self.edges, counts, count, minv, maxv), 6
            ) if count else None,
            "p99": round(
                _bucket_percentile(99, self.edges, counts, count, minv, maxv), 6
            ) if count else None,
            # the cross-process series: everything another process needs
            # to re-answer window_percentile later, aging the slots off
            # the wall stamp as real time passes (the same payload shape
            # as the JAX package's, so its file readers can read it)
            "interval_s": self.interval_s,
            "intervals": self.intervals,
            "edges": list(self.edges),
            "wall": time.time(),
            "slots": self.window_slots(),
        }
        return p


class FrozenWindow:
    """A :class:`WindowedHistogram`'s rolling window reconstructed from a
    serialized payload — the read side of the cross-process round-trip.

    Quacks like the live histogram where it matters (``edges``,
    ``window_s``, ``window_counts``/``window_percentile``), so
    :func:`merged_window_percentile` merges frozen and live windows with
    one code path.  The clock, though, is WALL time anchored at the
    payload's ``wall`` stamp: a slot that was ``age`` intervals old when
    serialized expires once ``age + elapsed_intervals >= intervals``, so
    a stale metrics file decays to an empty window instead of asserting
    its last breach forever (exactly the lazy-expiry rule the live ring
    applies to its own slots)."""

    def __init__(self, edges, *, interval_s, intervals, wall, slots):
        self.edges = tuple(float(e) for e in edges)
        self.interval_s = float(interval_s)
        self.intervals = int(intervals)
        self.wall = float(wall)
        self._slots = [
            {
                "age": int(s["age"]),
                "counts": [int(c) for c in s["counts"]],
                "count": int(s["count"]),
                "sum": float(s.get("sum") or 0.0),
                "min": s.get("min"),
                "max": s.get("max"),
            }
            for s in slots
        ]

    @property
    def window_s(self) -> float:
        return self.interval_s * self.intervals

    def age_s(self, now: float | None = None) -> float:
        """Seconds of wall clock since the payload was serialized."""
        now = time.time() if now is None else now
        return max(0.0, now - self.wall)

    def window_counts(self, now: float | None = None):
        """Merged ``(counts, count, sum, min, max)`` over the slots still
        inside the window at wall time ``now`` (default: right now)."""
        elapsed = int(self.age_s(now) // self.interval_s)
        counts = [0] * (len(self.edges) + 1)
        count, total = 0, 0.0
        minv: float | None = None
        maxv: float | None = None
        for slot in self._slots:
            if slot["age"] + elapsed >= self.intervals:
                continue
            for i, c in enumerate(slot["counts"]):
                counts[i] += c
            count += slot["count"]
            total += slot["sum"]
            if slot["min"] is not None:
                minv = (
                    slot["min"] if minv is None else min(minv, slot["min"])
                )
            if slot["max"] is not None:
                maxv = (
                    slot["max"] if maxv is None else max(maxv, slot["max"])
                )
        return counts, count, total, minv, maxv

    def window_percentile(self, q: float, now: float | None = None) -> float:
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile must be in [0, 100], got {q}")
        counts, count, _, minv, maxv = self.window_counts(now)
        return _bucket_percentile(q, self.edges, counts, count, minv, maxv)

    def window_count(self, now: float | None = None) -> int:
        return self.window_counts(now)[1]


def load_window(payload: dict) -> FrozenWindow | None:
    """Reconstruct the rolling window from one histogram payload (the
    dict under ``snapshot()["histograms"][name]``).  ``None`` when the
    payload carries no windowed series — a plain histogram, or a file
    written before the series existed (absent ≠ empty window: the caller
    must treat it as "no windowed evidence", not "all clear")."""
    window = payload.get("window") if isinstance(payload, dict) else None
    if not isinstance(window, dict) or "slots" not in window:
        return None
    try:
        return FrozenWindow(
            window["edges"],
            interval_s=window["interval_s"],
            intervals=window["intervals"],
            wall=window["wall"],
            slots=window["slots"],
        )
    except (KeyError, TypeError, ValueError):
        return None


def merged_window_percentile(
    hists, q: float, now: float | None = None
) -> tuple[float, int]:
    """``(percentile, sample_count)`` over the union of several
    :class:`WindowedHistogram` windows — the arbiter's cross-replica SLO
    reading (each serving replica owns its registry; the SLO is a
    property of the POOL).  Histograms must share bucket edges; NaN with
    count 0 when every window is empty."""
    hists = [h for h in hists if h is not None]
    if not hists:
        return math.nan, 0
    edges = hists[0].edges
    for h in hists[1:]:
        if h.edges != edges:
            raise ValueError(
                "merged_window_percentile needs identical bucket edges: "
                f"{h.edges} vs {edges}"
            )
    counts = [0] * (len(edges) + 1)
    count = 0
    minv: float | None = None
    maxv: float | None = None
    for h in hists:
        c, n, _, lo, hi = h.window_counts(now)
        for i, v in enumerate(c):
            counts[i] += v
        count += n
        if lo is not None:
            minv = lo if minv is None else min(minv, lo)
        if hi is not None:
            maxv = hi if maxv is None else max(maxv, hi)
    return _bucket_percentile(q, edges, counts, count, minv, maxv), count


def _prom_name(name: str, prefix: str = "flextree_") -> str:
    """Sanitize a registry metric name into the Prometheus grammar
    (``[a-zA-Z_:][a-zA-Z0-9_:]*``): dots/dashes become underscores,
    anything else invalid is dropped."""
    out = []
    for ch in name:
        if ch.isalnum() or ch in "_:":
            out.append(ch)
        elif ch in ".-/ ":
            out.append("_")
    s = prefix + "".join(out)
    if s and s[0].isdigit():
        s = "_" + s
    return s


def prometheus_exposition(snapshots: dict, prefix: str = "flextree_") -> str:
    """Render registry snapshots as Prometheus text exposition (format
    0.0.4) — ``{label_value: registry.snapshot()}`` keyed by rank (or any
    instance label), so the JAX package's ``obs metrics DIR --prom``
    makes the serving SLO instruments scrapeable without parsing
    ``metrics_{rank}.json``.

    Counters/gauges map 1:1; histograms follow the Prometheus histogram
    convention (cumulative ``_bucket{le=...}`` series from the snapshot's
    per-bucket counts, plus ``_sum``/``_count``); a windowed histogram
    additionally exposes its rolling-window view as ``_window_p99`` /
    ``_window_count`` gauges — the exact numbers an SLO breach check
    reads, so an external scraper alerts on the same quantity.  A payload
    that carries the windowed series is re-aged off its wall stamp at
    read time (:func:`load_window`): a scrape of a stale metrics file
    sees the window drain.
    """
    types: dict[str, str] = {}
    lines_by_name: dict[str, list[str]] = {}

    def emit(name: str, kind: str, line: str) -> None:
        types.setdefault(name, kind)
        lines_by_name.setdefault(name, []).append(line)

    for label, snap in sorted(snapshots.items()):
        lbl = f'{{rank="{label}"}}'
        for raw, val in (snap.get("counters") or {}).items():
            n = _prom_name(raw, prefix)
            emit(n, "counter", f"{n}{lbl} {val}")
        for raw, val in (snap.get("gauges") or {}).items():
            n = _prom_name(raw, prefix)
            emit(n, "gauge", f"{n}{lbl} {val}")
        for raw, h in (snap.get("histograms") or {}).items():
            n = _prom_name(raw, prefix)
            types.setdefault(n, "histogram")
            buckets = h.get("buckets") or {}
            parsed = []
            for edge, count in buckets.items():
                e = math.inf if edge == "+inf" else float(edge)
                parsed.append((e, int(count)))
            parsed.sort(key=lambda ec: ec[0])
            cum = 0
            rows = lines_by_name.setdefault(n, [])
            for e, c in parsed:
                cum += c
                le = "+Inf" if math.isinf(e) else repr(e)
                rows.append(
                    f'{n}_bucket{{rank="{label}",le="{le}"}} {cum}'
                )
            total = int(h.get("count", cum))
            if not parsed or not math.isinf(parsed[-1][0]):
                rows.append(f'{n}_bucket{{rank="{label}",le="+Inf"}} {total}')
            rows.append(f"{n}_sum{lbl} {h.get('sum', 0.0)}")
            rows.append(f"{n}_count{lbl} {total}")
            window = h.get("window")
            if isinstance(window, dict):
                p99 = window.get("p99")
                count = window.get("count", 0)
                # a payload carrying the windowed series re-answers at
                # READ time, aged off the wall stamp — a scrape of a
                # stale metrics file must see the window drain, not the
                # last write's summary frozen forever
                frozen = load_window(h)
                if frozen is not None:
                    v = frozen.window_percentile(99.0)
                    p99 = None if math.isnan(v) else round(v, 6)
                    count = frozen.window_count()
                wn = n + "_window_p99"
                if p99 is not None:
                    emit(wn, "gauge", f"{wn}{lbl} {p99}")
                wc = n + "_window_count"
                emit(wc, "gauge", f"{wc}{lbl} {count}")

    out: list[str] = []
    for name in sorted(lines_by_name):
        out.append(f"# TYPE {name} {types[name]}")
        out.extend(lines_by_name[name])
    return "\n".join(out) + ("\n" if out else "")


class MetricsRegistry:
    """Named instruments with create-on-first-use semantics and one
    stable snapshot.  Asking for an existing name with a different
    instrument kind is an error (silent shadowing is how two subsystems
    end up disagreeing about what ``requests`` means)."""

    def __init__(self):
        self._instruments: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, kind, factory):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = factory()
                self._instruments[name] = inst
            elif not isinstance(inst, kind):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, requested {kind.__name__}"
                )
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge, Gauge)

    def histogram(self, name: str, buckets=DEFAULT_MS_BUCKETS) -> Histogram:
        return self._get(name, Histogram, lambda: Histogram(buckets))

    def windowed_histogram(
        self,
        name: str,
        buckets=DEFAULT_MS_BUCKETS,
        *,
        interval_s: float = 1.0,
        intervals: int = 10,
    ) -> WindowedHistogram:
        """A histogram that ALSO answers rolling-window percentiles (the
        arbiter's SLO view).  Create it BEFORE any plain ``histogram()``
        call for the same name: a ``WindowedHistogram`` satisfies later
        ``histogram()`` lookups (it IS one), but a plain histogram cannot
        be upgraded in place."""
        return self._get(
            name,
            WindowedHistogram,
            lambda: WindowedHistogram(
                buckets, interval_s=interval_s, intervals=intervals
            ),
        )

    def __contains__(self, name: str) -> bool:
        return name in self._instruments

    def snapshot(self) -> dict:
        """``{"counters": {...}, "gauges": {...}, "histograms": {...}}``
        with sorted names — the stable JSON shape reports embed."""
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            items = sorted(self._instruments.items())
        for name, inst in items:
            if isinstance(inst, Counter):
                out["counters"][name] = inst.to_payload()
            elif isinstance(inst, Gauge):
                out["gauges"][name] = inst.to_payload()
            else:
                out["histograms"][name] = inst.to_payload()
        return out
