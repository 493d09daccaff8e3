"""Per-rank flight recorder: bounded ring buffer + JSONL spill + dumps.

The port's copy of ``flextree_tpu/obs/recorder.py``.  Events carry the
same fields as the JAX package's (``ts``, ``rank``, ``src``, ``seq``,
``kind``), so either package's timeline tools read the other's files.
One addition: :func:`use_recorder` gives a thread a recorder of its own,
so in-process replicas record on tracks of their own.

1. **Cheap when off.**  :func:`record_event` is the library-wide
   instrumentation call; with no recorder installed it is a thread-local
   and a module attribute read and a ``None`` check.
2. **Cheap when on.**  ``record`` appends a small dict to a
   ``deque(maxlen=capacity)`` and stages the serialized line into a
   write buffer.  The file is touched only when the buffer reaches
   ``spill_every`` events or a *flush kind* (``drain``, ``dump`` …)
   arrives — a buffered write + ``flush()``, never an fsync.
3. **Forensics survive the process.**  Every event is eventually spilled
   to the rank's append-only JSONL file in ``seq`` order.  The soft
   failure paths additionally write an explicit **dump**: a ``dump``
   marker event plus a sidecar ``*.dump.json`` carrying the reason and
   the ring's last events.  :func:`install_signal_dump` chains one onto
   a signal (a serving replica's SIGTERM).

:func:`flight_recorder` installs a recorder and a metrics registry as the
ambient sinks; on exit it writes the registry's snapshot next to the
event file as ``metrics_{rank:05d}.json``.  Timestamps are wall time
(``_wall``, injectable) because events are correlated *across
processes* — a monotonic clock has no cross-process epoch.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import signal
import threading
import time
from collections import deque

from .metrics import MetricsRegistry

__all__ = [
    "EVENT_FILE_FMT",
    "DUMP_FILE_FMT",
    "FLUSH_KINDS",
    "FlightRecorder",
    "flight_recorder",
    "current_recorder",
    "use_recorder",
    "record_event",
    "dump_current",
    "get_registry",
    "install_signal_dump",
]

# injection point for tests (patch this, not time.time)
_wall = time.time

EVENT_FILE_FMT = "flight_{rank:05d}.jsonl"
DUMP_FILE_FMT = "flight_{rank:05d}.dump.json"

#: Event kinds that force the write buffer to disk when recorded: the
#: step boundary (per-step durability — a SIGKILL loses at most the
#: current step) and every failure-path marker (the JAX package's set).
FLUSH_KINDS = frozenset(
    {
        "step_end",
        "dump",
        "shrink",
        "watchdog_timeout",
        "nan_rewind",
        "preempt",
        "fit_end",
        "drain",
    }
)


class FlightRecorder:
    """One rank's event record.  ``dir=None`` keeps it memory-only (the
    ring still serves ``dump``-style introspection in tests)."""

    def __init__(
        self,
        dir: str | os.PathLike | None = None,
        rank: int = 0,
        *,
        capacity: int = 4096,
        spill_every: int = 64,
        source: str = "serve",
    ):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.dir = os.fspath(dir) if dir is not None else None
        self.rank = int(rank)
        self.capacity = int(capacity)
        self.spill_every = max(1, int(spill_every))
        self.source = source
        self.events: deque = deque(maxlen=capacity)  # guarded-by: _lock
        self.recorded = 0  # guarded-by: _lock
        self.dumps = 0  # guarded-by: _lock
        # batches dropped on write/flush failure
        self.spill_errors = 0  # guarded-by: _lock
        self._seq = itertools.count()
        self._pending: list[str] = []  # guarded-by: _lock
        self._lock = threading.Lock()
        self._fh = None  # guarded-by: _lock
        self._closed = False  # guarded-by: _lock
        if self.dir is not None:
            os.makedirs(self.dir, exist_ok=True)
            self._fh = open(  # noqa: SIM115 — held for the recorder's life
                self.event_path, "a", encoding="utf-8"
            )

    # ---- paths -------------------------------------------------------------

    @property
    def event_path(self) -> str | None:
        if self.dir is None:
            return None
        return os.path.join(self.dir, EVENT_FILE_FMT.format(rank=self.rank))

    @property
    def dump_path(self) -> str | None:
        if self.dir is None:
            return None
        return os.path.join(self.dir, DUMP_FILE_FMT.format(rank=self.rank))

    # ---- the hot path ------------------------------------------------------

    def record(self, kind: str, **fields) -> dict:
        """Record one structured event; returns it (tests read it back).

        Thread-safe: instrumentation sites include daemon threads (the
        heartbeat loop) next to the step loop.  ``fields`` must be
        JSON-serializable — the recorder serializes eagerly so a
        mutated-later dict can't rewrite history.
        """
        with self._lock:
            return self._record_locked(kind, fields)

    def _record_locked(self, kind: str, fields: dict) -> dict:
        # seq assignment, ring append and spill staging share the lock
        # so the file's line order IS seq order even with the heartbeat
        # daemon racing the step loop
        ev = {
            "ts": _wall(),
            "rank": self.rank,
            "src": self.source,
            "seq": next(self._seq),
            "kind": kind,
        }
        ev.update(fields)
        self.events.append(ev)
        self.recorded += 1
        if self._fh is not None and not self._closed:
            self._pending.append(json.dumps(ev, sort_keys=True, default=str))
            if len(self._pending) >= self.spill_every or kind in FLUSH_KINDS:
                self._spill_locked()
        return ev

    def _spill_locked(self) -> None:
        if not self._pending or self._fh is None:
            return
        try:
            self._fh.write("\n".join(self._pending) + "\n")
            self._fh.flush()
        except OSError:
            # obs must never take down the run it observes.  The batch
            # may have PARTIALLY landed (buffered write succeeded, flush
            # failed) — retrying it would duplicate lines in the record,
            # which corrupts the forensic stream worse than a counted
            # gap: drop the batch (the events stay in the ring for a
            # later dump) and account for it.
            self.spill_errors += 1
        self._pending.clear()

    def flush(self) -> None:
        with self._lock:
            self._spill_locked()

    # ---- failure paths -----------------------------------------------------

    def dump(self, reason: str, **fields) -> str | None:
        """The guaranteed-on-failure record: a ``dump`` marker event
        (flushed with everything before it) plus a sidecar JSON carrying
        the ring's last events.  Returns the sidecar path (None when
        memory-only).  Idempotent-safe: later dumps overwrite the
        sidecar — the newest failure context wins — while every marker
        event stays in the JSONL stream."""
        with self._lock:
            payload = self._dump_payload_locked(reason, fields)
        return self._write_dump(payload)

    def dump_nonblocking(self, reason: str, **fields) -> str | None:
        """Signal-handler-safe dump: a handler runs ON the thread it
        interrupted, so blocking on the recorder lock when that frame
        already holds it is a permanent deadlock.  Try the lock; if the
        interrupted frame holds it (a microseconds-wide window around
        each record), skip the dump rather than wedge the process the
        handler exists to evidence.  Returns None on skip/memory-only."""
        if not self._lock.acquire(blocking=False):
            return None
        try:
            payload = self._dump_payload_locked(reason, fields)
        finally:
            self._lock.release()
        return self._write_dump(payload)

    def _dump_payload_locked(self, reason: str, fields: dict) -> dict:
        self._record_locked("dump", {"reason": reason, **fields})
        self._spill_locked()  # the marker and everything before it
        self.dumps += 1
        payload = {
            "rank": self.rank,
            "src": self.source,
            "reason": reason,
            "ts": _wall(),
            "recorded": self.recorded,
            "events": list(self.events),
        }
        payload.update(fields)
        return payload

    def _write_dump(self, payload: dict) -> str | None:
        if self.dir is None:
            return None
        tmp = self.dump_path + ".tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(payload, f, sort_keys=True, default=str)
            os.replace(tmp, self.dump_path)
        except OSError:
            with contextlib.suppress(OSError):
                os.unlink(tmp)
            return None
        return self.dump_path

    def close(self) -> None:
        with self._lock:
            self._spill_locked()
            if self._fh is not None:
                with contextlib.suppress(OSError):
                    self._fh.close()
            self._closed = True
            self._fh = None

    def __enter__(self) -> "FlightRecorder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---- the ambient (module-level) recorder ---------------------------------
#
# Instrumentation sites call record_event()/get_registry() against these;
# both are None until a run installs a recorder, so the check is one
# global read.  Installation nests (the inner recorder wins, the outer is
# restored on exit) — the same shape as profiling.span_ledger.

_CURRENT: FlightRecorder | None = None
_CURRENT_REGISTRY: MetricsRegistry | None = None
# a thread's own recorder, set by use_recorder: it wins over _CURRENT for
# the events that thread records
_THREAD = threading.local()


def current_recorder() -> FlightRecorder | None:
    return getattr(_THREAD, "recorder", None) or _CURRENT


@contextlib.contextmanager
def use_recorder(recorder: FlightRecorder | None):
    """Send the events THIS thread records in the enclosed block to
    ``recorder`` (``None``: back to the ambient one); other threads keep
    theirs.  Nests.  In-process replicas use it to record on tracks of
    their own, as replica processes do: each replica's rounds run under a
    recorder of its own rank, and the merged timeline draws a re-routed
    request's flow from one replica's track to the other's."""
    prev = getattr(_THREAD, "recorder", None)
    _THREAD.recorder = recorder
    try:
        yield recorder
    finally:
        _THREAD.recorder = prev


def get_registry() -> MetricsRegistry | None:
    """The ambient metrics registry (installed with the recorder)."""
    return _CURRENT_REGISTRY


def record_event(kind: str, **fields) -> None:
    """Record into the ambient recorder; no-op (one ``None`` check) when
    no recorder is installed."""
    rec = getattr(_THREAD, "recorder", None) or _CURRENT
    if rec is not None:
        rec.record(kind, **fields)


def dump_current(reason: str, **fields) -> str | None:
    """Dump the ambient recorder (no-op when none installed)."""
    rec = getattr(_THREAD, "recorder", None) or _CURRENT
    if rec is not None:
        return rec.dump(reason, **fields)
    return None


@contextlib.contextmanager
def flight_recorder(
    dir: str | os.PathLike | None = None,
    rank: int = 0,
    *,
    capacity: int = 4096,
    spill_every: int = 64,
    source: str = "serve",
    registry: MetricsRegistry | None = None,
):
    """Install a :class:`FlightRecorder` (and a metrics registry) as the
    ambient telemetry sinks for the enclosed block.

    On exit the recorder is flushed and closed and, when ``dir`` is set,
    the registry snapshot is written next to the event file as
    ``metrics_{rank:05d}.json`` — the stable JSON export the reports
    view."""
    global _CURRENT, _CURRENT_REGISTRY
    rec = FlightRecorder(
        dir, rank, capacity=capacity, spill_every=spill_every, source=source
    )
    reg = registry if registry is not None else MetricsRegistry()
    prev, prev_reg = _CURRENT, _CURRENT_REGISTRY
    _CURRENT, _CURRENT_REGISTRY = rec, reg
    try:
        yield rec
    finally:
        _CURRENT, _CURRENT_REGISTRY = prev, prev_reg
        rec.close()
        if rec.dir is not None:
            snap_path = os.path.join(
                rec.dir, f"metrics_{rec.rank:05d}.json"
            )
            with contextlib.suppress(OSError):
                with open(snap_path, "w", encoding="utf-8") as f:
                    json.dump(reg.snapshot(), f, indent=2, sort_keys=True)


def install_signal_dump(
    recorder: FlightRecorder, signals=(signal.SIGTERM,)
) -> None:
    """Chain a flush+dump onto ``signals``' existing handlers (main
    thread only — a Python constraint).  The previous handler still
    runs, so default-terminate behavior is preserved."""
    for sig in signals:
        prev = signal.getsignal(sig)

        def _handler(signum, frame, _prev=prev):
            # non-blocking: the handler runs on the interrupted thread,
            # which may be holding the recorder lock mid-record — a
            # blocking dump there would deadlock instead of terminating
            recorder.dump_nonblocking("signal", signum=int(signum))
            if callable(_prev):
                _prev(signum, frame)
            elif _prev is not signal.SIG_IGN:
                # SIG_DFL, or None (installed from C, unknowable here):
                # never swallow a termination request — restore default
                # and re-raise so the process still dies
                signal.signal(signum, signal.SIG_DFL)
                signal.raise_signal(signum)

        signal.signal(sig, _handler)
