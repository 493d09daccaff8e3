"""Per-rank flight recorder: bounded ring buffer + JSONL spill.

The port's own copy of the part of ``flextree_tpu/obs/recorder.py`` that
the serving engine reaches: :func:`record_event` (a no-op, one ``None``
check, while no recorder is installed), :func:`current_recorder` and the
:func:`flight_recorder` context that installs one.  Events carry the same
fields as the JAX package's (``ts``, ``rank``, ``src``, ``seq``,
``kind``), so its timeline tools read the port's files.  The failure-path
dumps and signal hooks come with the runtime slices of the port.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import deque

__all__ = [
    "EVENT_FILE_FMT",
    "FlightRecorder",
    "flight_recorder",
    "current_recorder",
    "record_event",
]

# injection point for tests (patch this, not time.time)
_wall = time.time

EVENT_FILE_FMT = "flight_{rank:05d}.jsonl"


class FlightRecorder:
    """One rank's event record: a ``deque(maxlen=capacity)`` ring plus,
    when ``dir`` is set, an append-only JSONL file written every
    ``spill_every`` events and at close.  ``dir=None`` keeps it in
    memory only."""

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
        self.spill_every = max(1, int(spill_every))
        self.source = source
        self.events: deque = deque(maxlen=capacity)  # guarded-by: _lock
        self.recorded = 0  # guarded-by: _lock
        self._seq = itertools.count()
        self._pending: list[str] = []  # guarded-by: _lock
        self._lock = threading.Lock()
        self._fh = None  # guarded-by: _lock
        if self.dir is not None:
            os.makedirs(self.dir, exist_ok=True)
            self._fh = open(  # noqa: SIM115 — held for the recorder's life
                self.event_path, "a", encoding="utf-8"
            )

    @property
    def event_path(self) -> str | None:
        if self.dir is None:
            return None
        return os.path.join(self.dir, EVENT_FILE_FMT.format(rank=self.rank))

    def record(self, kind: str, **fields) -> dict:
        """Record one structured event; returns it.  ``fields`` must be
        JSON-serializable; the line is serialized now, so a dict mutated
        later cannot rewrite history."""
        with self._lock:
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
            if self._fh is not None:
                self._pending.append(json.dumps(ev, sort_keys=True,
                                                default=str))
                if len(self._pending) >= self.spill_every:
                    self._spill_locked()
            return ev

    def _spill_locked(self) -> None:
        if not self._pending or self._fh is None:
            return
        try:
            self._fh.write("\n".join(self._pending) + "\n")
            self._fh.flush()
        except OSError:
            # telemetry must never take down the run it observes; the
            # events stay in the ring
            pass
        self._pending.clear()

    def close(self) -> None:
        with self._lock:
            self._spill_locked()
            if self._fh is not None:
                with contextlib.suppress(OSError):
                    self._fh.close()
            self._fh = None


_CURRENT: FlightRecorder | None = None


def current_recorder() -> FlightRecorder | None:
    return _CURRENT


def record_event(kind: str, **fields) -> None:
    """Record into the installed recorder; a no-op when none is."""
    rec = _CURRENT
    if rec is not None:
        rec.record(kind, **fields)


@contextlib.contextmanager
def flight_recorder(
    dir: str | os.PathLike | None = None,
    rank: int = 0,
    *,
    capacity: int = 4096,
    spill_every: int = 64,
    source: str = "serve",
):
    """Install a :class:`FlightRecorder` as the ambient event sink for the
    enclosed block (nested installs restore the outer one on exit); the
    recorder is flushed and closed on exit."""
    global _CURRENT
    rec = FlightRecorder(dir, rank, capacity=capacity,
                         spill_every=spill_every, source=source)
    prev = _CURRENT
    _CURRENT = rec
    try:
        yield rec
    finally:
        _CURRENT = prev
        rec.close()
