"""Preemption-aware checkpointing: SIGTERM → checkpoint now, saves off
the step path.

The port's copy of ``flextree_tpu/runtime/preemption.py``.  Preemptible
capacity (spot machines, cluster evictions) delivers SIGTERM with a short
grace window; the two pieces here shrink the rewind window from both
ends:

- :class:`PreemptionGuard` — an async-signal-safe SIGTERM trap.  The
  handler only sets an event; ``fit`` polls it every loop iteration and
  takes the "checkpoint now" fast path — a synchronous save of the
  *current* state — before exiting cleanly, so at most one step of work
  is lost.
- :class:`BackgroundSaver` — periodic saves without stalling steps: a
  daemon thread with a depth-1 latest-wins slot, written through
  :func:`..utils.checkpoint.save_train_state`.  A new submit while a save
  is in flight replaces the pending one.

Tensors on the card: the saver thread reads tensors that the step
produced on the main thread's stream (and, under overlap, joined from a
side stream into it).  ``submit`` records an event on the current stream
of each device the state lives on, on the submitting thread; the saver
waits on those events before it copies a leaf to the host, so the copy
never reads a tensor whose producing kernels are still queued.  The slot
holds the state's references until the write lands, so the caching
allocator cannot hand a leaf's memory to a later step meanwhile.  The
port's steps are functional (they return new tensors and write into no
leaf of the state they were given), so the snapshot is the state as
submitted however many steps run in the meantime.

Both report what they did (``triggered_at``/``saves``/``errors``) so
``RunReport`` can account for them; neither raises into the step loop.
"""

from __future__ import annotations

import os
import signal
import threading
import time

import torch

from ..utils.logging import get_logger

__all__ = ["PreemptionGuard", "BackgroundSaver"]

log = get_logger("flextree.runtime")


class PreemptionGuard:
    """Latch SIGTERM (by default) into a pollable "checkpoint now" flag.

    ``install()`` replaces the handler (main thread only — a Python
    constraint) and remembers the previous one; ``uninstall()`` restores
    it.  ``trigger()`` is the in-process injection point for tests and
    for other delivery mechanisms (a metadata watcher thread).
    """

    def __init__(self, signals=(signal.SIGTERM,)):
        self.signals = tuple(signals)
        self._event = threading.Event()
        self._previous: dict[int, object] = {}
        self.triggered_at: float | None = None

    def _handler(self, signum, frame):
        # async-signal-safe: set the flag, nothing else
        self.trigger()

    def trigger(self) -> None:
        if not self._event.is_set():
            self.triggered_at = time.time()
        self._event.set()

    @property
    def preempted(self) -> bool:
        return self._event.is_set()

    def install(self) -> "PreemptionGuard":
        for sig in self.signals:
            self._previous[sig] = signal.signal(sig, self._handler)
        return self

    def uninstall(self) -> None:
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()


def _device_events(state) -> list:
    """One event recorded on the current stream of each CUDA device that a
    leaf of ``state`` lives on (none for a host state)."""
    from ..utils.tree import tree_leaves

    devices = {t.device for t in tree_leaves(state)
               if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
    events = []
    for dev in sorted(devices, key=str):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        events.append(ev)
    return events


class BackgroundSaver:
    """Off-step-path checkpoint writer: depth-1 latest-wins save slot.

    ``submit(state)`` never blocks on I/O; the daemon thread waits for the
    state's device work, copies it to the host and writes it via
    ``save_train_state`` (same rotation and integrity path as synchronous
    saves, so restores cannot tell them apart).  ``drain()`` waits for the
    slot to empty — call it before process exit or before a synchronous
    save of the same directory (two writers racing the rotation is the
    one thing the design forbids).
    """

    def __init__(self, ckpt_dir: str | os.PathLike, *, max_to_keep: int = 3):
        self.ckpt_dir = os.fspath(ckpt_dir)
        self.max_to_keep = max_to_keep
        self.saves = 0
        self.dropped = 0  # submits coalesced away by latest-wins
        self.errors: list[str] = []
        self._pending = None  # guarded-by: _lock ((state, events) or None)
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._stop = False
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="ft-bg-ckpt"
        )
        self._thread.start()

    def submit(self, state) -> None:
        events = _device_events(state)  # on the submitting thread's streams
        with self._lock:
            if self._pending is not None:
                self.dropped += 1
            self._pending = (state, events)
            self._idle.clear()
        self._wake.set()

    def _loop(self) -> None:
        from ..utils import checkpoint

        while True:
            self._wake.wait()
            with self._lock:
                item, self._pending = self._pending, None
                self._wake.clear()
                if item is None and self._stop:
                    self._idle.set()
                    return
            if item is None:
                self._idle.set()
                continue
            state, events = item
            try:
                for ev in events:
                    ev.synchronize()  # the step's kernels have run
                checkpoint.save_train_state(
                    self.ckpt_dir, state, max_to_keep=self.max_to_keep
                )
                self.saves += 1
            except Exception as e:  # never raises into the step loop
                self.errors.append(f"{type(e).__name__}: {e}")
                log.warning("background checkpoint failed: %s", e)
            del state, item  # the references go only once the write landed
            with self._lock:
                if self._pending is None:
                    self._idle.set()

    def drain(self, timeout: float | None = 30.0) -> bool:
        """Wait until no save is pending or in flight."""
        return self._idle.wait(timeout)

    def close(self, timeout: float | None = 30.0) -> None:
        self.drain(timeout)
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=timeout)

    def __enter__(self) -> "BackgroundSaver":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
