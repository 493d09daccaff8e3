"""Step watchdog: convert a hang into a typed ``FT_STEP_TIMEOUT``.

The port's copy of ``flextree_tpu/runtime/watchdog.py``.  A call that
blocks forever (a wedged launch, a peer that died inside a collective)
cannot be interrupted from Python, so the deadline wraps the *step*
from the host side.  :class:`StepWatchdog` runs the step on a persistent
daemon worker thread and waits with a deadline: expiry raises
:class:`StepTimeout` (carrying the step index and budget, message tagged
``FT_STEP_TIMEOUT``) while the stuck call is *abandoned* on its thread
(the thread is daemonized so it never blocks interpreter exit, and the
next ``run`` gets a fresh worker).  The caller decides what a timeout
means: the replica pool marks the replica suspect and never enters its
engine again.

On the card the worker thread is the one that launches the step's
kernels: PyTorch keeps the current stream and the cuBLAS handle per
thread, so a worker's first call pays their set-up.  Warm a step on the
worker before holding it to a tight deadline.

Fault-free overhead is one queue round-trip per step (the worker thread
is persistent, never spawned per step).
"""

from __future__ import annotations

import os
import queue
import threading

__all__ = ["FT_STEP_TIMEOUT_ENV", "StepTimeout", "StepWatchdog", "step_timeout_from_env"]

# env knob: per-step deadline in seconds (None = off)
FT_STEP_TIMEOUT_ENV = "FT_STEP_TIMEOUT"


def step_timeout_from_env() -> float | None:
    raw = os.environ.get(FT_STEP_TIMEOUT_ENV)
    return float(raw) if raw else None


class StepTimeout(RuntimeError):
    """A supervised step exceeded its deadline — the typed replacement for
    an infinite block.  Carries ``step`` and ``timeout_s``; ``code`` is
    the stable taxonomy tag harnesses match on."""

    code = "FT_STEP_TIMEOUT"

    def __init__(self, step: int | None, timeout_s: float, note: str = ""):
        self.step = step
        self.timeout_s = timeout_s
        at = f"step {step}" if step is not None else "step"
        super().__init__(
            f"{self.code}: {at} exceeded its {timeout_s:g}s deadline"
            + (f" ({note})" if note else "")
        )


class _Worker:
    """One daemon thread executing submitted calls in order."""

    def __init__(self):
        self.jobs: queue.Queue = queue.Queue()
        self.results: queue.Queue = queue.Queue()
        self.thread = threading.Thread(
            target=self._loop, daemon=True, name="ft-step-watchdog"
        )
        self.thread.start()

    def _loop(self):
        while True:
            job = self.jobs.get()
            if job is None:
                return
            fn, args, kwargs = job
            try:
                self.results.put(("ok", fn(*args, **kwargs)))
            except BaseException as e:  # delivered to the waiter, not lost
                self.results.put(("err", e))


class StepWatchdog:
    """Deadline-wrapped call execution on a persistent worker thread.

    ``run(fn, *args, timeout_s=...)`` returns ``fn``'s result or raises
    what it raised; on deadline expiry it raises :class:`StepTimeout` and
    abandons the stuck worker (counted in ``abandoned``) — the next call
    runs on a fresh thread, so one hang never poisons the watchdog.
    ``timeout_s=None`` calls ``fn`` inline (watchdog off, zero overhead).
    """

    def __init__(self):
        self._worker: _Worker | None = None
        self.abandoned = 0

    def run(self, fn, *args, timeout_s: float | None, step: int | None = None, **kwargs):
        if timeout_s is None:
            return fn(*args, **kwargs)
        if self._worker is None:
            self._worker = _Worker()
        w = self._worker
        w.jobs.put((fn, args, kwargs))
        try:
            status, value = w.results.get(timeout=timeout_s)
        except queue.Empty:
            # the worker is stuck inside fn: abandon it (daemon thread) and
            # let a future run() start clean
            self._worker = None
            self.abandoned += 1
            from ..obs import record_event

            record_event(
                "watchdog_timeout", step=step, timeout_s=timeout_s,
                abandoned=self.abandoned,
            )
            raise StepTimeout(step, timeout_s) from None
        if status == "err":
            raise value
        return value

    def close(self) -> None:
        if self._worker is not None:
            self._worker.jobs.put(None)
            self._worker = None

    def __enter__(self) -> "StepWatchdog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
