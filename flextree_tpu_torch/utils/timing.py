"""Timing utilities: device-aware benchmark loops.

PyTorch counterpart of ``flextree_tpu/utils/timing.py`` (``time_jax_fn``
at ``:87``, ``time_jax_fn_inplace`` at ``:108``).  The loops are the
reference harness's barrier + ``MPI_Wtime`` pattern
(``benchmark.cpp:149-174``) for an asynchronous device: on a CUDA device
each repetition is bracketed by CUDA events on the current stream and read
after one ``synchronize`` (PyTorch returns before the device finishes, so
a host clock would time the enqueue); on the CPU each repetition is timed
by the host clock.  The first call is timed on its own (``compile_s``: it
loads or builds the kernels), then ``warmup`` calls, then ``repeat`` timed
ones; :class:`BenchResult` gives their minimum, mean and median.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

__all__ = ["BenchResult", "time_fn", "time_fn_inplace"]


@dataclass(frozen=True)
class BenchResult:
    """Per-repetition times plus the min/avg summary the reference harness
    logs (``benchmark.cpp:215``) and the median."""

    times_s: tuple[float, ...]
    compile_s: float

    @property
    def min_s(self) -> float:
        return min(self.times_s)

    @property
    def avg_s(self) -> float:
        return sum(self.times_s) / len(self.times_s)

    @property
    def median_s(self) -> float:
        ts = sorted(self.times_s)
        n = len(ts)
        mid = n // 2
        return ts[mid] if n % 2 else 0.5 * (ts[mid - 1] + ts[mid])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _loop(step, device: torch.device, repeat: int, warmup: int,
          before=None) -> BenchResult:
    """``step()`` once (timed alone), ``warmup`` times, then ``repeat``
    timed times; ``before()``, when given, runs untimed before each timed
    repetition (a barrier, an L2 flush)."""
    t0 = time.perf_counter()
    step()
    _sync(device)
    compile_s = time.perf_counter() - t0
    for _ in range(warmup):
        step()
    _sync(device)
    times = []
    if device.type == "cuda":
        pairs = []
        for _ in range(repeat):
            if before is not None:
                before()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step()
            end.record()
            pairs.append((start, end))
        _sync(device)
        times = [s.elapsed_time(e) / 1e3 for s, e in pairs]
    else:
        for _ in range(repeat):
            if before is not None:
                before()
            t0 = time.perf_counter()
            step()
            times.append(time.perf_counter() - t0)
    return BenchResult(tuple(times), compile_s)


def time_fn(fn, *args, device=None, repeat: int = 10, warmup: int = 2,
            before=None) -> BenchResult:
    """Time ``fn(*args)``: the first call alone, then ``warmup`` untimed
    calls, then ``repeat`` timed ones (CUDA events on a CUDA ``device``,
    the host clock otherwise; ``device`` defaults to the first tensor
    argument's)."""
    if device is None:
        device = next((a.device for a in args if isinstance(a, torch.Tensor)),
                      torch.device("cpu"))
    return _loop(lambda: fn(*args), torch.device(device), repeat, warmup,
                 before)


def time_fn_inplace(fn, x, *, repeat: int = 10, warmup: int = 2,
                    before=None) -> BenchResult:
    """Time ``fn`` in place: each output feeds the next call's input — the
    reference benchmark's compounding ``MPI_IN_PLACE`` loop
    (``benchmark.cpp:149-159``).  ``fn``'s output must match its input in
    shape and dtype."""
    state = {"x": x}

    def step():
        state["x"] = fn(state["x"])

    return _loop(step, x.device, repeat, warmup, before)
