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

Two loops time single launches and chains, as the kernel table's rows
and the attention bench need them:

- :func:`time_launches` — the card's protocol for one kernel: each timed
  launch after an L2 flush (a cold cache, as a caller finds it) and a
  ~0.5 ms spin of the card (:data:`HEAD_START_CYCLES`), so it is enqueued
  while the card is busy and its CUDA events time the kernel, not the
  wrapper's Python.  Device time, immune to dispatch, as the JAX
  package's in-jit slope (``time_device_loop``) is.
- :func:`time_chained` — the JAX ``time_chained`` (``utils/timing.py:208``):
  a host clock over ``n_calls`` calls, each output fed back as the next
  first argument, and one final read, so it includes dispatch.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass

import torch

__all__ = ["BenchResult", "HEAD_START_CYCLES", "l2_flush", "time_chained",
           "time_fn", "time_fn_inplace", "time_launches"]


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


#: GPU cycles (~0.5 ms) the card spins before each timed launch of
#: :func:`time_launches`: the launch is enqueued while the card is busy.
HEAD_START_CYCLES = 1_000_000


def l2_flush(device) -> torch.Tensor:
    """The buffer :func:`time_launches` zeroes before each launch: 64 MiB
    on a card (more than an H100's 50 MB L2), empty on the CPU, which has
    no cold-cache protocol here."""
    device = torch.device(device)
    n = 64 << 20 if device.type == "cuda" else 0
    return torch.empty(n, dtype=torch.uint8, device=device)


def time_launches(fn, n: int, flush: torch.Tensor, warmup: int = 3) -> float:
    """Median ms of ``fn()`` over ``n`` launches, after ``warmup`` untimed
    ones.  On a card (``flush`` a CUDA tensor, :func:`l2_flush`) each
    timed launch follows a zeroing of ``flush`` (a cold L2) and a
    :data:`HEAD_START_CYCLES` spin, and is timed by CUDA events; on the
    CPU there are no events, and each launch is timed by the host clock."""
    for _ in range(warmup):
        fn()
    if flush.device.type != "cuda":
        times = []
        for _ in range(n):
            flush.zero_()
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(statistics.median(times))
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    for i in range(n):
        flush.zero_()
        torch.cuda._sleep(HEAD_START_CYCLES)
        starts[i].record()
        fn()
        ends[i].record()
    torch.cuda.synchronize(flush.device)
    return float(statistics.median(s.elapsed_time(e)
                                   for s, e in zip(starts, ends)))


def time_chained(fn, q, *rest, n_calls: int = 10) -> float:
    """Per-call seconds of ``fn(q, *rest)`` with each output fed back as
    the next first argument, on the host clock from the first call of
    the chain to a read of its last output (one ``synchronize`` on a
    card), so dispatch is inside the time.  One untimed call first (the
    kernels' build and load).  ``fn``'s output must have the shape and
    dtype of its first argument."""
    float(fn(q, *rest).float().sum())
    t0 = time.perf_counter()
    acc = q
    for _ in range(n_calls):
        acc = fn(acc, *rest)
    float(acc.float().sum())
    return (time.perf_counter() - t0) / n_calls
