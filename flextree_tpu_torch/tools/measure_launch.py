"""Measure the launch constant of the card, bracketed from two sides.

    python -m flextree_tpu_torch.tools.measure_launch [--device cuda|cpu]
        [--out PATH]

The port's copy of the JAX package's ``tools/measure_launch.py``.  The
cost model's ``launch_us`` prices the fixed overhead each tree stage
pays beyond the wire.  One card runs no multi-card collective, so the
measurable quantity is the fixed cost of one more launch, bracketed:

- ``device_op_us`` (the lower bound): the per-launch slope of a chain of
  tiny dependent elementwise launches (an ``(8, 128)`` float32 multiply
  each) captured in one CUDA graph, between two chain lengths, so the
  host's dispatch is out of it (the JAX tool's in-jit ``fori_loop``
  slope);
- ``host_dispatch_us`` (the upper bound): the slope of K eager launches
  of the same op with one final ``synchronize``, at two values of K, so
  the one-off sync cancels;
- ``launch_us``: their geometric midpoint, as in the JAX tool's
  ``measure_launch_bracket``.

It writes nothing into the calibration: the port's ``calibrate_host``
fits ``launch_us`` from its own matrix, and the planner's cost functions
stay equal to the JAX package's.  The result is printed and written to
``--out`` (default ``tmp/measure_launch.json``).  On the CPU there are
no graphs, and both bounds are host-clock slopes of eager launches.
Runs on ``cuda`` unless ``--device cpu``; without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import time

import torch

from . import checked_out

__all__ = ["measure_device_op_us", "measure_host_dispatch_us",
           "measure_launch_bracket", "main"]


def _op(a: torch.Tensor) -> torch.Tensor:
    return a * 1.000001


def measure_device_op_us(dev, n_lo: int = 8, n_hi: int = 256,
                         samples: int = 5) -> float:
    """Per-launch µs of a dependent elementwise chain replayed from one
    CUDA graph: the median over ``samples`` of the slope between
    ``n_lo`` and ``n_hi`` launches (on the CPU, of eager chains)."""
    x = torch.ones((8, 128), dtype=torch.float32, device=dev)
    if dev.type != "cuda":
        def run(n):
            t0 = time.perf_counter()
            a = x
            for _ in range(n):
                a = _op(a)
            return time.perf_counter() - t0
    else:
        graphs = {}
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            _op(x)  # warm the op before capture
        torch.cuda.current_stream(dev).wait_stream(side)
        for n in (n_lo, n_hi):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                a = x
                for _ in range(n):
                    a = _op(a)
            graphs[n] = g

        def run(n):
            g = graphs[n]
            g.replay()  # warm
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            g.replay()
            end.record()
            torch.cuda.synchronize(dev)
            return start.elapsed_time(end) / 1e3

    slopes = [(run(n_hi) - run(n_lo)) / (n_hi - n_lo) for _ in range(samples)]
    return statistics.median(slopes) * 1e6


def measure_host_dispatch_us(dev, k_lo: int = 4, k_hi: int = 64,
                             best_of: int = 5) -> float:
    """Per-launch µs of K eager dependent launches and one final
    ``synchronize``: the slope between ``k_lo`` and ``k_hi`` of each
    K's best of ``best_of``."""
    x0 = torch.ones((8, 128), dtype=torch.float32, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    _op(x0)
    sync()

    def run(k: int) -> float:
        best = float("inf")
        for _ in range(best_of):
            a = x0
            sync()
            t0 = time.perf_counter()
            for _ in range(k):
                a = _op(a)
            sync()
            best = min(best, time.perf_counter() - t0)
        return best

    return (run(k_hi) - run(k_lo)) / (k_hi - k_lo) * 1e6


def measure_launch_bracket(device=None) -> dict:
    """Both bounds and the midpoint, with the JAX tool's keys, plus the
    device."""
    from ..device import resolve_device

    dev = resolve_device(device)
    dev_us = measure_device_op_us(dev)
    host_us = measure_host_dispatch_us(dev)
    # a noisy inversion (a shared host) must not give a negative or
    # inverted bracket: the midpoint is of the sorted, positive pair
    lo, hi = sorted((max(dev_us, 1e-3), max(host_us, 1e-3)))
    smi = None
    if dev.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    return {
        "device_op_us": dev_us,
        "host_dispatch_us": host_us,
        "launch_us": math.sqrt(lo * hi),
        "provenance": (
            f"measured bracket on {dev}: the per-launch slope of a dependent "
            f"elementwise chain in one CUDA graph, {dev_us:.3f} us (lower "
            f"bound, 8..256 launches) <= launch_us <= the slope of eager "
            f"launches with one final synchronize, {host_us:.3f} us (upper "
            f"bound, K=4..64); the value is the geometric midpoint"
            if dev.type == "cuda" else
            f"host-clock slopes of eager launches on {dev} (no graphs): "
            f"{dev_us:.3f} and {host_us:.3f} us; not a device measurement"),
        "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "nvidia_smi": smi,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="flextree_tpu_torch.tools.measure_launch",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("tmp", "measure_launch.json"))
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = checked_out(ap, args.out)
    r = measure_launch_bracket(args.device)
    for k, v in r.items():
        print(f"{k}: {v}")
    with open(out, "w") as f:
        json.dump(r, f, indent=1)
        f.write("\n")
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
