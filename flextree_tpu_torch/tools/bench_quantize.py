"""Wire-codec A/B: the compressed allreduce per codec against the fused
float32 one, across a real process boundary.

    python -m flextree_tpu_torch.tools.bench_quantize [--quick]
        [--device cuda|cpu] [--out PATH]

The port's copy of the JAX package's ``tools/bench_quantize.py``:

1. **Cross-process rows (the headline)**: a world of
   :data:`NUM_PROCESSES` processes of one rank each, brought up by
   ``parallel/launch.py`` (``spawn`` and ``init_distributed``, gloo over
   loopback TCP), so every collective byte crosses a process boundary.
   On a card each rank holds CUDA tensors and ``DistTransport`` stages
   them through host memory for gloo (the folds run on the card).  Rows
   time ``parallel/compressed.py::compressed_allreduce`` per codec (f32
   identity, bf16, int8) and the plain ``allreduce``, at 2^18, 2^20 and
   2^22 float32 a rank (the last dropped by ``--quick``), in the JAX
   tool's shuffled-interleaved rounds (a shared seed, so both ranks run
   the same order).  Checks: int8 at least :data:`MIN_INT8_SPEEDUP` x
   the f32 row at the largest size (full run only), each lossy codec's
   error within ``Codec.error_bound``, the identity codec bitwise the
   plain allreduce, and f32 within rounding of the exact sum.  Each
   row's bytes a rank come from the transports' counters
   (``parallel/allreduce.py``: ``counting_wire``).
2. **In-process rows**: the same A/B on the 8-rank in-process mesh
   (``bench/harness.py::run_grad_sync_bench``), where a message is a
   device copy: reported, not gated.

Any violation exits 1.  The report (the JAX keys) goes to ``--out``
(default ``tmp/bench_quantize.json``), never to ``BENCH_QUANT.json``.
Runs on ``cuda`` unless ``--device cpu``; without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time

from . import checked_out

__all__ = ["NUM_PROCESSES", "SIZES", "QUICK_SIZES", "CODECS",
           "MIN_INT8_SPEEDUP", "child_main", "run_cluster", "run_in_process",
           "run_bench", "main"]

NUM_PROCESSES = 2
#: per-rank f32 element counts: 1 MB, 4 MB, 16 MB (largest = headline)
SIZES = (1 << 18, 1 << 20, 1 << 22)
QUICK_SIZES = (1 << 18, 1 << 20)
CODECS = ("f32", "bf16", "int8")
MIN_INT8_SPEEDUP = 1.3  # the acceptance floor, largest bucket


def _child_device(device: str):
    """A child's device: one intra-op thread on the CPU (two ranks share
    the host), the card otherwise."""
    import torch

    from ..device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    return dev


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def child_main(rank: int, world: int, sizes, repeat: int,
               device: str) -> dict:
    """One rank of the world (``launch.spawn`` runs it): every codec row
    timed in shuffled rounds, the numerics checked on this rank's result
    (the allreduce's result is every rank's), the fold launches and each
    row's wire bytes counted."""
    import random

    import numpy as np
    import torch

    from ..ops.quantize import get_codec
    from ..ops.reduce_stacked import reduce_sources
    from ..parallel.allreduce import allreduce, counting_wire
    from ..parallel.compressed import compressed_allreduce

    dev = _child_device(device)
    n = world
    topo = str(n)  # flat tree: one grouped exchange a phase
    reduce_sources.launches = 0
    results = {}
    for size in sizes:
        # rank r's data = seeded f(r): every rank rebuilds the exact sum
        def rank_rows(r):
            return np.random.default_rng(1000 + r).standard_normal(
                size).astype(np.float32)

        local = torch.from_numpy(rank_rows(rank)).to(dev)
        exact = sum(rank_rows(r).astype(np.float64) for r in range(n))
        amax = max(float(np.abs(rank_rows(r)).max()) for r in range(n))

        fns = {"plain_f32": lambda: allreduce(local, None, topo=topo)}
        for codec in CODECS:
            fns[codec] = lambda codec=codec: compressed_allreduce(
                local, None, topo=topo, codec=codec, step=0)
        outs, wire = {}, {}
        for k, fn in fns.items():
            with counting_wire() as w:
                outs[k] = fn()
            _sync(dev)
            wire[k] = w.read()["bytes"].get(rank, 0)
        shard = {k: v.cpu().numpy() for k, v in outs.items()}
        checks = {"identity_bitwise": bool(
            shard["f32"].tobytes() == shard["plain_f32"].tobytes())}
        for codec in ("bf16", "int8"):
            c = get_codec(codec)
            bound = c.error_bound(amax, n, (n,)) + 1e-5
            err = float(np.abs(shard[codec].astype(np.float64) - exact).max())
            checks[f"{codec}_max_err"] = err
            checks[f"{codec}_bound"] = bound
            checks[f"{codec}_within_bound"] = bool(err <= bound)
        checks["f32_exact"] = bool(np.allclose(
            shard["f32"].astype(np.float64), exact, rtol=1e-5, atol=1e-5))

        # shuffled-interleaved timing; the shuffle seed is shared so both
        # ranks run the same order (collectives stay matched)
        times = {k: [] for k in fns}
        order = list(fns)
        shuf = random.Random(0)
        for _ in range(repeat):
            shuf.shuffle(order)
            for k in order:
                _sync(dev)
                t0 = time.perf_counter()
                fns[k]()
                _sync(dev)
                times[k].append(time.perf_counter() - t0)
        rows = {k: {"min_ms": min(ts) * 1e3,
                    "avg_ms": sum(ts) / len(ts) * 1e3,
                    "wire_bytes": wire[k]}
                for k, ts in times.items()}
        for codec in CODECS:
            rows[codec]["vs_fused_f32"] = (rows["f32"]["min_ms"]
                                           / rows[codec]["min_ms"])
        results[str(size * 4)] = {"rows": rows, "checks": checks}
    return {"results": results,
            "launches": {"reduce_sources": reduce_sources.launches}}


def run_cluster(sizes, repeat, device: str, timeout_s: float = 900.0,
                log=print) -> dict:
    """The world of :data:`NUM_PROCESSES` ranks; rank 0's results, and
    every rank's fold launches."""
    from ..parallel.launch import spawn

    got = spawn(child_main, NUM_PROCESSES, (tuple(sizes), repeat, device),
                timeout=timeout_s)
    results = got[0]["results"]
    for key, sec in results.items():
        rows = sec["rows"]
        log(f"[quant x-proc] {int(key) >> 20}MB/rank: " + " ".join(
            f"{c}={rows[c]['min_ms']:.1f}ms({rows[c]['vs_fused_f32']:.2f}x)"
            for c in CODECS))
    return {"results": results,
            "launches": [g["launches"] for g in got]}


def run_in_process(quick: bool, device: str, leaf_size=None) -> dict:
    """The in-process rows: the same A/B on the 8-rank mesh."""
    from ..bench.harness import GradSyncBenchConfig, run_grad_sync_bench

    cfg = GradSyncBenchConfig(
        n_leaves=1,
        leaf_size=leaf_size or ((1 << 18) if quick else (1 << 20)),
        repeat=8 if quick else 16,
        codecs=("bf16", "int8"),
        device=device,
    )
    return run_grad_sync_bench(cfg)


def run_bench(*, quick: bool, device=None, sizes=None, repeat=None,
              inproc_leaf=None, log=print) -> dict:
    """Both sets of rows, the checks and the report (the JAX tool's
    ``main``); ``sizes``, ``repeat`` and ``inproc_leaf`` shrink it for
    tests."""
    from ..device import resolve_device

    device = str(resolve_device(device))
    sizes = sizes or (QUICK_SIZES if quick else SIZES)
    repeat = repeat or (4 if quick else 8)
    t0 = time.time()
    log(f"== cross-process rows ({NUM_PROCESSES}-proc gloo world on "
        f"{device}) ...")
    cluster = run_cluster(sizes, repeat, device, log=log)
    xproc = cluster["results"]
    log("== in-process rows (8 ranks, one process) ...")
    inproc = run_in_process(quick, device, inproc_leaf)

    largest = str(max(sizes) * 4)
    head = xproc[largest]
    violations = []
    int8_speedup = head["rows"]["int8"]["vs_fused_f32"]
    if int8_speedup < MIN_INT8_SPEEDUP and not quick:
        violations.append(
            f"int8 vs fused-f32 at largest bucket = {int8_speedup:.2f}x "
            f"< required {MIN_INT8_SPEEDUP}x"
        )
    for size_key, sec in xproc.items():
        ck = sec["checks"]
        for key in ("identity_bitwise", "f32_exact", "bf16_within_bound",
                    "int8_within_bound"):
            if not ck[key]:
                violations.append(f"{size_key}B: check {key} failed")

    from .bench_serving import _device_line
    import torch

    doc = {
        "description": "Wire-codec A/B for the FlexTree collectives: "
                       "compressed_allreduce (f32 identity / bf16 / int8 "
                       "block-scaled) vs the fused f32 collective",
        "protocol": {
            "cross_process": f"{NUM_PROCESSES} processes x 1 rank on "
                             f"{device}, parallel/launch.py spawn + "
                             "init_distributed + gloo; every collective "
                             "byte crosses a process boundary (CUDA "
                             "tensors staged through host memory); "
                             "shuffled-interleaved reps (shared shuffle "
                             "seed so ranks stay matched), min-of-reps",
            "in_process": "8 in-process ranks on one device "
                          "(run_grad_sync_bench, single leaf): a message "
                          "is a device copy and encode/decode competes "
                          "for the same device — included as the "
                          "negative control",
            "checks": f"int8 >= {MIN_INT8_SPEEDUP}x fused f32 at the "
                      "largest cross-process bucket (full run); identity "
                      "codec bitwise-equal to the uncompressed allreduce; "
                      "bf16/int8 error within Codec.error_bound; non-zero "
                      "exit on any violation",
        },
        "host": {
            "platform": platform.platform(),
            "cpus": os.cpu_count(),
            "torch": torch.__version__,
        },
        "device": _device_line(torch.device(device)),
        "cross_process": xproc,
        "in_process": {
            "rows": inproc["rows"],
            "num_devices": inproc["num_devices"],
            "total_mb": inproc["total_mb"],
        },
        "headline": {
            "bucket_bytes": int(largest),
            "int8_vs_fused_f32": round(int8_speedup, 3),
            "bf16_vs_fused_f32": round(
                head["rows"]["bf16"]["vs_fused_f32"], 3
            ),
            "int8_max_err": head["checks"]["int8_max_err"],
            "int8_bound": head["checks"]["int8_bound"],
        },
        "violations": violations,
        "launches": cluster["launches"],
        "elapsed_s": round(time.time() - t0, 1),
    }
    doc["diagnosis"] = (
        f"Across a real process boundary (gloo/TCP wire) the int8 "
        f"block-scaled codec syncs the largest bucket "
        f"{int8_speedup:.2f}x faster than the fused f32 collective "
        f"(bf16: {doc['headline']['bf16_vs_fused_f32']:.2f}x), with max "
        f"error {head['checks']['int8_max_err']:.4f} inside the documented "
        f"bound {head['checks']['int8_bound']:.4f}. In-process on the "
        f"8-rank mesh the same codecs measure "
        f"{inproc['rows']['ours_fused_int8']['vs_per_leaf'] / inproc['rows']['ours_fused']['vs_per_leaf']:.2f}x "
        f"the fused f32 sync: there a message is a device copy, so the "
        f"encode and decode cost more than the bytes they save — "
        f"compression pays where the wire is real.")
    return doc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="flextree_tpu_torch.tools.bench_quantize",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("tmp",
                                                  "bench_quantize.json"))
    ap.add_argument("--quick", action="store_true",
                    help="small sizes / few reps (smoke test)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = checked_out(ap, args.out)
    doc = run_bench(quick=args.quick, device=args.device,
                    log=lambda m: print(m, flush=True))
    with open(out, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"wrote {out} ({doc['elapsed_s']}s)")
    if doc["violations"]:
        print("MACHINE-CHECK VIOLATIONS:", file=sys.stderr)
        for v in doc["violations"]:
            print(f"  - {v}", file=sys.stderr)
        return 1
    h = doc["headline"]
    print(f"checks passed: int8 {h['int8_vs_fused_f32']:.2f}x at "
          f"{h['bucket_bytes'] >> 20}MB (floor {MIN_INT8_SPEEDUP}x "
          f"{'not ' if args.quick else ''}enforced), errors within bounds, "
          f"identity bitwise")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
