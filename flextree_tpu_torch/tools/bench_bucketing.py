"""Gradient-bucketing A/B: the fused and chunked syncs against per-leaf.

    python -m flextree_tpu_torch.tools.bench_bucketing [--quick]
        [--device cuda|cpu] [--out PATH]

The port's copy of the JAX package's ``tools/bench_bucketing.py``, with
its three regimes, all on one in-process mesh of 8 ranks
(``bench/harness.py``):

- ``sync_many_small``: 48 leaves of 4096 float32 a rank, where the
  per-leaf sync pays one collective a leaf and the fused sync one a
  bucket (``run_grad_sync_bench``);
- ``sync_single_large``: one leaf of 2^20 float32 (2^18 with
  ``--quick``), where fusion has nothing to fuse and must not regress;
- ``train_step``: the data-parallel train step under each sync, 6 layers
  (2 with ``--quick``; ``run_train_step_bench``).

Rows ``per_leaf``, ``ours_fused`` and ``ours_chunked`` (and the train
step's ``ours_fused_supervised``, as the JAX tool's default config adds
it).  The correctness floor is the harness's: every rank's fused and
chunked output bitwise the per-leaf one, and the fused step's updated
parameters bitwise the per-leaf step's; a violation raises and the tool
exits non-zero.  The JAX tool has no timing floor.

On a card the train step's model is the flagship width
(``__graft_entry__.py``: vocab 8192, d_model 512, 8 heads, d_ff 2048)
at the JAX tool's depth; on the CPU it is the JAX tool's model.  Either
way it computes as the flagship does (bfloat16, the flash kernels).
The report (the JAX keys) goes to ``--out`` (default
``tmp/bench_bucketing.json``), never to ``BENCH_BUCKETING.json``.  Runs
on ``cuda`` unless ``--device cpu``; without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time

from . import FLAGSHIP as _FLAGSHIP
from . import checked_out

__all__ = ["FLAGSHIP", "run_bench", "main"]

#: the train step's model widths on a card (its depth is each regime's)
FLAGSHIP = {k: v for k, v in _FLAGSHIP.items() if k != "n_layers"}


def run_bench(*, quick: bool, device=None, log=print, leaf_size: int = 4096,
              n_leaves: int = 48, large: int | None = None,
              model: dict | None = None, repeat: tuple | None = None) -> dict:
    """The three regimes and the report (the JAX tool's ``main``).
    ``leaf_size``, ``n_leaves``, ``large``, ``model`` and ``repeat``
    (``(sync, step)`` reps) shrink the run for tests; by default they are
    the JAX tool's, ``model`` the flagship's widths on a card."""
    from ..bench.harness import (
        GradSyncBenchConfig,
        TrainStepBenchConfig,
        run_grad_sync_bench,
        run_train_step_bench,
    )
    from ..device import resolve_device
    from ..utils.buildstamp import artifact_meta

    dev = resolve_device(device)
    rep_sync, rep_step = repeat or ((5, 3) if quick else (30, 16))
    if model is None:
        model = FLAGSHIP if dev.type == "cuda" else {}
    t0 = time.time()
    results = {}

    cfg = GradSyncBenchConfig(n_leaves=n_leaves, leaf_size=leaf_size,
                              repeat=rep_sync, device=str(dev))
    log(f"== grad sync, many-small ({cfg.n_leaves} leaves) ...")
    results["sync_many_small"] = run_grad_sync_bench(cfg)

    cfg = GradSyncBenchConfig(
        n_leaves=1, leaf_size=large or ((1 << 18) if quick else (1 << 20)),
        repeat=rep_sync, device=str(dev))
    log("== grad sync, single-large ...")
    results["sync_single_large"] = run_grad_sync_bench(cfg)

    tcfg = TrainStepBenchConfig(n_layers=2 if quick else 6, repeat=rep_step,
                                supervised=True, device=str(dev), **model)
    log("== train step ...")
    results["train_step"] = run_train_step_bench(tcfg)

    doc = {
        "description": "Bucketed/fused + chunk-pipelined FlexTree gradient "
                       "sync vs per-leaf sync on 8 in-process ranks; rows "
                       "per regime: per_leaf, ours_fused, ours_chunked "
                       "(see flextree_tpu_torch/bench/harness.py)",
        "build": artifact_meta(),
        "protocol": "shuffled-interleaved rounds, each call timed to the "
                    "device's end (harness._interleaved_times), warm-up "
                    "excluded; 'identical' asserts the fused output (and "
                    "the fused step's updated params) are BITWISE equal "
                    "to per-leaf; sync_ms/compute_ms attribute the step "
                    "via the sync alone on gradient-shaped data",
        "host": {
            "platform": platform.platform(),
            "cpus": os.cpu_count(),
            "device": results["train_step"]["device"],
            "note": "in-process mesh: the 8 ranks run one after another "
                    "on one host thread and share one device, so a "
                    "collective's messages are device copies (or fold "
                    "sources read in place) and every launch of every "
                    "rank queues on one stream; per-collective launch "
                    "overhead dominates small collectives — the regime "
                    "message fusion targets — and chunk pipelining has "
                    "no parallel fabric to overlap with",
        },
        "diagnosis": None,  # filled below from the measured rows
        "elapsed_s": None,
        "results": results,
    }
    small = results["sync_many_small"]["rows"]
    large_rows = results["sync_single_large"]["rows"]
    step = results["train_step"]["rows"]
    doc["diagnosis"] = (
        f"Many-small-leaves sync: fused "
        f"{small['ours_fused']['vs_per_leaf']:.2f}x per-leaf "
        f"({small['per_leaf']['min_ms']:.2f} -> "
        f"{small['ours_fused']['min_ms']:.2f} ms, "
        f"{results['sync_many_small']['n_buckets']} bucket(s) for "
        f"{results['sync_many_small']['config']['n_leaves']} leaves) — the "
        "per-leaf path launches one collective's folds and copies per "
        "leaf, the fused path one set per bucket. Single-large-tensor: "
        f"fused {large_rows['ours_fused']['vs_per_leaf']:.2f}x — with one "
        "leaf the two paths run the same collective, so deviation from "
        "1.0 is noise, not a fusion cost; chunked "
        f"{large_rows['ours_chunked']['vs_per_leaf']:.2f}x (the in-process "
        "mesh runs its ranks one after another on one host thread and one "
        "stream, so chunking only adds launches; its overlap needs ranks "
        "on separate devices). Train step "
        f"({results['train_step']['n_grad_leaves']} leaves): per-leaf "
        f"{step['per_leaf']['train_step_ms']:.1f} ms vs fused "
        f"{step['ours_fused']['train_step_ms']:.1f} ms "
        f"({step['ours_fused']['vs_per_leaf']:.2f}x), sync-only "
        f"{step['per_leaf']['sync_ms']:.1f} -> "
        f"{step['ours_fused']['sync_ms']:.1f} ms with bitwise-identical "
        "updated params.")
    doc["elapsed_s"] = round(time.time() - t0, 1)
    return doc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="flextree_tpu_torch.tools.bench_bucketing",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("tmp",
                                                  "bench_bucketing.json"))
    ap.add_argument("--quick", action="store_true",
                    help="small sizes / few reps (smoke test)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = checked_out(ap, args.out)
    from ..device import resolve_device

    device = str(resolve_device(args.device))  # raises without a card
    try:
        doc = run_bench(quick=args.quick, device=device,
                        log=lambda m: print(m, flush=True))
    except RuntimeError as e:  # the harness's bitwise floor
        print(f"MACHINE-CHECK FAILED: {e}", file=sys.stderr)
        return 1
    with open(out, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"wrote {out} ({doc['elapsed_s']}s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
