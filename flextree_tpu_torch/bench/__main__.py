"""Benchmark CLI: ``python -m flextree_tpu_torch.bench --bench allreduce
--ranks 8 --topo 4,2 --size 4096``.

PyTorch counterpart of ``flextree_tpu/bench/__main__.py``, with the flag
set of the reference harness (``benchmark.cpp:67-116``):

- ``--bench allreduce`` (default): the FlexTree allreduce of ``--size``
  elements per rank over ``--ranks`` ranks of an in-process mesh on one
  device (the JAX CLI's ``--cpu N`` virtual devices), or, with
  ``--dist``, over the processes of a ``torch.distributed`` group that
  :func:`~..parallel.launch.init_distributed` brings up from the
  ``FT_COORDINATOR`` / ``FT_NUM_PROCESSES`` / ``FT_PROCESS_ID``
  environment (or ``--cluster-config``), one process per rank;
- ``--bench reduce``: the fold kernel at ``--widths`` sources of
  ``--size`` elements against its plain version, ``torch.sum`` and the
  copy kernel (``tools/roofline_reduce.py``'s role).

Runs on ``cuda`` unless ``--device cpu``; without a GPU and without
``--device cpu`` it raises.  Prints one JSON object; exits 1 when the
allreduce's result is wrong.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="flextree_tpu_torch.bench")
    ap.add_argument("--bench", choices=["allreduce", "reduce"],
                    default="allreduce")
    ap.add_argument("--size", type=int, default=35,
                    help="elements per rank (reduce: per source)")
    ap.add_argument("--ranks", type=int, default=8,
                    help="ranks of the in-process mesh (ignored with --dist)")
    ap.add_argument("--repeat", type=int, default=10)
    ap.add_argument("--topo", type=str, default=None,
                    help="FT_TOPO-style widths, e.g. 4,2 or 3,2+1 or 1 (ring), "
                    "or an IR family: swing, gen:4,2@2")
    ap.add_argument("--dtype", type=str, default="float32")
    ap.add_argument("--op", type=str, default="sum")
    ap.add_argument("--widths", type=str, default="2,4,8",
                    help="reduce: source counts W to time")
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--dist", action="store_true",
                    help="one rank per process of a torch.distributed group")
    ap.add_argument("--cluster-config", type=str, default=None,
                    help="--dist: JSON cluster config (env FT_* overrides)")
    ap.add_argument("--no-in-place", action="store_true",
                    help="time without writing each result over its input")
    ap.add_argument("--tag", type=str, default="flextree")
    ap.add_argument("--to-file", action="store_true")
    ap.add_argument("--out-dir", type=str, default=".")
    args = ap.parse_args(argv)

    from ..device import resolve_device
    from . import harness

    device = str(resolve_device(args.device))
    if args.bench == "reduce":
        widths = tuple(int(w) for w in args.widths.split(","))
        cfg = harness.ReduceBenchConfig(
            shapes=tuple((w, args.size) for w in widths), dtype=args.dtype,
            op=args.op, repeat=args.repeat, device=device)
        print(json.dumps(harness.run_reduce_bench(cfg)))
        return 0

    cfg = harness.BenchConfig(
        size=args.size, repeat=args.repeat, topo=args.topo,
        devices=args.ranks, dtype=args.dtype, op=args.op, tag=args.tag,
        to_file=args.to_file, out_dir=args.out_dir,
        in_place=not args.no_in_place, device=device, dist=args.dist)
    if not args.dist:
        report = harness.run_allreduce_bench(cfg)
    else:
        from ..parallel.launch import init_distributed, shutdown_distributed

        init_distributed(args.cluster_config, device=device)
        try:
            report = harness.run_allreduce_bench(cfg)
        finally:
            shutdown_distributed()
    print(json.dumps(report.payload()))
    return 0 if report.correct else 1


if __name__ == "__main__":
    raise SystemExit(main())
