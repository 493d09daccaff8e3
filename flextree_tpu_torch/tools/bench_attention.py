"""Attention A/B: the port's flash kernels against PyTorch's
``scaled_dot_product_attention`` and the full-matrix reference, at the
JAX attention bench's shape.

    python -m flextree_tpu_torch.tools.bench_attention [--samples N]
        [--device cuda|cpu] [--out PATH]

The port's copy of the JAX package's ``tools/bench_attention.py``.  Each
row is one :func:`~..bench.harness.run_attention_bench` at B=4, T=4096,
H=16, D=128, bf16, causal (``--batch``, ``--seq-len``, ``--heads``,
``--head-dim``, ``--dtype`` change it), the median of ``--samples`` runs
by time, its payload the JAX row's keys plus the device.  The JAX rows
and their names:

- ``ours_{variant}_{block_q}_512``, the forward: the JAX tool times nine
  (three variants × three ``block_q``), each another TPU program.  On
  Hopper all nine are one kernel (the CUDA kernels choose their own 64 ×
  64 tiles, and every variant runs the one forward kernel), so one row,
  ``ours_loop_256_512``, is timed, and ``same_kernel_as`` names the eight
  it stands for;
- ``stock_tuned_1024_512`` and ``stock_grad_1024_512``: SDPA forward and
  grad (dq + dk + dv of the sum), SDPA takes no block sizes, so
  ``stock_default_shape_512`` and ``stock_grad_512_512`` stand for them;
- ``xla_full_matrix``: the port's full-matrix ``attention_reference``;
- ``ours_grad_loop_256_512``: the forward re-run, dq and dk/dv.

``vs_tuned_stock`` and ``vs_tuned_stock_grad`` are time ratios, SDPA's
over ours (above 1: ours is faster); the two grad rows charge different
FLOPs (``harness.attention_flops``), so their TFLOP/s do not compare.
``best_forward_config`` is the timed forward row.

A row that fails is recorded with its error and the tool exits 1 (the
JAX tool records it and exits 0; a failed kernel is not hidden here).
The report goes to ``--out`` (default ``tmp/bench_attention.json``),
never to the JAX tool's ``BENCH_ATTENTION.json``.  Runs on ``cuda``
unless ``--device cpu``; without a card it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import subprocess
import sys

from . import checked_out

__all__ = ["FORWARD_NAMES", "ROWS", "SAME_KERNEL", "run_bench", "main"]

#: the JAX tool's nine forward candidates
FORWARD_NAMES = tuple(f"ours_{v}_{bq}_512" for v in ("loop", "pipelined",
                                                      "kvgrid")
                      for bq in (256, 512, 1024))

#: the rows timed, by their JAX names, and their config fields
ROWS = {
    "ours_loop_256_512": dict(impl="flash", block_q=256, block_k=512,
                              variant="loop"),
    "stock_tuned_1024_512": dict(impl="stock", block_q=1024, block_k=512),
    "xla_full_matrix": dict(impl="reference"),
    "ours_grad_loop_256_512": dict(impl="flash", block_q=256, block_k=512,
                                   mode="grad", variant="loop"),
    "stock_grad_1024_512": dict(impl="stock", block_q=1024, block_k=512,
                                mode="grad"),
}

#: each JAX row name that is not timed, and the timed row that is its
#: launch on Hopper
SAME_KERNEL = {
    **{name: "ours_loop_256_512" for name in FORWARD_NAMES
       if name != "ours_loop_256_512"},
    "stock_default_shape_512": "stock_tuned_1024_512",
    "stock_grad_512_512": "stock_grad_1024_512",
}


def _smi(dev) -> str | None:
    if dev.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def run_bench(cfg, samples: int, log=print) -> tuple[dict, bool]:
    """Every row of :data:`ROWS` at ``cfg``'s geometry, the median of
    ``samples`` runs each: ``(doc, ok)``, ``ok`` False when a row raised
    (its entry then holds the error)."""
    from ..bench.harness import run_attention_bench
    from ..device import chip_peak_tflops, resolve_device
    from ..utils.buildstamp import artifact_meta

    dev = resolve_device(cfg.device)
    entries, ok = {}, True
    for name, kw in ROWS.items():
        try:
            reps = sorted((run_attention_bench(dataclasses.replace(cfg, **kw))
                           for _ in range(samples)),
                          key=lambda r: r.per_call_s)
            entries[name] = reps[len(reps) // 2].payload()
        except Exception as e:  # noqa: BLE001 — recorded, and exit 1
            ok = False
            entries[name] = {"error": f"{type(e).__name__}: {e}"[:300]}
        row = entries[name]
        log(f"{name}: " + (f"{row['per_call_s'] * 1e3:.4f} ms, "
                           f"{row['tflops']:.2f} TFLOP/s"
                           if "error" not in row else f"FAILED {row['error']}"))

    def ratio(stock: str, ours: str):
        s, o = entries[stock].get("per_call_s"), entries[ours].get("per_call_s")
        return s / o if s and o else None

    doc = {
        "build": artifact_meta(),
        "description": (
            f"Causal {cfg.dtype} attention A/B (B={cfg.batch} "
            f"T={cfg.seq_len} H={cfg.heads} D={cfg.head_dim}): the port's "
            "flash kernels, torch's scaled_dot_product_attention (stock) "
            "and the full-matrix reference; each timed launch after an L2 "
            "flush and a head start (utils.timing.time_launches), the "
            "median of the samples by time"),
        "date": datetime.date.today().isoformat(),
        "device": str(dev),
        "device_name": entries[next(iter(ROWS))].get("device_name"),
        "nvidia_smi": _smi(dev),
        "chip_peak_tflops": chip_peak_tflops(cfg.dtype, dev),
        "samples_per_config": samples,
        "best_forward_config": "ours_loop_256_512",
        "same_kernel_as": SAME_KERNEL,
        "vs_tuned_stock": ratio("stock_tuned_1024_512", "ours_loop_256_512"),
        "vs_tuned_stock_grad": ratio("stock_grad_1024_512",
                                     "ours_grad_loop_256_512"),
        "entries": entries,
        "ok": ok,
    }
    return doc, ok


def main(argv=None) -> int:
    from ..bench.harness import AttentionBenchConfig

    ap = argparse.ArgumentParser(prog="flextree_tpu_torch.tools.bench_attention",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("tmp", "bench_attention.json"))
    ap.add_argument("--samples", type=int, default=3,
                    help="runs a row; the median by time is reported")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=AttentionBenchConfig.batch)
    ap.add_argument("--seq-len", type=int, default=AttentionBenchConfig.seq_len)
    ap.add_argument("--heads", type=int, default=AttentionBenchConfig.heads)
    ap.add_argument("--head-dim", type=int,
                    default=AttentionBenchConfig.head_dim)
    ap.add_argument("--dtype", default=AttentionBenchConfig.dtype)
    args = ap.parse_args(argv)
    out = checked_out(ap, args.out)
    cfg = AttentionBenchConfig(batch=args.batch, seq_len=args.seq_len,
                               heads=args.heads, head_dim=args.head_dim,
                               dtype=args.dtype, device=args.device)
    doc, ok = run_bench(cfg, args.samples,
                        log=lambda msg: print(msg, flush=True))
    with open(out, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    print(json.dumps({k: doc[k] for k in ("ok", "device_name",
                                          "best_forward_config",
                                          "vs_tuned_stock",
                                          "vs_tuned_stock_grad")}))
    print(f"wrote {out}")
    if not ok:
        print("a row failed; see its entry in " + out, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
