"""Memory roofline of the fold kernel, the allreduce's local reduce.

    python -m flextree_tpu_torch.tools.roofline_reduce [--sweep-tiles]
        [--length L] [--device cuda|cpu] [--out PATH]

The port's copy of the JAX package's ``tools/roofline_reduce.py``.  The
local reduction is the allreduce's only compute, and it is bound by
memory: folding W sources of L elements reads W·L and writes L, so a
row's traffic is ``(W+1)·L·itemsize``.  For W in {2, 4, 8} and float32
and bfloat16 the fold kernel (``ops/reduce_stacked.py``) is timed by
``bench.harness.run_reduce_bench`` (each launch after an L2 flush and a
head start, CUDA events, the median), held bitwise to its plain version
at every ``sources_tile``, and reported as GB/s against the card's
data-sheet memory rate (``frac_of_peak``) and against the copy kernel's
measured ceiling (``frac_of_copy_ceiling``, kernel 7,
``bench.harness.hbm_copy``, reading and writing L float32).
``torch.sum(x, 0)`` at W=8 float32 is the library row, in the place of
the JAX tool's ``xla_fused_sum_w8`` (``torch_sum_w8_GBps``).

``--sweep-tiles`` times each row at ``sources_tile`` in {1, 2, 4}, a
value that does not divide W skipped (the kernel clamps it to the gcd,
``ops/reduce_stacked.py``), and keeps the fastest, as the JAX tool does.
The JAX tool also sweeps ``rows_tile``, a TPU block knob: the CUDA fold
has none, so each row's ``rows_tile`` is None and nothing is swept.
CUDA events time the launch alone, so every row is ``kernel_isolated``
(the JAX tool subtracts a kernel-free chain to get there).

The report goes to ``--out`` (default ``tmp/roofline_reduce.json``),
never to the JAX tool's ``BENCH_REDUCE_ROOFLINE.json``; a fold that
differs from its plain version exits non-zero.  Runs on ``cuda`` unless
``--device cpu``; without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess

import torch

from . import checked_out

__all__ = ["WIDTHS", "DTYPES", "copy_ceiling", "run_roofline", "main"]

WIDTHS = (2, 4, 8)
DTYPES = ("float32", "bfloat16")
SWEEP = (1, 2, 4)


def copy_ceiling(length: int, dev, repeat: int = 20) -> float:
    """GB/s of the copy kernel over ``length`` float32 (read L, write L):
    the practical streaming ceiling the fold is judged against.  The copy
    must equal its input bitwise."""
    from ..bench.harness import hbm_copy
    from ..utils.timing import l2_flush, time_launches

    x = torch.randn(length, generator=torch.Generator(dev).manual_seed(0),
                    device=dev)
    if not torch.equal(hbm_copy(x), x):
        raise AssertionError("the copy kernel's output differs from its input")
    ms = time_launches(lambda: hbm_copy(x), repeat, l2_flush(dev))
    return 2 * length * 4 / ms / 1e6


def run_roofline(length: int, sweep_tiles: bool, device=None,
                 widths=WIDTHS, repeat: int = 20, log=print) -> dict:
    """The JAX tool's report: the copy ceiling, the library row and one
    row a (W, dtype), each with the JAX row's keys (plus the fold's
    ``bitwise_vs_plain`` and, per ``sources_tile``, ``tiles``)."""
    from ..bench.harness import ReduceBenchConfig, run_reduce_bench
    from ..device import memory_rate, resolve_device
    from ..utils.buildstamp import artifact_meta

    dev = resolve_device(device)
    rate = memory_rate(dev)
    peak = rate / 1e9 if rate else None
    copy_gbps = copy_ceiling(length, dev, repeat)
    rows, torch_sum_w8 = [], None
    for w in widths:
        for dtype in DTYPES:
            bench = run_reduce_bench(ReduceBenchConfig(
                shapes=((w, length),), dtype=dtype, repeat=repeat,
                device=str(dev), sources_tiles=SWEEP if sweep_tiles else (1,)))
            tiles = bench["rows"]
            if w == 8 and dtype == "float32":
                torch_sum_w8 = tiles[0]["library_GBps"]
            best = min(tiles, key=lambda r: r["ms"])
            gbps = best["GBps"]
            rows.append({
                "w": w, "dtype": dtype, "length": length,
                "rows_tile": None, "sources_tile": best["sources_tile"],
                "per_call_ms": best["ms"], "achieved_GBps": gbps,
                "frac_of_peak": gbps / peak if peak else None,
                "frac_of_copy_ceiling": gbps / copy_gbps,
                "kernel_isolated": True,
                "bitwise_vs_plain": all(t["bitwise_vs_plain"] for t in tiles),
                "library_GBps": tiles[0]["library_GBps"],
                "tiles": {t["sources_tile"]: {"ms": t["ms"], "GBps": t["GBps"],
                                              "plain_ms": t["plain_ms"]}
                          for t in tiles},
            })
            log(f"w={w} {dtype} (sources_tile={best['sources_tile']}): "
                f"{gbps:.1f} GB/s"
                + (f" ({gbps / peak * 100:.1f}% of peak)" if peak else "")
                + f" ({gbps / copy_gbps * 100:.1f}% of copy ceiling); "
                + ", ".join(f"st={t['sources_tile']} {t['GBps']:.1f}"
                            for t in tiles))
    smi = None
    if dev.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    return {
        "description": "the fold kernel (the allreduce's local reduce) "
                       "against the card's memory rate and the copy "
                       "kernel's ceiling",
        "build": artifact_meta(),
        "device": str(dev),
        "device_kind": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "nvidia_smi": smi,
        "peak_hbm_GBps": peak,
        "measured_copy_ceiling_GBps": copy_gbps,
        "torch_sum_w8_GBps": torch_sum_w8,
        "traffic_model": "(W+1) * L * itemsize a call; each launch timed "
                         "alone by CUDA events after an L2 flush",
        "rows_tile_note": "a TPU block knob; the CUDA fold has none",
        "results": rows,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="flextree_tpu_torch.tools.roofline_reduce",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("tmp", "roofline_reduce.json"))
    ap.add_argument("--length", type=int, default=1 << 25)  # 128 MB f32
    ap.add_argument("--sweep-tiles", action="store_true",
                    help="also sweep sources_tile per row and keep the best")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = checked_out(ap, args.out)
    doc = run_roofline(args.length, args.sweep_tiles, args.device,
                       log=lambda msg: print(msg, flush=True))
    with open(out, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    print(f"copy ceiling: {doc['measured_copy_ceiling_GBps']:.1f} GB/s; "
          f"torch.sum w=8: {doc['torch_sum_w8_GBps']} GB/s")
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
