"""Backward/comm overlap A/B: the readiness-ordered sync against its
serialized twin, across a real process boundary.

    python -m flextree_tpu_torch.tools.bench_overlap [--quick]
        [--device cuda|cpu] [--out PATH]

The port's copy of the JAX package's ``tools/bench_overlap.py``:

1. **Cross-process rows (the headline)**: a world of
   :data:`NUM_PROCESSES` processes of one rank each
   (``parallel/launch.py``: ``spawn``, ``init_distributed``, gloo over
   loopback TCP), each process pinned to a core of its own with
   ``os.sched_setaffinity`` where the host has two or more (the JAX
   tool's ``taskset``; the cores used are recorded).  Rows time the train
   step (``parallel/train.py::make_train_step``) under four configs:
   ``no_sync`` (``bench/harness.py::make_nosync_train_step``, the
   exposure baseline), ``ours_fused``, ``ours_overlap_serialized`` (the
   ``serialize_overlap=True`` twin: the same buckets after the whole
   backward) and ``ours_overlapped``, in shuffled rounds (a shared seed)
   and timing blocks; the statistic is the median of per-round paired
   exposures (step - no_sync) over each block's quiet half, and the
   headline the best eligible block (both exposures at least
   :data:`MIN_MEASURABLE_MS`).
2. **Checks**: the exposed comm cut at least :data:`MIN_EXPOSED_REDUCTION`
   x by overlap against the twin (full run only); the updated parameters
   bitwise equal across fused, serialized and overlapped; the overlapped
   and serialized steps send EQUAL message counts, counted by the
   transports (``parallel/allreduce.py``: ``counting_wire``), where the
   JAX tool counts collectives in the lowered programs; at least two
   planned buckets.
3. **In-process rows**: the same A/B on the 8-rank in-process mesh
   (``run_train_step_bench(overlap=True)``): reported, not gated.

The boundaries are self-calibrated in the children, as the JAX tool's: the
link from two measured allreduces on the live wire, the backward's
GFLOP/s from the warmed ``no_sync`` step, rank 0's taken by every rank
(:func:`agreed`: two ranks that plan different buckets send collectives
that do not match), written with
``planner/calibrate.py::save_calibration`` to a temporary file named by
``FLEXTREE_CALIBRATION``, where the step's planner
(``parallel/overlap.py::plan_overlap``) reads it.  The model is the JAX
tool's (vocab 512, d_model 256, 8 heads, 6 layers, d_ff 1024, float32)
on the CPU and the flagship widths at that depth computing as the
flagship does (bfloat16, the flash kernels) on a card.  Any violation
exits 1.  The report (the JAX keys) goes to ``--out`` (default
``tmp/bench_overlap.json``), never to ``BENCH_OVERLAP.json``.  Runs on
``cuda`` unless ``--device cpu``; without a card it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import platform
import sys
import tempfile
import time

from . import FLAGSHIP, checked_out
from .bench_quantize import _child_device, _sync

__all__ = ["NUM_PROCESSES", "MIN_EXPOSED_REDUCTION", "MIN_MEASURABLE_MS",
           "WIDTHS", "model_config", "agreed", "child_main", "run_cluster",
           "run_in_process", "score", "run_bench", "main"]

NUM_PROCESSES = 2
MIN_EXPOSED_REDUCTION = 1.3  # the acceptance floor
#: a block is headline-ELIGIBLE only when both exposures are measurably
#: positive: a paired median that crossed zero is noise
MIN_MEASURABLE_MS = 1.0

#: the headline model: the JAX tool's on the CPU, the flagship's widths
#: at its depth on a card
WIDTHS = {
    "jax": dict(vocab_size=512, d_model=256, n_heads=8, n_layers=6,
                d_ff=1024),
    "flagship": dict(FLAGSHIP, n_layers=6),
}
LOCAL_BATCH = 2
SEQ = 64
TOKEN_VOCAB = 512  # the JAX tool's token ids


def model_config(device: str, widths=None):
    """The step's model on ``device`` (see the module docstring)."""
    import torch

    from ..models.transformer import TransformerConfig

    if torch.device(device).type == "cuda":
        return TransformerConfig(**(widths or WIDTHS["flagship"]),
                                 dtype=torch.bfloat16, attn_impl="flash")
    return TransformerConfig(**(widths or WIDTHS["jax"]))


def _measure_wire(dev) -> tuple[float, float]:
    """(bandwidth_GBps, latency_us) of the live cross-process wire from
    two measured allreduce sizes (slope/intercept), min of reps."""
    import numpy as np
    import torch

    from ..parallel.allreduce import allreduce

    def timed(size, reps=9):
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.standard_normal(size).astype(
            np.float32)).to(dev)
        allreduce(x, None, topo=str(NUM_PROCESSES))
        _sync(dev)
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            allreduce(x, None, topo=str(NUM_PROCESSES))
            _sync(dev)
            ts.append(time.perf_counter() - t0)
        return min(ts)

    s_small, s_big = 1 << 14, 1 << 20  # 64 KB, 4 MB
    t_small, t_big = timed(s_small), timed(s_big)
    # an N-rank allreduce moves ~2*(N-1)/N*S bytes a rank; slope gives bw
    bytes_small = 2 * (NUM_PROCESSES - 1) / NUM_PROCESSES * s_small * 4
    bytes_big = 2 * (NUM_PROCESSES - 1) / NUM_PROCESSES * s_big * 4
    dt = max(t_big - t_small, 1e-6)
    bw_GBps = (bytes_big - bytes_small) / dt / 1e9
    latency_us = max(t_small * 1e6 - bytes_small / (bw_GBps * 1e3), 1.0)
    return max(bw_GBps, 0.01), latency_us


def agreed(*values) -> list:
    """Rank 0's ``values`` on every rank of the default process group."""
    import torch.distributed as dist

    got = list(values)
    dist.broadcast_object_list(got, src=0)
    return got


def child_main(rank: int, world: int, rounds: int, n_blocks: int,
               device: str, cores, widths=None) -> dict:
    """One rank of the world (``launch.spawn`` runs it), pinned to
    ``cores[rank]`` when ``cores`` is given."""
    import random

    import numpy as np
    import torch
    import torch.distributed as dist

    if cores:
        os.sched_setaffinity(0, {cores[rank]})
    from ..bench.harness import make_nosync_train_step
    from ..models.transformer import param_specs
    from ..ops import flash_attention as fa
    from ..ops.reduce_stacked import reduce_sources
    from ..parallel.allreduce import counting_wire
    from ..parallel.overlap import plan_overlap
    from ..parallel.train import (
        AXIS_NAMES,
        TrainConfig,
        init_train_state,
        make_train_step,
        tree_leaves,
    )
    from ..planner.calibrate import backend_fingerprint, save_calibration
    from ..planner.cost_model import LinkParams, TpuCostParams
    from ..schedule.stages import Topology

    dev = _child_device(device)
    group = dist.group.WORLD
    kernels = {"flash_fwd": fa.flash_fwd, "flash_bwd_dq": fa.flash_bwd_dq,
               "flash_bwd_dkv": fa.flash_bwd_dkv,
               "reduce_sources": reduce_sources}
    model_cfg = model_config(device, widths)
    tc = TrainConfig()
    state = init_train_state(model_cfg, torch.Generator().manual_seed(0),
                             device=dev)
    n_param_bytes = sum(t.numel() * 4 for t in tree_leaves(state["params"]))
    rng = np.random.default_rng(1)
    b_global = NUM_PROCESSES * LOCAL_BATCH
    toks = torch.as_tensor(rng.integers(
        0, min(TOKEN_VOCAB, model_cfg.vocab_size),
        (b_global, SEQ)).astype(np.int32), device=dev)
    tgts = toks

    # --- self-calibration for the boundary equalizer -------------------
    bw_GBps, latency_us = _measure_wire(dev)
    nosync = make_nosync_train_step(model_cfg, tc, device=dev, comm=group)
    nosync(state, toks, tgts)
    ts = []
    for _ in range(5):
        _sync(dev)
        t0 = time.perf_counter()
        nosync(state, toks, tgts)
        _sync(dev)
        ts.append(time.perf_counter() - t0)
    nosync_s = min(ts)  # capability estimate, like the wire constants
    tokens_local = LOCAL_BATCH * SEQ
    est_flops = 4.0 * n_param_bytes / 4 * tokens_local
    bwd_GFLOPs = max(est_flops / nosync_s / 1e9, 0.5)
    # every rank plans its buckets from these constants, so every rank
    # takes rank 0's: two ranks' own measurements can plan different
    # buckets, and then their collectives do not match
    bw_GBps, latency_us, bwd_GFLOPs = agreed(bw_GBps, latency_us,
                                             bwd_GFLOPs)
    link = LinkParams(bandwidth_GBps=bw_GBps, latency_us=latency_us)
    cost_params = TpuCostParams(
        ici=link, dcn=link, reduce_bw_GBps=4.2,
        control_us_per_width=0.0, launch_us=26.0, bwd_GFLOPs=bwd_GFLOPs,
    )
    calib_dir = tempfile.mkdtemp(prefix="ft_overlap_calib_")
    calib_path = os.path.join(calib_dir, "calib.json")
    save_calibration(
        calib_path, cost_params, backend=dev.type,
        fingerprint=backend_fingerprint(),
        meta={"protocol": "bench_overlap in-child self-calibration"},
    )
    os.environ["FLEXTREE_CALIBRATION"] = calib_path
    os.environ["FLEXTREE_CALIBRATION_BACKEND"] = dev.type

    # --- the plan the overlapped step uses (for the report) ------------
    plan = plan_overlap(
        state["params"], param_specs(model_cfg), AXIS_NAMES,
        {"dp": Topology.flat(NUM_PROCESSES), "sp": None, "tp": None},
        {"dp": NUM_PROCESSES, "sp": 1, "tp": 1},
        n_tokens=tokens_local, t_local=SEQ, d_model=model_cfg.d_model,
        cost_params=cost_params,
    )

    tc_ovl = TrainConfig(overlap=True)
    steps = {
        "no_sync": nosync,
        "ours_fused": make_train_step(model_cfg, tc, device=dev, comm=group),
        "ours_overlap_serialized": make_train_step(
            model_cfg, tc_ovl, device=dev, comm=group,
            serialize_overlap=True),
        "ours_overlapped": make_train_step(model_cfg, tc_ovl, device=dev,
                                           comm=group),
    }
    for fn in kernels.values():
        fn.launches = 0
    outs, counts = {}, {}
    for name, fn in steps.items():
        with counting_wire() as w:
            outs[name] = fn(state, toks, tgts)
            _sync(dev)
        got = w.read()
        counts[name] = {"messages": got["messages"].get(rank, 0),
                        "bytes": got["bytes"].get(rank, 0)}

    def leaf_bytes(tree):
        return [t.detach().cpu().numpy().tobytes() for t in tree_leaves(tree)]

    ref = leaf_bytes(outs["ours_fused"][0]["params"])
    bitwise = {
        name: leaf_bytes(outs[name][0]["params"]) == ref
        for name in ("ours_overlap_serialized", "ours_overlapped")
    }
    del outs

    # --- shuffled-interleaved rounds, paired per-round exposures -------
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    blocks = []
    order = list(steps)
    shuf = random.Random(0)  # shared seed: both ranks run one order
    for _ in range(n_blocks):
        times = {k: [] for k in steps}
        for _ in range(rounds):
            shuf.shuffle(order)
            for k in order:
                _sync(dev)
                t0 = time.perf_counter()
                steps[k](state, toks, tgts)
                _sync(dev)
                times[k].append(time.perf_counter() - t0)
        # quiet-half selection by the 4-variant round total (symmetric in
        # the compared variants); the full per-round ledger is kept
        totals = [sum(times[name][i] for name in steps)
                  for i in range(rounds)]
        keep = sorted(range(rounds),
                      key=lambda i: totals[i])[: max(rounds // 2, 4)]
        keep.sort()
        exposed = {
            name: [(times[name][i] - times["no_sync"][i]) * 1e3
                   for i in keep]
            for name in steps if name != "no_sync"
        }
        exposed_all = {
            name: [(times[name][i] - times["no_sync"][i]) * 1e3
                   for i in range(rounds)]
            for name in steps if name != "no_sync"
        }
        blocks.append({
            "rounds": rounds,
            "rounds_scored": len(keep),
            "quiet_rounds": keep,
            "step_ms": {k: {"min": round(min(ts) * 1e3, 3),
                            "med": round(med(ts) * 1e3, 3)}
                        for k, ts in times.items()},
            "exposed_med_ms": {k: round(med(v), 3)
                               for k, v in exposed.items()},
            "exposed_med_all_rounds_ms": {k: round(med(v), 3)
                                          for k, v in exposed_all.items()},
            "paired_rounds_ms": {k: [round(x, 2) for x in v]
                                 for k, v in exposed_all.items()},
        })
    os.remove(calib_path)
    os.rmdir(calib_dir)
    return {
        "param_mb": round(n_param_bytes / 2**20, 2),
        "tokens_per_rank": tokens_local,
        "calibration": {
            "wire_bandwidth_GBps": round(bw_GBps, 4),
            "wire_latency_us": round(latency_us, 1),
            "bwd_GFLOPs": round(bwd_GFLOPs, 2),
        },
        # the constants the step's planner read, unrounded
        "cost_params": dataclasses.asdict(cost_params),
        "plan": {
            "labels": list(plan.labels),
            "boundaries": [list(b) for b in plan.boundaries],
            "n_buckets": plan.n_buckets,
            "predicted_exposed_us": round(plan.predicted_exposed_us, 1),
        },
        "blocks": blocks,
        "bitwise": bitwise,
        "collective_counts": {k: counts[k] for k in (
            "ours_overlapped", "ours_overlap_serialized")},
        "wire_by_step": counts,
        "cores": sorted(os.sched_getaffinity(0)),
        "batch": [b_global, SEQ],
        "launches": {name: fn.launches for name, fn in kernels.items()},
    }


def run_cluster(rounds: int, n_blocks: int, device: str, widths=None,
                timeout_s: float = 2400.0) -> dict:
    """The world, pinned where the host has the cores; rank 0's result
    with each rank's cores, counts and launches."""
    from ..parallel.launch import spawn

    avail = sorted(os.sched_getaffinity(0))
    cores = avail[:NUM_PROCESSES] if len(avail) >= NUM_PROCESSES else None
    got = spawn(child_main, NUM_PROCESSES,
                (rounds, n_blocks, device, cores, widths), timeout=timeout_s)
    doc = dict(got[0])
    doc["pinned"] = cores is not None
    doc["cores_by_rank"] = [g["cores"] for g in got]
    doc["collective_counts_by_rank"] = [g["collective_counts"] for g in got]
    doc["plan_by_rank"] = [g["plan"]["boundaries"] for g in got]
    doc["launches"] = [g["launches"] for g in got]
    return doc


def run_in_process(quick: bool, device: str, model=None) -> dict:
    """The in-process rows: the same A/B on the 8-rank mesh, where a
    message is a device copy on the device that runs the backward."""
    import torch

    from ..bench.harness import TrainStepBenchConfig, run_train_step_bench

    if model is None:
        model = ({k: v for k, v in WIDTHS["flagship"].items()
                  if k != "n_layers"}
                 if torch.device(device).type == "cuda" else {})
    out = run_train_step_bench(TrainStepBenchConfig(
        n_layers=2 if quick else 6, repeat=5 if quick else 12,
        supervised=False, overlap=True, device=device, **model))
    keep = ("train_step_ms", "exposed_comm_ms", "hidden_comm_ms",
            "exposed_vs_serialized")
    return {
        "rows": {name: {k: round(v, 3) for k, v in row.items() if k in keep}
                 for name, row in out["rows"].items()},
        "identical": out["identical"],
    }


def score(xproc: dict, quick: bool) -> tuple:
    """``(violations, headline)`` of the world's result: the JAX tool's
    block selection and checks."""
    def block_ratio(b):
        e = b["exposed_med_ms"]
        return e["ours_overlap_serialized"] / e["ours_overlapped"]

    def eligible(b):
        e = b["exposed_med_ms"]
        return (e["ours_overlapped"] >= MIN_MEASURABLE_MS
                and e["ours_overlap_serialized"] >= MIN_MEASURABLE_MS)

    ratios = [round(block_ratio(b), 3) if eligible(b) else None
              for b in xproc["blocks"]]
    eligible_is = [i for i, r in enumerate(ratios) if r is not None]
    violations = []
    if eligible_is:
        best_i = max(eligible_is, key=lambda i: ratios[i])
        best = xproc["blocks"][best_i]
        exp_ser = best["exposed_med_ms"]["ours_overlap_serialized"]
        exp_ovl = best["exposed_med_ms"]["ours_overlapped"]
        reduction = ratios[best_i]
    else:
        best_i, exp_ser, exp_ovl, reduction = -1, 0.0, 0.0, 0.0
        if not quick:
            violations.append(
                "no block had measurably-positive exposures on both sides "
                f"(>= {MIN_MEASURABLE_MS} ms): nothing to headline")
    if not quick and eligible_is and reduction < MIN_EXPOSED_REDUCTION:
        violations.append(
            f"exposed-comm reduction {reduction:.2f}x < required "
            f"{MIN_EXPOSED_REDUCTION}x in every eligible block (ratios "
            f"{ratios}; best: serialized {exp_ser:.1f} ms vs overlapped "
            f"{exp_ovl:.1f} ms)")
    for name, ok in xproc["bitwise"].items():
        if not ok:
            violations.append(f"{name} params NOT bitwise-equal to "
                              f"ours_fused")
    for r, cc in enumerate(xproc["collective_counts_by_rank"]):
        co = cc["ours_overlapped"]["messages"]
        cs = cc["ours_overlap_serialized"]["messages"]
        if co != cs:
            violations.append(f"rank {r}: collective counts differ: "
                              f"overlapped {co} vs serialized {cs} messages")
    if any(p != xproc["plan"]["boundaries"]
           for p in xproc.get("plan_by_rank", ())):
        violations.append(f"the ranks planned different buckets: "
                          f"{xproc['plan_by_rank']}")
    if xproc["plan"]["n_buckets"] < 2:
        violations.append("overlap plan degenerated to a single bucket: "
                          "nothing fires mid-backward")
    headline = {
        "exposed_serialized_ms": exp_ser,
        "exposed_overlapped_ms": exp_ovl,
        "exposed_comm_reduction": round(reduction, 3),
        "hidden_fraction": round(max(1.0 - exp_ovl / exp_ser, 0.0), 3)
        if exp_ser > 0 else 0.0,
        "block": best_i,
        "block_ratios": ratios,
        "note": "capability measurement: best of the eligible timing "
                "blocks (all retained above)",
    }
    return violations, headline


def run_bench(*, quick: bool, device=None, widths=None, rounds=None,
              n_blocks=None, inproc_model=None, log=print) -> dict:
    """The world's rows, the in-process rows, the checks and the report
    (the JAX tool's ``main``); ``widths``, ``rounds``, ``n_blocks`` and
    ``inproc_model`` shrink it for tests.  The eligibility of a block
    gates only the full run: ``--quick`` keeps every correctness check
    and records the timing."""
    import torch

    from ..device import resolve_device

    device = str(resolve_device(device))
    rounds = rounds or (8 if quick else 16)
    n_blocks = n_blocks or (2 if quick else 6)
    t0 = time.time()
    log(f"== cross-process rows ({NUM_PROCESSES}-proc pinned gloo world on "
        f"{device}, {n_blocks} blocks x {rounds} rounds) ...")
    xproc = run_cluster(rounds, n_blocks, device, widths)
    for i, b in enumerate(xproc["blocks"]):
        e = b["exposed_med_ms"]
        log(f"[block {i}] exposed ser {e['ours_overlap_serialized']:.2f} "
            f"ovl {e['ours_overlapped']:.2f}")
    log("== in-process rows (8 ranks, one process) ...")
    inproc = run_in_process(quick, device, inproc_model)
    violations, headline = score(xproc, quick)

    from .bench_serving import _device_line

    cfg = model_config(device, widths)
    doc = {
        "description": "Readiness-ordered backward/comm overlap vs the "
                       "serialized fused sync: make_train_step under "
                       "TrainConfig(overlap=) on a real 2-process gloo/TCP "
                       "wire; exposed comm = step-time delta over the "
                       "sync-free twin, medians of per-round paired deltas",
        "protocol": {
            "cross_process": f"{NUM_PROCESSES} processes x 1 rank on "
                             f"{device}, each pinned to its own core "
                             "(os.sched_setaffinity) where the host has "
                             "two, parallel/launch.py spawn + "
                             "init_distributed + gloo; shuffled-interleaved "
                             "rounds with a shared shuffle seed; exposure "
                             "paired per-round against no_sync, median over "
                             "the quiet half of rounds (ranked by 4-variant "
                             "round total); full per-round ledger retained",
            "comparator": "ours_overlap_serialized = the overlapped step "
                          "with every bucket's sync after the whole "
                          "backward (make_train_step(serialize_overlap="
                          "True)): equal message counts (counted by the "
                          "transports), bitwise-equal params",
            "checks": f"exposed(serialized)/exposed(overlapped) >= "
                      f"{MIN_EXPOSED_REDUCTION} (full run); bitwise "
                      f"identity; message-count equality; >= 2 planned "
                      f"buckets; non-zero exit on any violation",
        },
        "host": {"platform": platform.platform(), "cpus": os.cpu_count(),
                 "torch": torch.__version__},
        "device": _device_line(torch.device(device)),
        "model": f"dense v{cfg.vocab_size} d{cfg.d_model} h{cfg.n_heads} "
                 f"L{cfg.n_layers} ff{cfg.d_ff} {str(cfg.dtype)[6:]} "
                 f"{cfg.attn_impl}",
        "cross_process": xproc,
        "in_process": inproc,
        "headline": headline,
        "violations": violations,
        "elapsed_s": round(time.time() - t0, 1),
    }
    doc["diagnosis"] = (
        f"On a real 2-process TCP wire, firing each gradient bucket's "
        f"collective as its grads are produced (readiness order, "
        f"{xproc['plan']['n_buckets']} planner-equalized buckets over "
        f"{len(xproc['plan']['labels'])} backward segments) leaves "
        f"{headline['exposed_overlapped_ms']:.1f} ms of sync exposed vs "
        f"{headline['exposed_serialized_ms']:.1f} ms for the same buckets "
        f"serialized after the whole backward — "
        f"{headline['exposed_comm_reduction']:.2f}x less exposed comm at "
        f"equal message counts and bitwise-equal updates. Block ratios "
        f"this run were {headline['block_ratios']}. In-process (8 ranks, "
        f"one process) a message is a device copy on the device that runs "
        f"the backward, so there is nothing to hide behind.")
    return doc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="flextree_tpu_torch.tools.bench_overlap",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("tmp",
                                                  "bench_overlap.json"))
    ap.add_argument("--quick", action="store_true",
                    help="fewer rounds / smaller in-process model (smoke)")
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
    print(f"checks passed: exposed comm {h['exposed_comm_reduction']:.2f}x "
          f"(floor {MIN_EXPOSED_REDUCTION}x "
          f"{'not ' if args.quick else ''}enforced), bitwise identity, "
          f"equal message counts")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
