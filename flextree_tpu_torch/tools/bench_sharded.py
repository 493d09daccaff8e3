"""ZeRO-1 sharded-optimizer A/B: the split collectives and the sharded
step against the replicated float32 step, across a real process boundary.

    python -m flextree_tpu_torch.tools.bench_sharded [--quick]
        [--device cuda|cpu] [--out PATH]

The port's copy of the JAX package's ``tools/bench_sharded.py``, on a
world of :data:`NUM_PROCESSES` processes of one rank each
(``parallel/launch.py``: ``spawn``, ``init_distributed``, gloo over
loopback TCP; on a card each rank's CUDA tensors are staged through host
memory for gloo, the folds run on the card):

1. **Wire bytes (the acceptance floor)**: each rank's bytes of one train
   step of each variant, counted by the transports
   (``parallel/allreduce.py``: ``counting_wire``), where the JAX tool
   counts them from the lowered program
   (``analysis.hlo_lint.collective_wire_bytes``).  Floor: the int8
   sharded step moves at most :data:`MAX_WIRE_RATIO` x the replicated
   f32 step's bytes; the f32 sharded step exactly 1.0 x (the seam
   relocates the all-gather, it does not remove it).
2. **In-run bitwise**: the f32 sharded step's parameters after several
   steps are bitwise the replicated step's, on the live world.
3. **Per-rank optimizer-state bytes**, from the live tensors, about 1/N
   of the replicated layout (replicated tails make it a hair above), and
   the analytic ``parallel/zero.py::zero_shard_bytes`` beside it.
4. **Sync wall-clock**: the split sync round (grad reduce-scatter and
   param all-gather, both int8) against the fused f32 allreduce at 2^20
   and 2^22 float32 a rank (2^18 with ``--quick``), shuffled rounds.
   Floor: int8 at least :data:`MIN_INT8_SYNC_SPEEDUP` x at the largest
   size (full run only).
5. **Step time**: the three steps timed; no-regression guards (f32 at
   most :data:`MAX_STEP_SLOWDOWN_F32` x, int8 :data:`MAX_STEP_SLOWDOWN_INT8`
   x the replicated step; full run only).

The model is the JAX tool's (vocab 2048, d_model 128, 4 heads, 4
layers, d_ff 512, float32) on the CPU and the flagship width computing
as the flagship does (bfloat16, the flash kernels) on a card.  Any
violation exits 1.  The report (the JAX keys) goes to ``--out`` (default
``tmp/bench_sharded.json``), never to ``BENCH_SHARDED.json``.  Runs on
``cuda`` unless ``--device cpu``; without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time

from . import FLAGSHIP, checked_out
from .bench_quantize import _child_device, _sync

__all__ = ["NUM_PROCESSES", "SYNC_SIZES", "QUICK_SYNC_SIZES",
           "MAX_WIRE_RATIO", "MIN_INT8_SYNC_SPEEDUP",
           "MAX_STEP_SLOWDOWN_F32", "MAX_STEP_SLOWDOWN_INT8", "WIDTHS",
           "model_config", "wire_violations", "step_wire", "child_main",
           "run_cluster", "run_bench", "main"]

NUM_PROCESSES = 2
SYNC_SIZES = (1 << 20, 1 << 22)  # f32 elements a rank: 4 MB, 16 MB
QUICK_SYNC_SIZES = (1 << 18,)
MAX_WIRE_RATIO = 0.6  # acceptance floor: sharded-int8 vs replicated-f32 bytes
MIN_INT8_SYNC_SPEEDUP = 1.3  # largest bucket, real wire
#: step-time NO-REGRESSION guards, not wins (the JAX tool's): the
#: sharded step pays the block-interleaved bucket pack/unpack and int8
#: its encode/decode on the device that runs the model
MAX_STEP_SLOWDOWN_F32 = 2.2
MAX_STEP_SLOWDOWN_INT8 = 3.0

#: the model: the JAX tool's on the CPU, the flagship's widths on a card
WIDTHS = {
    "jax": dict(vocab_size=2048, d_model=128, n_heads=4, n_layers=4,
                d_ff=512),
    "flagship": dict(FLAGSHIP),
}
TOKEN_VOCAB = 2048  # the JAX tool's token ids
LOCAL_BATCH, SEQ = 2, 64


def model_config(device: str, widths=None):
    """The step's model on ``device``: the flagship widths in bfloat16 on
    the flash kernels on a card, the JAX tool's model in float32 on the
    CPU; ``widths`` replaces the widths (a test's tiny model)."""
    import torch

    from ..models.transformer import TransformerConfig

    if torch.device(device).type == "cuda":
        return TransformerConfig(**(widths or WIDTHS["flagship"]),
                                 dtype=torch.bfloat16, attn_impl="flash")
    return TransformerConfig(**(widths or WIDTHS["jax"]))


def _tokens(n: int, vocab: int):
    """The JAX tool's batch: every rank's local rows from seed 0 (ids
    under :data:`TOKEN_VOCAB`, or a smaller model's ``vocab``), so the
    global batch is those rows repeated a rank."""
    import numpy as np

    local = np.random.default_rng(0).integers(
        0, min(TOKEN_VOCAB, vocab), (LOCAL_BATCH, SEQ)).astype(np.int32)
    return np.concatenate([local] * n)


def wire_violations(ratio_int8: float, ratio_f32: float) -> list:
    """The wire floors: the int8 sharded step at most
    :data:`MAX_WIRE_RATIO` x the replicated f32 step's bytes, the f32
    sharded step exactly 1.0 x."""
    out = []
    if ratio_int8 > MAX_WIRE_RATIO:
        out.append(
            f"sharded-int8 wire bytes = {ratio_int8:.3f}x "
            f"replicated f32 > required {MAX_WIRE_RATIO}x"
        )
    if abs(ratio_f32 - 1.0) > 1e-6:
        out.append(
            f"sharded-f32 wire ratio {ratio_f32:.6f} != 1.0 "
            f"(the seam must relocate bytes, not change them)"
        )
    return out


def step_wire(step, state, toks, sync=lambda: None) -> tuple:
    """``(new state, the wire's read)`` of one train step: the
    transports' messages and bytes a rank (``counting_wire``)."""
    from ..parallel.allreduce import counting_wire

    with counting_wire() as w:
        state, _ = step(state, toks, toks)
        sync()
    return state, w.read()


def _tensor_bytes(tree) -> int:
    from ..parallel.train import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def child_main(rank: int, world: int, sync_sizes, repeat: int, steps_n: int,
               device: str, widths=None) -> dict:
    """One rank of the world (``launch.spawn`` runs it)."""
    import random

    import numpy as np
    import torch
    import torch.distributed as dist

    from ..models.transformer import param_specs
    from ..ops import flash_attention as fa
    from ..ops.reduce_stacked import reduce_sources
    from ..parallel.allreduce import all_gather, allreduce, reduce_scatter
    from ..parallel.train import (
        TrainConfig,
        init_train_state,
        make_train_step,
        tree_leaves,
        zero_layout_for,
    )
    from ..parallel.zero import zero_shard_bytes

    dev = _child_device(device)
    group = dist.group.WORLD
    n = world
    topo = str(n)
    kernels = {"flash_fwd": fa.flash_fwd, "flash_bwd_dq": fa.flash_bwd_dq,
               "flash_bwd_dkv": fa.flash_bwd_dkv,
               "reduce_sources": reduce_sources}
    for fn in kernels.values():
        fn.launches = 0

    # ---- 1+2+3+5: the train steps over the (dp=n) world ---------------
    model_cfg = model_config(device, widths)
    variants = {
        "replicated_f32": TrainConfig(grad_topo=topo),
        "sharded_f32": TrainConfig(grad_topo=topo, shard_optimizer=True),
        "sharded_int8": TrainConfig(
            grad_topo=topo, shard_optimizer=True, codec="int8"
        ),
    }
    toks = torch.as_tensor(_tokens(n, model_cfg.vocab_size), device=dev)
    steps, states = {}, {}
    for name, tc in variants.items():
        states[name] = init_train_state(
            model_cfg, torch.Generator().manual_seed(0), tc, device=dev,
            comm=group)
        steps[name] = make_train_step(model_cfg, tc, device=dev, comm=group)

    # each variant's steps; the first one's wire bytes from the counters
    wire, messages, outs = {}, {}, {}
    for name in variants:
        st = states[name]
        for i in range(steps_n):
            st, got = step_wire(steps[name], st, toks, lambda: _sync(dev))
            if i == 0:
                wire[name] = got["bytes"].get(rank, 0)
                messages[name] = got["messages"].get(rank, 0)
        outs[name] = st
    wire_ratio_int8 = wire["sharded_int8"] / wire["replicated_f32"]
    wire_ratio_f32 = wire["sharded_f32"] / wire["replicated_f32"]

    # per-rank optimizer-state bytes from the live post-step tensors
    def opt_bytes(name):
        st = outs[name]
        keys = (("mu", "nu") if name == "replicated_f32" else
                tuple(k for k in st if k.startswith(("mu_", "nu_",
                                                     "master_"))))
        return sum(_tensor_bytes(st[k]) for k in keys)

    opt = {name: opt_bytes(name) for name in variants}
    layout = zero_layout_for(group, outs["replicated_f32"]["params"],
                             param_specs(model_cfg))
    analytic = {name: zero_shard_bytes(layout, variants[name].codec != "f32")
                for name in ("sharded_f32", "sharded_int8")}

    def params_bytes_of(name):
        return b"".join(t.detach().cpu().numpy().tobytes()
                        for t in tree_leaves(outs[name]["params"]))

    bitwise = params_bytes_of("sharded_f32") == params_bytes_of(
        "replicated_f32")

    times = {k: [] for k in variants}
    order = list(variants)
    shuf = random.Random(0)
    fresh = {k: states[k] for k in variants}
    for _ in range(repeat):
        shuf.shuffle(order)
        for k in order:
            _sync(dev)
            t0 = time.perf_counter()
            steps[k](fresh[k], toks, toks)
            _sync(dev)
            times[k].append(time.perf_counter() - t0)
    step_rows = {
        k: {"min_ms": min(ts) * 1e3, "avg_ms": sum(ts) / len(ts) * 1e3}
        for k, ts in times.items()
    }
    del outs, states, fresh

    # ---- 4: the sync round alone, on grad-sized flat buffers ----------
    sync_rows = {}
    for size in sync_sizes:
        local = torch.from_numpy(np.random.default_rng(1000 + rank)
                                 .standard_normal(size).astype(np.float32)
                                 ).to(dev)
        fns = {
            "fused_f32": lambda v: allreduce(v, None, topo=topo),
            "sharded_f32": lambda v: all_gather(
                reduce_scatter(v, None, topo=topo), None, topo=topo,
                out_shape=v.shape),
            "sharded_int8": lambda v: all_gather(
                reduce_scatter(v, None, topo=topo, codec="int8", step=0),
                None, topo=topo, out_shape=v.shape, codec="int8", step=0),
        }
        for fn in fns.values():
            fn(local)
        _sync(dev)
        t = {k: [] for k in fns}
        order2 = list(fns)
        for _ in range(repeat):
            shuf.shuffle(order2)
            for k in order2:
                _sync(dev)
                t0 = time.perf_counter()
                fns[k](local)
                _sync(dev)
                t[k].append(time.perf_counter() - t0)
        rows = {
            k: {"min_ms": min(ts) * 1e3, "avg_ms": sum(ts) / len(ts) * 1e3}
            for k, ts in t.items()
        }
        for k in ("sharded_f32", "sharded_int8"):
            rows[k]["vs_fused_f32"] = (rows["fused_f32"]["min_ms"]
                                       / rows[k]["min_ms"])
        sync_rows[str(size * 4)] = rows
    return {
        "wire_bytes": {k: {"total": v} for k, v in wire.items()},
        "wire_messages": messages,
        "wire_ratio_int8": wire_ratio_int8,
        "wire_ratio_f32": wire_ratio_f32,
        "opt_state_bytes": opt,
        "opt_state_analytic": analytic,
        "bitwise_f32": bool(bitwise),
        "step_rows": step_rows,
        "sync_rows": sync_rows,
        "n": n,
        "batch": [LOCAL_BATCH * n, SEQ],
        "launches": {name: fn.launches for name, fn in kernels.items()},
    }


def run_cluster(sync_sizes, repeat, steps_n, device: str, widths=None,
                timeout_s: float = 1800.0, log=print) -> dict:
    """The world; rank 0's result, with every rank's launches."""
    from ..parallel.launch import spawn

    got = spawn(child_main, NUM_PROCESSES,
                (tuple(sync_sizes), repeat, steps_n, device, widths),
                timeout=timeout_s)
    res = dict(got[0])
    res["launches"] = [g["launches"] for g in got]
    res["wire_bytes_by_rank"] = [
        {k: v["total"] for k, v in g["wire_bytes"].items()} for g in got]
    for key, rows in res["sync_rows"].items():
        log(f"[sharded x-proc] {int(key) >> 20}MB/rank sync: " + " ".join(
            f"{k}={rows[k]['min_ms']:.1f}ms" for k in rows))
    return res


def run_bench(*, quick: bool, device=None, widths=None, sync_sizes=None,
              repeat=None, steps_n=None, log=print) -> dict:
    """The world's rows, the checks and the report (the JAX tool's
    ``main``); ``widths``, ``sync_sizes``, ``repeat`` and ``steps_n``
    shrink it for tests."""
    import torch

    from ..device import resolve_device

    device = str(resolve_device(device))
    sync_sizes = sync_sizes or (QUICK_SYNC_SIZES if quick else SYNC_SIZES)
    repeat = repeat or (4 if quick else 8)
    steps_n = steps_n or (2 if quick else 3)
    t0 = time.time()
    log(f"== sharded A/B ({NUM_PROCESSES}-proc gloo world on {device}) ...")
    res = run_cluster(sync_sizes, repeat, steps_n, device, widths, log=log)
    n = res["n"]

    violations = []
    if not res["bitwise_f32"]:
        violations.append("f32 sharded step NOT bitwise-equal to replicated")
    violations += wire_violations(res["wire_ratio_int8"],
                                  res["wire_ratio_f32"])
    opt_ratio = (
        res["opt_state_bytes"]["sharded_f32"]
        / res["opt_state_bytes"]["replicated_f32"]
    )
    # tails stay replicated, so the measured ratio sits a hair above 1/N
    if not (1.0 / n - 0.02 <= opt_ratio <= 1.0 / n + 0.10):
        violations.append(
            f"per-rank optimizer-state ratio {opt_ratio:.3f} not ~ 1/{n}"
        )
    for name, want in res["opt_state_analytic"].items():
        if res["opt_state_bytes"][name] != want["sharded_bytes_per_rank"]:
            violations.append(
                f"{name} live optimizer-state bytes "
                f"{res['opt_state_bytes'][name]} != zero_shard_bytes "
                f"{want['sharded_bytes_per_rank']}")
    largest = str(max(sync_sizes) * 4)
    int8_sync = res["sync_rows"][largest]["sharded_int8"]["vs_fused_f32"]
    if int8_sync < MIN_INT8_SYNC_SPEEDUP and not quick:
        violations.append(
            f"int8 sharded sync at largest bucket = {int8_sync:.2f}x "
            f"< required {MIN_INT8_SYNC_SPEEDUP}x vs fused f32"
        )
    step_ratio = (
        res["step_rows"]["sharded_int8"]["min_ms"]
        / res["step_rows"]["replicated_f32"]["min_ms"]
    )
    step_ratio_f32 = (
        res["step_rows"]["sharded_f32"]["min_ms"]
        / res["step_rows"]["replicated_f32"]["min_ms"]
    )
    if step_ratio_f32 > MAX_STEP_SLOWDOWN_F32 and not quick:
        violations.append(
            f"sharded-f32 step {step_ratio_f32:.2f}x replicated f32 step "
            f"> allowed {MAX_STEP_SLOWDOWN_F32}x"
        )
    if step_ratio > MAX_STEP_SLOWDOWN_INT8 and not quick:
        violations.append(
            f"sharded-int8 step {step_ratio:.2f}x replicated f32 step "
            f"> allowed {MAX_STEP_SLOWDOWN_INT8}x"
        )

    from .bench_serving import _device_line

    cfg = model_config(device, widths)
    doc = {
        "description": "ZeRO-1 sharded-optimizer A/B: split FlexTree "
                       "collectives + sharded AdamW vs the replicated "
                       "fused f32 baseline on a real 2-process gloo/TCP "
                       "wire",
        "protocol": {
            "cluster": f"{NUM_PROCESSES} processes x 1 rank on {device}, "
                       "parallel/launch.py spawn + init_distributed + "
                       "gloo; every collective byte crosses a process "
                       "boundary",
            "wire_bytes": "each rank's bytes of one step, counted by the "
                          "transports (parallel/allreduce.py "
                          "counting_wire: every message's buffer); the "
                          "loss's all_gather, 4 B a rank, is no transport "
                          "message",
            "memory": "per-rank optimizer-state bytes measured from the "
                      "live tensors of the moment (and master) entries, "
                      "beside zero_shard_bytes",
            "timing": "shuffled-interleaved reps, min-of-reps (shared "
                      "shuffle seed so ranks stay matched), each call "
                      "timed to the device's end",
            "checks": f"sharded-int8 step wire <= {MAX_WIRE_RATIO}x "
                      f"replicated f32 (and sharded-f32 EXACTLY 1.0x); f32 "
                      f"sharded step bitwise == replicated in-run; per-rank "
                      f"optimizer state ~ 1/N and == zero_shard_bytes; "
                      f"int8 sharded sync >= {MIN_INT8_SYNC_SPEEDUP}x fused "
                      f"f32 at the largest bucket; step-time no-regression "
                      f"guards (f32 <= {MAX_STEP_SLOWDOWN_F32}x, int8 <= "
                      f"{MAX_STEP_SLOWDOWN_INT8}x); the timing floors in "
                      f"the full run only; non-zero exit on any violation",
        },
        "host": {"platform": platform.platform(), "cpus": os.cpu_count(),
                 "torch": torch.__version__},
        "device": _device_line(torch.device(device)),
        "model": f"dense v{cfg.vocab_size} d{cfg.d_model} h{cfg.n_heads} "
                 f"L{cfg.n_layers} ff{cfg.d_ff} {str(cfg.dtype)[6:]} "
                 f"{cfg.attn_impl}",
        "wire_bytes": res["wire_bytes"],
        "wire_bytes_by_rank": res["wire_bytes_by_rank"],
        "wire_messages": res["wire_messages"],
        "opt_state_bytes": res["opt_state_bytes"],
        "opt_state_analytic": res["opt_state_analytic"],
        "step_rows": res["step_rows"],
        "sync_rows": res["sync_rows"],
        "headline": {
            "wire_ratio_int8_vs_replicated_f32": round(res["wire_ratio_int8"],
                                                       3),
            "wire_ratio_f32_vs_replicated_f32": round(res["wire_ratio_f32"],
                                                      6),
            "opt_state_ratio": round(opt_ratio, 4),
            "bitwise_f32_in_run": res["bitwise_f32"],
            "int8_sync_vs_fused_f32_at_largest": round(int8_sync, 3),
            "step_time_ratio_f32": round(step_ratio_f32, 3),
            "step_time_ratio_int8": round(step_ratio, 3),
        },
        "violations": violations,
        "batch": res["batch"],
        "launches": res["launches"],
        "elapsed_s": round(time.time() - t0, 1),
    }
    doc["diagnosis"] = (
        f"On a real 2-process gloo wire the quantized ZeRO-1 step moves "
        f"{res['wire_ratio_int8']:.2f}x the collective bytes of the "
        f"replicated fused f32 step (f32 sharding alone is exactly 1.0x — "
        f"the seam relocates the allgather from gradients to parameters, "
        f"it does not remove it; the codec is what shrinks BOTH phases), "
        f"holds {opt_ratio:.2f}x the per-rank optimizer-state bytes "
        f"(~1/{n}: mu/nu shards + replicated <N tails), and the int8 "
        f"sharded sync runs {int8_sync:.2f}x the fused f32 allreduce's "
        f"speed at the largest bucket. Step-time ratios (f32 "
        f"{step_ratio_f32:.2f}x, int8 {step_ratio:.2f}x) are "
        f"no-regression checks, not the win.")
    return doc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="flextree_tpu_torch.tools.bench_sharded",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("tmp",
                                                  "bench_sharded.json"))
    ap.add_argument("--quick", action="store_true")
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
    print(f"checks passed: wire {h['wire_ratio_int8_vs_replicated_f32']:.3f}x"
          f" <= {MAX_WIRE_RATIO}, opt-state {h['opt_state_ratio']:.3f} ~ "
          f"1/{NUM_PROCESSES}, f32 bitwise, int8 sync "
          f"{h['int8_sync_vs_fused_f32_at_largest']:.2f}x")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
