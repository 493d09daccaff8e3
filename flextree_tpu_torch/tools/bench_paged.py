"""Fused paged decode and on-demand admission A/B.

    python -m flextree_tpu_torch.tools.bench_paged [--smoke] [--seed N]
        [--width flagship|jax|tiny] [--device cuda|cpu] [--out PATH]

The port's copy of the JAX package's ``tools/bench_paged.py``, with its
four floors, machine-checked (a non-zero exit on any violation):

1. **Fused-round floor**: the fused decode round (the paged-attention
   kernel, ``ops.paged_attention``) runs at least 1.15x faster than the
   gather round (every sequence's K/V gathered into a contiguous view)
   over the real round states of the serving workload: every (tables,
   lengths, tokens) state a gather engine's run produced is replayed,
   both paths in turns on each state, each keeping its best.  Timing
   floors are enforced on the full run only (``--smoke`` reports them);
   correctness floors always are.
2. **Tolerance floor**: on every replayed round the fused logits match
   the gather oracle's within ``LOGITS_ATOL``, and poisoning the null
   block leaves the fused logits of the active rows bitwise unchanged.
3. **On-demand concurrency floor**: at equal pool memory, on-demand
   admission keeps at least 1.3x the mean resident sequences of
   reservation admission, on a pool small enough to bind reservation.
4. **Preemption floor**: the on-demand pool is too small for its
   traffic: at least one preemption must fire, every request must
   finish exactly once, and every output must equal the contiguous-cache
   ``models/generate.py::generate`` bitwise, for both ``preempt="swap"``
   and ``"recompute"`` (``serving/batcher.py``).

``--width jax`` is the JAX tool's model (vocab 256, d_model 256, 8
heads, 4 layers, d_ff 1024); ``flagship`` (the default) the port's
flagship; ``tiny`` a narrow model for the CPU tests; all in float32, as
the JAX tool runs.  The report (the JAX keys, plus ``device`` and the
card's name and power limit) goes to ``--out`` (default
``tmp/bench_paged.json``), never to the JAX tool's ``BENCH_PAGED.json``.
Runs on ``cuda`` unless ``--device cpu``; without a card it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import platform
import sys
import time

import numpy as np
import torch

from ..device import resolve_device
from ..models.generate import generate
from ..models.transformer import TransformerConfig, init_params
from ..ops.paged_attention import FUSED_DECODE_ATOL
from ..serving import (
    NULL_BLOCK,
    BatcherConfig,
    PagedCacheConfig,
    Request,
    ServingEngine,
    init_pools,
    paged_decode_step,
)
from . import checked_out
from .bench_serving import WIDTHS, _device_line

__all__ = ["MIN_FUSED_SPEEDUP", "MIN_CONCURRENCY_GAIN", "LOGITS_ATOL",
           "build_workload", "capture_round_states", "run_round_replay",
           "run_admission_ab", "run_bench", "main"]

MIN_FUSED_SPEEDUP = 1.15  # acceptance floor: gather round / fused round
MIN_CONCURRENCY_GAIN = 1.3  # on-demand vs reservation mean residency
PROMPT_LENS = (4, 8, 12, 16)
OUT_LENS = (4, 8, 16, 64)
OUT_PROBS = (0.35, 0.25, 0.25, 0.15)
SLOTS = 8

_now = time.monotonic

LOGITS_ATOL = FUSED_DECODE_ATOL * 10  # logits sit 2 matmuls past attention


def _model(width: str, dev, seed: int = 0):
    cfg = TransformerConfig(**WIDTHS[width], dtype=torch.float32)
    return cfg, init_params(cfg, torch.Generator().manual_seed(seed),
                            device=dev)


def _pcfg():
    # the JAX tool's serving config: 80 allocatable blocks, max_len 80
    return PagedCacheConfig(num_blocks=81, block_size=8, blocks_per_seq=10)


def build_workload(seed: int, n: int) -> list:
    """The JAX tool's requests: prompts over :data:`PROMPT_LENS` and
    outputs over :data:`OUT_LENS` with :data:`OUT_PROBS`, from ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = int(rng.choice(PROMPT_LENS))
        m = int(rng.choice(OUT_LENS, p=OUT_PROBS))
        out.append(Request(rid=i,
                           prompt=rng.integers(0, 256, (t,)).astype(np.int32),
                           max_new_tokens=m))
    return out


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _warm(eng, pcfg, requests) -> None:
    eng.warmup(sorted({r.prompt_len for r in requests}),
               {pcfg.blocks_for(r.prompt_len + r.max_new_tokens)
                for r in requests})


# ----------------------------------------------- fused vs gather round replay


def capture_round_states(cfg, params, pcfg, requests, dev) -> list:
    """Run the workload through a gather-oracle engine and record every
    decode round's (tables, lengths, tokens): the states whose cost the
    fused path claims to cut."""
    states = []
    eng = ServingEngine(params, cfg, pcfg, BatcherConfig(slots=SLOTS),
                        fused=False, device=dev)
    _warm(eng, pcfg, requests)
    inner = eng._decode

    def recording(p, pools, tables, lengths, tokens):
        states.append((tables.clone(), lengths.clone(), tokens.clone()))
        return inner(p, pools, tables, lengths, tokens)

    eng._decode = recording  # after warmup: only real rounds are captured
    for r in requests:
        if not eng.submit(r):
            raise RuntimeError(f"request {r.rid} rejected at submit")
    eng.run_until_idle()
    return states


def _rand_pools(cfg, pcfg, dev, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    pools = init_pools(cfg, pcfg, dev)
    return {kind: [torch.from_numpy(rng.standard_normal(tuple(p.shape))
                                    .astype(np.float32)).to(dev, cfg.dtype)
                   for p in pools[kind]] for kind in ("k", "v")}


def _clone(pools) -> dict:
    return {kind: [p.clone() for p in pools[kind]] for kind in ("k", "v")}


def run_round_replay(cfg, params, pcfg, states, reps: int, dev) -> dict:
    """Both decode paths over every captured state: the tolerance and the
    poisoned null block on each, then each state timed in turns (gather,
    fused) ``reps`` times, each path keeping its best.  ``fused_calls``
    counts the fused rounds run (each launches the kernel once a layer
    on a card)."""
    def step(pools, state, fused):
        tables, lengths, tokens = state
        return paged_decode_step(params, pools, tables, lengths, tokens, cfg,
                                 fused=fused)

    # correctness: every state on fresh copies of one set of pools (the
    # step writes the new K/V in place), a poisoned copy on the fused path
    pools = _rand_pools(cfg, pcfg, dev)
    poisoned = _clone(pools)
    for kind in ("k", "v"):
        for p in poisoned[kind]:
            p[NULL_BLOCK] = 1e30
    tol = poison = fused_calls = 0
    max_abs = 0.0
    for state in states:
        ref = step(_clone(pools), state, False)
        out = step(_clone(pools), state, True)
        out_p = step(_clone(poisoned), state, True)
        fused_calls += 2
        diff = (out - ref).abs().max().item()
        max_abs = max(max_abs, diff)
        if not diff <= LOGITS_ATOL:  # also NaN
            tol += 1
        active = state[1] > 0
        if bool(active.any()) and not torch.equal(out[active], out_p[active]):
            poison += 1

    # paired timing: for every state the two paths run back to back, and
    # each keeps its per-state best, so a stretch of host contention lands
    # on one (state, rep) pair and never on one whole side
    po_g = _rand_pools(cfg, pcfg, dev, seed=1)
    po_f = _rand_pools(cfg, pcfg, dev, seed=1)
    step(po_g, states[0], False)
    step(po_f, states[0], True)
    fused_calls += 1
    _sync(dev)
    g = f = 0.0
    frontier: dict = {}
    bs = pcfg.block_size
    for state in states:
        best_g = best_f = float("inf")
        for _ in range(reps):
            t0 = _now()
            step(po_g, state, False)
            _sync(dev)
            best_g = min(best_g, _now() - t0)
            t0 = _now()
            step(po_f, state, True)
            _sync(dev)
            best_f = min(best_f, _now() - t0)
            fused_calls += 1
        g += best_g
        f += best_f
        fr = int((int(state[1].max()) + bs - 1) // bs)
        agg = frontier.setdefault(fr, [0.0, 0.0, 0])
        agg[0] += best_g
        agg[1] += best_f
        agg[2] += 1
    return {
        "rounds_replayed": len(states),
        "reps": reps,
        "gather_round_ms": round(g / len(states) * 1e3, 4),
        "fused_round_ms": round(f / len(states) * 1e3, 4),
        "fused_speedup": round(g / f, 4),
        "per_frontier": {
            str(fr): {"rounds": c, "gather_ms": round(gg / c * 1e3, 3),
                      "fused_ms": round(ff / c * 1e3, 3),
                      "speedup": round(gg / ff, 3)}
            for fr, (gg, ff, c) in sorted(frontier.items())
        },
        "fused_max_abs_diff": max_abs,
        "logits_atol": LOGITS_ATOL,
        "tolerance_violations": tol,
        "poison_violations": poison,
        "fused_calls": fused_calls,
    }


# --------------------------------------------- on-demand vs reserve residency


def run_admission_ab(cfg, params, pcfg, requests, admission: str, dev,
                     preempt: str = "swap") -> dict:
    """One closed-batch run (everything submitted up front: residency is
    under test, not arrivals) on the fused engine: mean and peak resident
    sequences, completion accounting, the ``generate`` oracle bitwise.
    ``fused_rounds`` counts its decode rounds, warmup's included."""

    eng = ServingEngine(params, cfg, pcfg,
                        BatcherConfig(slots=SLOTS, admission=admission,
                                      preempt=preempt), device=dev)
    _warm(eng, pcfg, requests)
    for r in requests:
        if not eng.submit(r):
            raise RuntimeError(f"request {r.rid} rejected at submit")
    t0 = _now()
    residency = []
    while not eng.idle:
        eng.step()
        residency.append(eng.batcher.num_active)
    _sync(dev)
    makespan = _now() - t0
    # trailing rounds of a draining tail pull both sides' means down
    # alike; keep only rounds with resident work
    busy = [r for r in residency if r > 0]
    snap = eng.metrics.snapshot()["counters"]
    oracle_violations = 0
    for r in requests:
        want = generate(params, torch.as_tensor(r.prompt, dtype=torch.long,
                                                device=dev)[None],
                        cfg, max_new_tokens=r.max_new_tokens,
                        max_len=pcfg.max_len)[0].cpu().numpy()
        got = eng.completed.get(r.rid)
        if got is None or not np.array_equal(got.tokens, want):
            oracle_violations += 1
    return {
        "admission": admission,
        "preempt": preempt,
        "submitted": len(requests),
        "completed": len(eng.completed),
        "completed_unique": len(set(eng.completed)),
        "mean_concurrency": round(float(np.mean(busy)), 3) if busy else 0.0,
        "peak_concurrency": int(max(busy)) if busy else 0,
        "preempts": int(snap.get("serve.preempts", 0)),
        "resumes": int(snap.get("serve.resumes", 0)),
        "swap_outs": int(snap.get("serve.swap_outs", 0)),
        "admit_blocked": int(snap.get("serve.admit_blocked", 0)),
        "oracle_violations": oracle_violations,
        "makespan_s": round(makespan, 3),
        "blocks_leaked": (pcfg.num_blocks - 1) - eng.batcher.allocator.num_free,
        "fused_rounds": eng.decode_steps + 1,
    }


# -------------------------------------------------------------------- main


def run_bench(*, smoke: bool, seed: int = 0, width: str = "flagship",
              device=None, log=print) -> dict:
    """The whole A/B and its floors (the JAX tool's ``main``)."""

    dev = resolve_device(device)
    t_start = _now()
    n = 16 if smoke else 48
    reps = 2 if smoke else 3
    cfg, params = _model(width, dev)
    pcfg = _pcfg()
    requests = build_workload(seed, n)

    log(f"replaying decode rounds: {n} requests through the gather engine "
        f"at slots={SLOTS}, pool={pcfg.num_blocks - 1} blocks; {width} "
        f"width on {dev}")
    states = capture_round_states(cfg, params, pcfg, requests, dev)
    replay = run_round_replay(cfg, params, pcfg, states, reps, dev)
    log(f"fused round: {replay['fused_round_ms']} ms vs gather "
        f"{replay['gather_round_ms']} ms = {replay['fused_speedup']}x "
        f"(max |dlogits| {replay['fused_max_abs_diff']:.2e})")

    # the admission A/B pool: small enough that reservation is pool-bound
    # (ceil((prompt + max) / bs) ~ 8-10 blocks x 8 slots needs ~70; 36
    # admits ~4) while on-demand stays slot-bound, equal pool memory on
    # both sides, and tight enough to exhaust the on-demand run's pool
    ab_pcfg = PagedCacheConfig(num_blocks=37, block_size=8, blocks_per_seq=10)
    ab_requests = [dataclasses.replace(r, max_new_tokens=max(r.max_new_tokens,
                                                             32))
                   for r in requests]
    reserve = run_admission_ab(cfg, params, ab_pcfg, ab_requests, "reserve",
                               dev)
    log(f"reserve:  mean {reserve['mean_concurrency']} / peak "
        f"{reserve['peak_concurrency']} resident, "
        f"{reserve['completed']}/{reserve['submitted']} done")
    ondemand = run_admission_ab(cfg, params, ab_pcfg, ab_requests, "ondemand",
                                dev)
    log(f"ondemand: mean {ondemand['mean_concurrency']} / peak "
        f"{ondemand['peak_concurrency']} resident, {ondemand['preempts']} "
        f"preempts, {ondemand['completed']}/{ondemand['submitted']} done")
    recompute = run_admission_ab(cfg, params, ab_pcfg,
                                 ab_requests[: max(8, n // 3)], "ondemand",
                                 dev, preempt="recompute")
    log(f"recompute scenario: {recompute['preempts']} preempts, "
        f"{recompute['oracle_violations']} oracle violations")

    gain = (ondemand["mean_concurrency"] / reserve["mean_concurrency"]
            if reserve["mean_concurrency"] else 0.0)
    peak_gain = (ondemand["peak_concurrency"] / reserve["peak_concurrency"]
                 if reserve["peak_concurrency"] else 0.0)

    def scenario_ok(s, need_preempt):
        return (s["completed"] == s["completed_unique"] == s["submitted"]
                and s["oracle_violations"] == 0 and s["blocks_leaked"] == 0
                and (s["preempts"] >= 1 or not need_preempt))

    enforce_timing = not smoke
    floors = {
        "fused_speedup": replay["fused_speedup"],
        "min_fused_speedup": MIN_FUSED_SPEEDUP,
        "timing_floors_enforced": enforce_timing,
        "fused_speedup_ok": (replay["fused_speedup"] >= MIN_FUSED_SPEEDUP
                             if enforce_timing else True),
        "tolerance_violations": replay["tolerance_violations"],
        "poison_violations": replay["poison_violations"],
        "fused_correct_ok": (replay["tolerance_violations"] == 0
                             and replay["poison_violations"] == 0),
        "ondemand_concurrency_gain": round(gain, 3),
        "ondemand_peak_gain": round(peak_gain, 3),
        "min_concurrency_gain": MIN_CONCURRENCY_GAIN,
        "concurrency_ok": gain >= MIN_CONCURRENCY_GAIN,
        "preempt_swap_ok": scenario_ok(ondemand, need_preempt=True),
        "preempt_recompute_ok": scenario_ok(recompute, need_preempt=True),
        "reserve_baseline_ok": scenario_ok(reserve, need_preempt=False),
    }
    ok = bool(floors["fused_speedup_ok"] and floors["fused_correct_ok"]
              and floors["concurrency_ok"] and floors["preempt_swap_ok"]
              and floors["preempt_recompute_ok"]
              and floors["reserve_baseline_ok"])
    return {
        "bench": "paged_fused_decode_and_ondemand_admission",
        "smoke": bool(smoke),
        "host": {"platform": platform.platform(),
                 "python": sys.version.split()[0],
                 "torch": torch.__version__, "backend": dev.type},
        "device": _device_line(dev),
        "config": {
            "model": f"v{cfg.vocab_size}_d{cfg.d_model}_h{cfg.n_heads}"
                     f"_L{cfg.n_layers}_ff{cfg.d_ff}_f32",
            "width": width,
            "replay_cache": dataclasses.asdict(pcfg),
            "admission_ab_cache": dataclasses.asdict(ab_pcfg),
            "slots": SLOTS,
            "n_requests": n,
            "seed": seed,
            "protocol": "real-run round replay, paired best-of timing, "
                        "tolerance and poison on every round",
        },
        "round_replay": replay,
        "admission_reserve": reserve,
        "admission_ondemand": ondemand,
        "preempt_recompute": recompute,
        "floors": floors,
        "ok": ok,
        # rounds run on the fused path (the kernel once a layer on a card)
        "fused_rounds": (replay["fused_calls"] + reserve["fused_rounds"]
                         + ondemand["fused_rounds"]
                         + recompute["fused_rounds"]),
        "elapsed_s": round(_now() - t_start, 1),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="flextree_tpu_torch.tools.bench_paged",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("tmp", "bench_paged.json"))
    ap.add_argument("--smoke", action="store_true",
                    help="small workload; timing floors reported, not "
                    "enforced")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--width", choices=sorted(WIDTHS), default="flagship")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = checked_out(ap, args.out)
    doc = run_bench(smoke=args.smoke, seed=args.seed, width=args.width,
                    device=args.device, log=lambda m: print(m, flush=True))
    with open(out, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    print(json.dumps({"ok": doc["ok"],
                      "fused_speedup": doc["floors"]["fused_speedup"],
                      "ondemand_concurrency_gain":
                          doc["floors"]["ondemand_concurrency_gain"]}))
    if not doc["ok"]:
        print("MACHINE-CHECK FAILED; see floors in " + out, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
