"""Serving A/B bench: continuous batching + paged KV cache vs static
batching under an open-loop synthetic load, and the replica pool's
degrade path.

The port's copy of the JAX package's ``tools/bench_serving.py``, with its
three floors, machine-checked (non-zero exit on a violation):

1. **Throughput floor**: the continuous batcher serves >= 1.3x the
   static batcher's token throughput on the SAME open-loop arrival
   schedule (Poisson arrivals, mixed prompt/output lengths).  The static
   baseline is the industry default — fixed batch size, prompts
   right-padded to the configured maximum, every batch decoded until its
   slowest member finishes, arrivals queued at the batch barrier — with
   per-row ragged lengths (``prefill_ragged``) so its outputs are still
   each request's own continuation.  Enforced outside ``--smoke``.
2. **Bitwise floor**: every checked request served by the continuous
   engine (paged cache, ragged joins, shared pool) produced exactly the
   tokens ``generate`` (contiguous cache, request alone) produces, on the
   engine's gather path (``fused=False``), checked on the real load
   run's outputs.
3. **Degrade floor**: a 2-replica pool with one replica killed mid-run
   (hang + heartbeat stop — the watchdog/lease path) finishes every
   submitted request on the survivor, with at least one re-routed.

Usage::

    python -m flextree_tpu_torch.tools.bench_serving [--smoke] [--seed N]
        [--width flagship|jax|tiny] [--device cuda|cpu] [--out PATH]

``--width flagship`` (the default) is the port's flagship model (vocab
8192, d_model 512, 8 heads, 4 layers, d_ff 2048); ``jax`` is the JAX
bench's own 256-wide model; ``tiny`` is a narrow model for the CPU tests.
All run in float32, as the JAX bench does.  The report goes to ``--out``
(default ``tmp/bench_serving.json`` under the repo root, where the
repo's tools keep their work files), never to the JAX bench's
``BENCH_SERVING.json``.  Runs on ``cuda`` unless ``--device cpu``;
without a card it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import platform
import subprocess
import sys
import tempfile
import time
from collections import deque

import numpy as np
import torch

from ..device import resolve_device
from ..models.generate import decode_step, generate, prefill_ragged
from ..models.transformer import TransformerConfig, init_params
from ..serving import (
    BatcherConfig,
    PagedCacheConfig,
    PoolConfig,
    ReplicaPool,
    Request,
    ServingEngine,
)

__all__ = [
    "MIN_THROUGHPUT_RATIO",
    "WIDTHS",
    "build_workload",
    "run_continuous",
    "run_static",
    "check_bitwise",
    "run_replica_kill",
    "run_bench",
    "main",
]

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(REPO, "tmp", "bench_serving.json")

MIN_THROUGHPUT_RATIO = 1.3  # acceptance floor: continuous vs static tok/s
PROMPT_LENS = (4, 8, 12, 16)  # the serving mix (uniform over these)
# decode-heavy, heavy-tailed outputs: the regime continuous batching
# exists for.  A static batch rides until its LONGEST member finishes, so
# its decode utilization is mean/max-of-batch, and widening the batch
# makes it worse
OUT_LENS = (4, 8, 16, 64)
OUT_PROBS = (0.35, 0.25, 0.25, 0.15)
# same decode width AND same KV memory on both sides: 8 slots / batch 8,
# 640 cache positions each (8 x max_len 80 == 80 blocks x 8)
STATIC_BATCH = 8
CONT_SLOTS = 8
PROMPT_VOCAB = 256  # prompts draw token ids below this (the JAX stream)

#: model widths by name: the flagship, the JAX bench's, a CPU-test size
WIDTHS = {
    "flagship": dict(vocab_size=8192, d_model=512, n_heads=8, n_layers=4,
                     d_ff=2048),
    "jax": dict(vocab_size=256, d_model=256, n_heads=8, n_layers=4,
                d_ff=1024),
    "tiny": dict(vocab_size=256, d_model=32, n_heads=4, n_layers=2,
                 d_ff=64),
}

_now = time.monotonic


def _model(width: str, device, seed: int = 0):
    cfg = TransformerConfig(**WIDTHS[width], dtype=torch.float32)
    return cfg, init_params(cfg, torch.Generator().manual_seed(seed),
                            device=device)


def _pcfg() -> PagedCacheConfig:
    # max_len 80 >= max prompt (16) + max out (64).  81 blocks = 1 null +
    # 80 allocatable = 640 cache positions: EXACTLY the static baseline's
    # KV memory (see the STATIC_BATCH/CONT_SLOTS note above)
    return PagedCacheConfig(num_blocks=81, block_size=8, blocks_per_seq=10)


def build_workload(seed: int, n: int, rate_rps: float) -> list:
    """Open-loop Poisson arrivals with mixed prompt/output lengths.
    ``arrival_s`` is the offset from the run start; the run loops honor
    it in real time (requests arrive whether or not the server keeps
    up — that is what open-loop means).  The JAX bench's draws, in its
    order: a seed gives its request stream."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_rps, size=n)
    arrivals = np.cumsum(gaps)
    out = []
    for i in range(n):
        t = int(rng.choice(PROMPT_LENS))
        m = int(rng.choice(OUT_LENS, p=OUT_PROBS))
        out.append(
            Request(
                rid=i,
                prompt=rng.integers(0, PROMPT_VOCAB, (t,)).astype(np.int32),
                max_new_tokens=m,
                arrival_s=float(arrivals[i]),
            )
        )
    return out


def _pct(xs, q) -> float:
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else 0.0


def _latency_summary(records) -> dict:
    ttft = [r["ttft_s"] * 1e3 for r in records]
    ptl = [r["per_token_s"] * 1e3 for r in records if r["per_token_s"] > 0]
    return {
        "ttft_ms": {f"p{q}": round(_pct(ttft, q), 2) for q in (50, 95, 99)},
        "per_token_ms": {f"p{q}": round(_pct(ptl, q), 2) for q in (50, 95, 99)},
    }


def _warm_shapes(pcfg, requests):
    return (sorted({r.prompt_len for r in requests}),
            {pcfg.blocks_for(r.prompt_len + r.max_new_tokens)
             for r in requests})


# ---------------------------------------------------------------- continuous


def run_continuous(cfg, params, pcfg, requests, slots: int, device) -> dict:
    # fused=False EXPLICITLY: this bench's floor is the BITWISE
    # paged-vs-generate gate, which only the gather path certifies — the
    # engine's default is the fused path (the CUDA paged kernel), held to
    # its plain version within a tolerance instead
    eng = ServingEngine(params, cfg, pcfg, BatcherConfig(slots=slots),
                        fused=False, device=device)
    eng.warmup(*_warm_shapes(pcfg, requests))
    pending = deque(sorted(requests, key=lambda r: r.arrival_s))
    t0 = _now()
    while pending or not eng.idle:
        now = _now() - t0
        while pending and pending[0].arrival_s <= now:
            req = pending.popleft()
            # absolute arrival stamp: TTFT includes queueing delay
            eng.submit(
                dataclasses.replace(req, arrival_s=t0 + req.arrival_s)
            )
        if eng.idle and pending:
            time.sleep(min(1e-3, pending[0].arrival_s - now))
            continue
        eng.step()
    makespan = _now() - t0
    records = [
        {
            "rid": rid,
            "ttft_s": done.ttft_s,
            "per_token_s": done.per_token_s,
            "n_tokens": done.n_tokens,
            "tokens": done.tokens.tolist(),
        }
        for rid, done in sorted(eng.completed.items())
    ]
    tokens = sum(r["n_tokens"] for r in records)
    return {
        "records": records,
        "tokens": tokens,
        "makespan_s": round(makespan, 3),
        "throughput_tok_s": round(tokens / makespan, 2),
        "decode_steps": eng.decode_steps,
        "engine_steps": eng.steps,
        **_latency_summary(records),
    }


# ------------------------------------------------------------------- static


def run_static(cfg, params, requests, batch_size: int, max_len: int,
               device) -> dict:
    """The fixed-shape static batcher: wait for ``batch_size`` arrivals
    (or queue drain), right-pad prompts to max(PROMPT_LENS), decode the
    batch until its slowest member finishes (batch-level early exit — the
    STRONGER static baseline).  One prefill and one decode of the batch's
    shapes run before the clock starts, as the engine warms."""
    dev = resolve_device(device)
    pad_t = max(PROMPT_LENS)
    max_steps = max(OUT_LENS) - 1

    def prefill(tok, lens):
        return prefill_ragged(params, torch.from_numpy(tok).to(dev).long(),
                              torch.from_numpy(lens).to(dev), cfg, max_len)

    def decode(cache, tok):
        return decode_step(params, cache, torch.from_numpy(tok).to(dev).long(),
                           cfg)

    # warm both off the clock
    wtok = np.zeros((batch_size, pad_t), np.int32)
    wlen = np.full((batch_size,), pad_t, np.int32)
    _, cache = prefill(wtok, wlen)
    decode(cache, np.zeros((batch_size,), np.int32))[0].cpu()

    pending = deque(sorted(requests, key=lambda r: r.arrival_s))
    queue: deque = deque()
    records = []
    t0 = _now()
    while pending or queue:
        now = _now() - t0
        while pending and pending[0].arrival_s <= now:
            queue.append(pending.popleft())
        if len(queue) < batch_size and pending:
            nxt = pending[0].arrival_s - (_now() - t0)
            if nxt > 0:
                time.sleep(min(1e-3, nxt))
                continue
        if not queue:
            continue
        batch = [queue.popleft() for _ in range(min(batch_size, len(queue)))]
        toks = np.zeros((batch_size, pad_t), np.int32)
        lens = np.full((batch_size,), pad_t, np.int32)
        for i, r in enumerate(batch):
            toks[i, : r.prompt_len] = r.prompt
            lens[i] = r.prompt_len
        logits, cache = prefill(toks, lens)
        logits = logits.cpu().numpy()
        t_first = _now()
        outs = [[int(np.argmax(logits[i]))] for i in range(len(batch))]
        first_s = [t_first] * len(batch)
        done_s = [t_first if r.max_new_tokens == 1 else 0.0 for r in batch]
        tok = np.asarray(
            [o[-1] for o in outs] + [0] * (batch_size - len(batch)), np.int32
        )
        for _ in range(max_steps):  # the batch barrier: everyone rides along
            if all(
                len(outs[i]) >= batch[i].max_new_tokens
                for i in range(len(batch))
            ):
                break  # batch-level early exit: slowest member done
            logits, cache = decode(cache, tok)
            logits = logits.cpu().numpy()
            t_step = _now()
            nxt = []
            for i in range(batch_size):
                if i < len(batch) and len(outs[i]) < batch[i].max_new_tokens:
                    outs[i].append(int(np.argmax(logits[i])))
                    if len(outs[i]) == batch[i].max_new_tokens:
                        done_s[i] = t_step
                nxt.append(int(np.argmax(logits[i])))
            tok = np.asarray(nxt, np.int32)
        for i, r in enumerate(batch):
            n = len(outs[i])
            records.append(
                {
                    "rid": r.rid,
                    "ttft_s": first_s[i] - (t0 + r.arrival_s),
                    "per_token_s": (
                        (done_s[i] - first_s[i]) / (n - 1) if n > 1 else 0.0
                    ),
                    "n_tokens": n,
                    "tokens": outs[i],
                }
            )
    makespan = _now() - t0
    tokens = sum(r["n_tokens"] for r in records)
    return {
        "records": records,
        "tokens": tokens,
        "makespan_s": round(makespan, 3),
        "throughput_tok_s": round(tokens / makespan, 2),
        "batch_size": batch_size,
        "pad_prompt_to": pad_t,
        "decode_steps_per_batch": max_steps,
        **_latency_summary(records),
    }


# ----------------------------------------------------------------- bitwise


def _oracle(cfg, params, req, max_len: int, device) -> np.ndarray:
    prompt = torch.as_tensor(req.prompt, dtype=torch.long,
                             device=resolve_device(device))[None]
    return generate(params, prompt, cfg, max_new_tokens=req.max_new_tokens,
                    max_len=max_len)[0].cpu().numpy()


def check_bitwise(cfg, params, pcfg, requests, records, cap: int,
                  device) -> dict:
    """The served tokens (paged cache, ragged joins, shared pool) vs the
    contiguous-cache ``generate`` oracle, request by request, bitwise."""
    by_rid = {r["rid"]: r for r in records}
    violations, checked = 0, 0
    for req in requests[:cap]:
        want = _oracle(cfg, params, req, pcfg.max_len, device)
        got = np.asarray(by_rid[req.rid]["tokens"], np.int32)
        checked += 1
        if not np.array_equal(got, want):
            violations += 1
    return {"paged_bitwise_violations": violations, "bitwise_checked": checked}


# ------------------------------------------------------------- replica kill


def run_replica_kill(cfg, params, pcfg, n_requests: int, seed: int,
                     device) -> dict:
    """2 supervised replicas, one killed mid-run (hang + heartbeat stop):
    the pool must finish every submitted request on the survivor."""
    rng = np.random.default_rng(seed)
    reqs = [
        Request(
            rid=1000 + i,
            prompt=rng.integers(
                0, PROMPT_VOCAB, (int(rng.choice(PROMPT_LENS)),)
            ).astype(np.int32),
            max_new_tokens=int(rng.choice(OUT_LENS[2:])),  # keep work in flight
        )
        for i in range(n_requests)
    ]
    engines = [
        # gather path here too: the kill scenario's oracle is bitwise
        ServingEngine(params, cfg, pcfg, BatcherConfig(slots=2), fused=False,
                      device=device)
        for _ in range(2)
    ]
    # lease long (5 s = 100 missed beats — a healthy replica in a busy
    # process must never false-positive), watchdog short: the HANG path
    # drains via strikes within ~a second; the lease only gates silent
    # heartbeat death
    with tempfile.TemporaryDirectory(prefix="ft_serving_hb_") as hb:
        pool = ReplicaPool(
            engines,
            PoolConfig(
                heartbeat_dir=hb, step_timeout_s=1.0, lease_s=5.0,
                interval_s=0.05, max_suspect_strikes=3,
            ),
        )
        with pool:
            # each engine warmed on the thread its rounds run on, outside
            # the 1 s deadline
            pool.warmup(*_warm_shapes(pcfg, reqs))
            for r in reqs:
                pool.submit(r)
            pool.step()
            pool.step()
            pool.kill(1, mode="hang")
            try:
                rep = pool.run_until_idle()
            except RuntimeError as e:  # report the failure, don't crash
                rep = {**pool.report(), "error": str(e)}
                return {**rep, "oracle_violations": -1, "ok": False}
    # correctness of the degraded run, not just completion; a request
    # MISSING from completed is itself the floor violation this scenario
    # exists to catch — report it, never KeyError past the check
    missing = [r.rid for r in reqs if r.rid not in pool.completed]
    oracle_violations = 0
    for r in reqs:
        if r.rid in missing:
            continue
        want = _oracle(cfg, params, r, pcfg.max_len, device)
        if not np.array_equal(pool.completed[r.rid].tokens, want):
            oracle_violations += 1
    ok = (
        not missing
        and rep["completed"] == rep["submitted"] == n_requests
        and rep["degraded"]
        and rep["reroutes"] >= 1
        and oracle_violations == 0
    )
    return {
        **rep,
        "missing": missing,
        "oracle_violations": oracle_violations,
        "ok": ok,
    }


# -------------------------------------------------------------------- main


def _device_line(dev) -> dict:
    if dev.type != "cuda":
        return {"type": dev.type}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return {"type": "cuda", "name": torch.cuda.get_device_name(dev),
            "nvidia_smi": smi}


def run_bench(*, smoke: bool, seed: int = 0, width: str = "flagship",
              device=None, log=print) -> dict:
    """The whole A/B: interleaved (continuous, static) pairs, the bitwise
    check over every continuous rep, the replica kill.  Returns the
    report (the JAX bench's keys, plus ``device`` and ``config.width``)."""
    dev = resolve_device(device)
    t_start = _now()
    n = 16 if smoke else 48
    rate = 200.0  # rps: deliberately above capacity so makespan is
    # compute-bound and the throughput ratio measures efficiency, not idle
    bitwise_cap = 6 if smoke else 8
    kill_requests = 6 if smoke else 10
    reps = 1 if smoke else 2
    slots = CONT_SLOTS

    cfg, params = _model(width, dev)
    pcfg = _pcfg()
    requests = build_workload(seed, n, rate)

    log(f"workload: {n} requests, Poisson {rate} rps, prompts "
        f"{PROMPT_LENS}, outputs {OUT_LENS}; continuous slots {slots} vs "
        f"static batch {STATIC_BATCH} at equal KV memory; {width} width "
        f"on {dev}")
    # interleaved (continuous, static) pairs, best-of per side: on a
    # timeshared host a single pass swings the ratio tens of percent
    conts, stats = [], []
    for rep in range(reps):
        cont = run_continuous(cfg, params, pcfg, requests, slots, dev)
        log(f"continuous[{rep}]: {cont['throughput_tok_s']} tok/s over "
            f"{cont['makespan_s']}s, ttft {cont['ttft_ms']}")
        conts.append(cont)
        stat = run_static(cfg, params, requests, STATIC_BATCH, pcfg.max_len,
                          dev)
        log(f"static[{rep}]: {stat['throughput_tok_s']} tok/s over "
            f"{stat['makespan_s']}s, ttft {stat['ttft_ms']}")
        stats.append(stat)
    cont = max(conts, key=lambda r: r["throughput_tok_s"])
    stat = max(stats, key=lambda r: r["throughput_tok_s"])

    # bitwise over EVERY continuous rep's records (a rep that served
    # wrong tokens must not hide behind a faster twin)
    bitwise = {"paged_bitwise_violations": 0, "bitwise_checked": 0}
    for c in conts:
        b = check_bitwise(cfg, params, pcfg, requests, c["records"],
                          bitwise_cap, dev)
        bitwise["paged_bitwise_violations"] += b["paged_bitwise_violations"]
        bitwise["bitwise_checked"] += b["bitwise_checked"]
    log(f"bitwise: {bitwise}")
    kill = run_replica_kill(cfg, params, pcfg, kill_requests, seed + 1, dev)
    log(f"replica kill: completed {kill['completed']}/{kill['submitted']}, "
        f"reroutes {kill['reroutes']}, degraded {kill['degraded']}, "
        f"oracle violations {kill['oracle_violations']}, ok {kill['ok']}")

    ratio = cont["throughput_tok_s"] / stat["throughput_tok_s"]
    p99_ratio = (
        cont["ttft_ms"]["p99"] / stat["ttft_ms"]["p99"]
        if stat["ttft_ms"]["p99"] > 0 else 0.0
    )
    # the throughput floor is enforced on the full workload only: 16
    # smoke requests = 2 static batches, and batch-alignment luck alone
    # swings the ratio; smoke still enforces the bitwise and degrade
    # floors — the correctness gates — and reports the ratio
    enforce_throughput = not smoke
    floors = {
        "throughput_ratio": round(ratio, 3),
        "min_throughput_ratio": MIN_THROUGHPUT_RATIO,
        "throughput_floor_enforced": enforce_throughput,
        "throughput_ok": (
            ratio >= MIN_THROUGHPUT_RATIO if enforce_throughput else True
        ),
        **bitwise,
        "bitwise_ok": bitwise["paged_bitwise_violations"] == 0,
        "p99_ttft_ratio": round(p99_ratio, 3),
        # continuous must not have WORSE tail TTFT than the batch-barrier
        # baseline at equal offered load
        "p99_regression": int(
            cont["ttft_ms"]["p99"] > stat["ttft_ms"]["p99"]
        ),
        "replica_kill": kill,
    }
    ok = bool(
        floors["throughput_ok"] and floors["bitwise_ok"] and kill["ok"]
    )
    return {
        "bench": "serving_continuous_vs_static",
        "smoke": bool(smoke),
        "host": {
            "platform": platform.platform(),
            "python": sys.version.split()[0],
            "torch": torch.__version__,
            "backend": dev.type,
        },
        "device": _device_line(dev),
        "config": {
            "model": f"v{cfg.vocab_size}_d{cfg.d_model}_h{cfg.n_heads}"
            f"_L{cfg.n_layers}_ff{cfg.d_ff}_f32",
            "width": width,
            "paged_cache": dataclasses.asdict(pcfg),
            "slots": slots,
            "reps": reps,
            "protocol": "interleaved pairs, best-of per side, bitwise on all",
            "workload": {
                "n_requests": n,
                "rate_rps": rate,
                "prompt_lens": PROMPT_LENS,
                "out_lens": OUT_LENS,
                "out_probs": OUT_PROBS,
                "seed": seed,
            },
        },
        "continuous": {k: v for k, v in cont.items() if k != "records"},
        "static": {k: v for k, v in stat.items() if k != "records"},
        "continuous_reps_tok_s": [c["throughput_tok_s"] for c in conts],
        "static_reps_tok_s": [s["throughput_tok_s"] for s in stats],
        "floors": floors,
        "ok": ok,
        "elapsed_s": round(_now() - t_start, 1),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="flextree_tpu_torch.tools.bench_serving",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="report path (default tmp/bench_serving.json "
                    "under the repo root)")
    ap.add_argument("--smoke", action="store_true",
                    help="small workload; the throughput floor is reported, "
                    "not enforced")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--width", choices=sorted(WIDTHS), default="flagship")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if os.path.basename(args.out) == "BENCH_SERVING.json":
        ap.error("BENCH_SERVING.json is the JAX bench's artifact; pick "
                 "another --out")

    doc = run_bench(smoke=args.smoke, seed=args.seed, width=args.width,
                    device=args.device,
                    log=lambda msg: print(msg, flush=True))
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    floors = doc["floors"]
    print(json.dumps({"ok": doc["ok"],
                      "throughput_ratio": floors["throughput_ratio"],
                      "p99_ttft_ratio": floors["p99_ttft_ratio"]}))
    if not doc["ok"]:
        print("MACHINE-CHECK FAILED; see floors in " + args.out,
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
