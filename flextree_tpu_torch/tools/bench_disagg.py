"""Prefill/decode disaggregation with KV migration, over real replica
processes and a real front door.

    python -m flextree_tpu_torch.tools.bench_disagg [--smoke]
        [--device cuda|cpu] [--out PATH] [--no-artifact]

The port's copy of the JAX package's ``tools/bench_disagg.py``.  Every
scenario spawns replica processes (``python -m
flextree_tpu_torch.serving.replica_main --role prefill|decode|both``,
through ``tools/rpc_chaos.py``'s helpers) and drives them through a
:class:`~..serving.FrontDoor` over TCP:

- ``migration_f32``: 2 prefill + 2 decode replicas, the lossless codec.
  Every prompt at or past the planner's crossover
  (``serving/costs.py::migration_crossover_tokens``) prefills on a
  prefill replica and ships its KV blocks to a decode replica; every
  shorter one runs colocated on the decode tier.  Floors: exactly-once
  completion, tokens bitwise the single-process ``generate`` oracle's,
  every long rid migrated or a counted fallback, no short rid migrated,
  ``serve.migrations`` equal to the per-result ``migrated`` flags, the
  replicas exit 0.
- ``migration_int8``: the same fleet on the int8 codec, behind the codec
  gate (a pack/unpack round trip at the fleet's KV geometry inside
  ``serving/migration.py::migration_error_bound``) and the token-identity
  gate.  At the flagship's random weights the token-identity gate fails
  on the rids :data:`INT8_FLAGSHIP_FLIPS`, as the JAX engine's int8
  migration on the same weights does (the JAX tool's toy model flips
  none on its seed): the report records the reference's flips beside the
  bad rids, and :func:`only_the_reference_flips` tells that failure from
  any other.
- ``disagg_vs_colocated``: the same open-loop heavy-prefill-tail workload
  against 2 prefill + 2 decode and against 4 ``both`` replicas, with
  ``FT_RPC_PREFILL_SLEEP`` (:data:`PREFILL_SLEEP_S` a prompt token)
  stretching every prefill on both fleets.  Measured: p99 decode
  inter-token latency from the replicas' token timestamps.  The ratio
  disagg/colocated must be at most :data:`P99_RATIO_FLOOR` in the full
  run; ``--smoke`` records it.

The replicas decode in float32 on the paged-attention kernel on a card
(the flagship width) and on its plain stream on the CPU (the JAX tool's
tiny model: ``rpc_chaos.model_args``); each fleet's drained replicas'
kernel launches are held to their decode rounds x layers.  The crossover
is the port's planner's on the replicas' device; where it falls outside
the JAX tool's window (above the short lengths, at most the shortest
heavy one) the report says so, and every floor holds against it.  Any
violation exits 1.  Results go to ``--out`` (default
``tmp/bench_disagg.json``), never to ``BENCH_DISAGG.json``.  Runs on
``cuda`` unless ``--device cpu``; without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from . import checked_out
from . import rpc_chaos as rc

__all__ = ["SHORT_LENS", "HEAVY_LENS", "MAX_NEW", "PREFILL_SLEEP_S",
           "P99_RATIO_FLOOR", "INT8_FLAGSHIP_FLIPS", "build_workload",
           "crossover", "reference_flips", "run_migration_scenario",
           "run_perf_scenario", "run_bench", "only_the_reference_flips",
           "main"]

# every prompt length the workloads use — warmed up in every replica so
# first-call set-up never masquerades as serving latency
SHORT_LENS = (4, 6)          # below the migration crossover: colocated
HEAVY_LENS = (16, 24, 32, 48)  # at/past it: prefill-tier + KV migration
MAX_NEW = (8, 16)
PREFILL_SLEEP_S = "0.004"    # per-prompt-token stall, on BOTH fleets
P99_RATIO_FLOOR = 0.9        # full-run floor: disagg p99 <= 0.9x colocated
#: the rids of the int8 workload (seed 43) whose greedy tokens int8 KV
#: migration changes at the flagship (the replicas' seed-0 weights,
#: prompts of at least the card's int8 crossover, 31 tokens, migrated):
#: the JAX package's engines flip the same rids on the CPU
#: (``tests/test_torch_ab_disagg_int8.py``), so the token-identity gate
#: rejects int8 for this traffic by the JAX rule; its toy model flips none
INT8_FLAGSHIP_FLIPS = (4, 9)


def _bench_geometry(device: str):
    """The replica fleet's model and cache geometry (``replica_main``'s
    defaults under ``rpc_chaos.model_args``): the planner and the codec
    gate price the tensors the fleet ships."""
    from ..serving import PagedCacheConfig

    cfg, _ = rc._model_config(rc.model_args(device))
    return cfg, PagedCacheConfig(**rc.CACHE)


def crossover(codec: str, device: str) -> dict:
    """The planner's migrate-vs-recompute crossover for the fleet on
    ``device``, and whether it splits the workload as the JAX tool's
    does (above the short lengths, at most the shortest heavy one)."""
    from ..serving.costs import migration_crossover_tokens

    cfg, pcfg = _bench_geometry(device)
    cross = migration_crossover_tokens(cfg, pcfg, codec, device=device)
    if cross is None:
        raise RuntimeError("no crossover at bench scale: bench is vacuous")
    return {"tokens": int(cross),
            "in_jax_window": max(SHORT_LENS) < cross <= min(HEAVY_LENS)}


def reference_flips(device: str, n: int) -> list:
    """The rids of an ``n``-request int8 workload whose tokens the
    reference's int8 migration flips: :data:`INT8_FLAGSHIP_FLIPS` on a
    card (the flagship), none on the CPU (the JAX tool's model)."""
    if not device.startswith("cuda"):
        return []
    return [rid for rid in INT8_FLAGSHIP_FLIPS if rid < n]


def build_workload(seed: int, n: int, heavy_frac: float = 0.6) -> list:
    """Open-loop mix with a heavy-prefill tail: mostly-cheap traffic
    whose tail prompts carry several blocks of prefill each (the JAX
    tool's draws)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if rng.random() < heavy_frac:
            t = int(rng.choice(HEAVY_LENS))
        else:
            t = int(rng.choice(SHORT_LENS))
        out.append({
            "rid": i,
            "prompt": rng.integers(0, 64, (t,)).astype(np.int32),
            "max_new": int(rng.choice(MAX_NEW)),
            "gap_s": float(rng.exponential(0.03)),
        })
    return out


def _run_fleet(workdir, tag, roles, requests, device, *, codec, migrate_min):
    """Boot one fleet, drive the open-loop workload, harvest results.
    ``roles`` is rank -> role; ``migrate_min=None`` disables migration
    (the colocated control fleet)."""
    ctrl = os.path.join(workdir, f"ctrl_{tag}")
    os.makedirs(ctrl, exist_ok=True)
    procs = {r: rc.spawn_replica(
        ctrl, r, device, {"FT_RPC_PREFILL_SLEEP": PREFILL_SLEEP_S},
        extra_args=("--role", role), warm_lens=SHORT_LENS + HEAVY_LENS,
        warm_max_new=max(MAX_NEW)) for r, role in roles.items()}
    fd = None
    try:
        rc.wait_ready(ctrl, procs, procs)
        t0 = time.monotonic()
        with rc.Serving(ctrl, migrate_min_prompt_len=migrate_min,
                        migrate_codec=codec) as fd:
            for req in requests:  # open loop: arrivals don't wait
                time.sleep(req["gap_s"])
                fd.submit(req["rid"], req["prompt"], req["max_new"])
            idle = fd.wait_idle(timeout_s=rc.RUN_TIMEOUT_S * 2)
            counters = rc.counters(fd.metrics)
        wall_s = time.monotonic() - t0
    finally:
        log_tails = {r: rc.log_tail(p, 4) for r, p in procs.items()}
        rcs = rc.shutdown(procs)
    intervals = [d for res in fd.completed.values() for d in res.intervals_s]
    return {
        "fd": fd,
        "counters": counters,
        "idle": idle,
        "rcs": rcs,
        "wall_s": round(wall_s, 3),
        "migrated_rids": sorted(
            rid for rid, res in fd.completed.items() if res.migrated),
        "intervals_ms": [round(d * 1e3, 3) for d in intervals],
        "log_tails": log_tails,
        "ctrl": ctrl,
    }


def _p99_ms(intervals_ms: list) -> float:
    return float(np.percentile(np.asarray(intervals_ms), 99.0))


def _identity_floors(run, requests, oracle, migrate_min) -> dict:
    fd = run["fd"]
    bad = rc.bitwise_violations(fd, requests, oracle)
    long_rids = sorted(
        r["rid"] for r in requests if len(r["prompt"]) >= migrate_min)
    short_rids = [
        r["rid"] for r in requests if len(r["prompt"]) < migrate_min]
    migrated = set(run["migrated_rids"])
    fallbacks = run["counters"].get("serve.migration_fallback", 0)
    return {
        "all_completed_exactly_once": run["idle"]
        and sorted(fd.completed) == [r["rid"] for r in requests]
        and not fd.failed,
        "bitwise_vs_generate": not bad,
        # every long rid is exactly one of {migrated, accounted fallback}
        "long_prompts_migrated_or_accounted": (
            len(migrated) + fallbacks >= len(long_rids)
            and migrated <= set(long_rids)
        ),
        "migrations_happened": len(migrated) >= 1,
        "short_prompts_never_migrated": not (migrated & set(short_rids)),
        "migration_counter_agrees": run["counters"].get(
            "serve.migrations", 0) == len(migrated),
        "replicas_exit_zero": all(c == 0 for c in run["rcs"].values()),
    }


def _launches(run, oracle) -> dict:
    """The fleet's drained replicas' paged launches against their decode
    rounds x layers (``rpc_chaos.launch_checks``)."""
    return rc.launch_checks(run["ctrl"], oracle)


def run_migration_scenario(workdir, oracle, *, codec, n) -> dict:
    """2 prefill + 2 decode replicas, one codec, identity floors."""
    cross = crossover(codec, oracle.device)
    migrate_min = cross["tokens"]
    roles = {0: "prefill", 1: "prefill", 2: "decode", 3: "decode"}
    # the JAX tool's seeds: f32 is bitwise on every seed; its int8 seed is
    # one its token-identity gate passes at its toy scale
    requests = build_workload(seed=29 if codec == "f32" else 43, n=n)
    floors = {}
    if codec == "int8":
        floors["codec_error_bound_ok"] = _codec_gate(oracle.device)
    run = _run_fleet(workdir, f"mig_{codec}", roles, requests,
                     oracle.device, codec=codec, migrate_min=migrate_min)
    floors.update(_identity_floors(run, requests, oracle, migrate_min))
    launches = _launches(run, oracle)
    floors["launches_the_codes"] = launches["launches_the_codes"]
    flips = (reference_flips(oracle.device, n) if codec == "int8"
             else [])
    return {
        "scenario": f"migration_{codec}",
        "injection": f"KV migration on every prompt >= {migrate_min} "
                     f"tokens ({codec} codec), 2 prefill + 2 decode "
                     "processes",
        "ok": all(floors.values()),
        "floors": floors,
        "checks": {
            "migrate_min_prompt_len": migrate_min,
            "crossover_in_jax_window": cross["in_jax_window"],
            "bitwise_bad_rids": rc.bitwise_violations(run["fd"], requests,
                                                      oracle),
            "reference_flips": flips,
            "counters": run["counters"],
            "migrated_rids": run["migrated_rids"],
            "wall_s": run["wall_s"],
            "rcs": run["rcs"],
            "log_tail": run["log_tails"].get(0, []),
            "launches": launches,
        },
    }


def _codec_gate(device: str) -> bool:
    """Gate (a) for int8: at the fleet's KV geometry, the round trip's
    error stays inside the bound the codec advertises."""
    from ..serving.migration import (
        migration_error_bound,
        pack_kv,
        unpack_kv,
    )

    cfg, pcfg = _bench_geometry(device)
    rng = np.random.default_rng(0)
    shape = (6, pcfg.block_size, cfg.n_heads, cfg.head_dim)
    kv = {
        "k": [rng.standard_normal(shape).astype(np.float32)
              for _ in range(cfg.n_layers)],
        "v": [rng.standard_normal(shape).astype(np.float32)
              for _ in range(cfg.n_layers)],
    }
    meta, blob = pack_kv(kv, codec="int8")
    out = unpack_kv(meta, blob)
    bound = migration_error_bound(meta)
    worst = max(
        float(np.max(np.abs(a - b)))
        for kind in ("k", "v") for a, b in zip(kv[kind], out[kind]))
    return 0.0 < worst <= bound


def run_perf_scenario(workdir, oracle, *, n, smoke) -> dict:
    """Fleet A (disagg) vs fleet B (colocated) at equal replica count,
    same workload, same injected prefill stall."""
    cross = crossover("f32", oracle.device)
    migrate_min = cross["tokens"]
    requests = build_workload(seed=37, n=n)
    disagg = _run_fleet(
        workdir, "disagg",
        {0: "prefill", 1: "prefill", 2: "decode", 3: "decode"},
        requests, oracle.device, codec="f32", migrate_min=migrate_min,
    )
    coloc = _run_fleet(
        workdir, "coloc", {r: "both" for r in range(4)},
        requests, oracle.device, codec="f32", migrate_min=None,
    )
    floors = _identity_floors(disagg, requests, oracle, migrate_min)
    coloc_ok = (
        coloc["idle"]
        and sorted(coloc["fd"].completed) == [r["rid"] for r in requests]
        and not rc.bitwise_violations(coloc["fd"], requests, oracle)
    )
    floors["colocated_control_clean"] = coloc_ok
    launches = {"disagg": _launches(disagg, oracle),
                "colocated": _launches(coloc, oracle)}
    floors["launches_the_codes"] = all(v["launches_the_codes"]
                                       for v in launches.values())
    p99_d = _p99_ms(disagg["intervals_ms"])
    p99_c = _p99_ms(coloc["intervals_ms"])
    ratio = p99_d / p99_c if p99_c > 0 else float("inf")
    if smoke:
        # recorded, not gated: latency on a shared host is noise,
        # correctness is not
        floors["decode_p99_ratio_recorded"] = bool(np.isfinite(ratio))
    else:
        floors["decode_p99_disagg_beats_colocated"] = (
            ratio <= P99_RATIO_FLOOR
        )
    return {
        "scenario": "disagg_vs_colocated",
        "injection": f"FT_RPC_PREFILL_SLEEP={PREFILL_SLEEP_S} on BOTH "
                     "fleets; heavy-prefill-tail open loop, equal replica "
                     "count (4 vs 4)",
        "ok": all(floors.values()),
        "floors": floors,
        "checks": {
            "migrate_min_prompt_len": migrate_min,
            "crossover_in_jax_window": cross["in_jax_window"],
            "decode_p99_intertoken_ms": {
                "disagg": round(p99_d, 3), "colocated": round(p99_c, 3),
            },
            "decode_p99_ratio": round(ratio, 4),
            "p99_ratio_floor": None if smoke else P99_RATIO_FLOOR,
            "n_intervals": {
                "disagg": len(disagg["intervals_ms"]),
                "colocated": len(coloc["intervals_ms"]),
            },
            "migrated_rids": disagg["migrated_rids"],
            "counters": {
                "disagg": disagg["counters"], "colocated": coloc["counters"],
            },
            "wall_s": {
                "disagg": disagg["wall_s"], "colocated": coloc["wall_s"],
            },
            "launches": launches,
        },
    }


SCENARIOS = ("migration_f32", "migration_int8", "disagg_vs_colocated")


def run_bench(*, smoke: bool, device=None, oracle=None, n=None,
              log=print) -> dict:
    """The scenarios in order (a crashed one is a failed floor) and the
    report.  ``n`` requests a scenario (default: the JAX tool's, 10 under
    ``smoke``, else 28); ``oracle`` an ``rpc_chaos.Oracle`` to reuse."""
    from ..device import resolve_device

    device = str(resolve_device(device))
    n = n or (10 if smoke else 28)
    if oracle is None:
        log("building the generate oracle (single-process greedy)...")
        oracle = rc.Oracle(device)
    runners = {
        "migration_f32":
            lambda wd: run_migration_scenario(wd, oracle, codec="f32", n=n),
        "migration_int8":
            lambda wd: run_migration_scenario(wd, oracle, codec="int8", n=n),
        "disagg_vs_colocated":
            lambda wd: run_perf_scenario(wd, oracle, n=n, smoke=smoke),
    }
    results = []
    with tempfile.TemporaryDirectory(prefix="ft_disagg_") as wd:
        for name in SCENARIOS:
            sub = os.path.join(wd, name)
            os.makedirs(sub, exist_ok=True)
            log(f"=== scenario {name} ===")
            t0 = time.monotonic()
            try:
                res = runners[name](sub)
            except Exception as e:  # a crashed scenario is a failed floor
                res = {"scenario": name, "ok": False,
                       "error": f"{type(e).__name__}: {e}", "floors": {}}
            res["seconds"] = round(time.monotonic() - t0, 1)
            log(f"scenario {res['scenario']}: "
                f"{'OK' if res['ok'] else 'FAILED'} "
                + json.dumps(res.get("floors", {}))
                + (f" {res['error']}" if "error" in res else ""))
            results.append(res)
    ok = all(r["ok"] for r in results)
    from ..utils.buildstamp import artifact_meta

    cfg = oracle.cfg
    return {
        "description": "Executed prefill/decode disaggregation proof: "
                       "real replica processes (serving/replica_main.py "
                       "--role) behind role-aware front-door routing "
                       "(serving/frontdoor.py), shipping int8/f32 "
                       "block-scaled KV over CRC-trailered kv_chunk frames "
                       "(serving/migration.py, serving/rpc.py) at the cost "
                       "planner's crossover (serving/costs.py) — "
                       "exactly-once results bitwise vs the single-process "
                       "generate oracle, int8 behind the error-bound + "
                       "token-identity gates, decode p99 inter-token "
                       "latency vs a colocated control fleet at equal "
                       "replica count, all floors machine-checked, non-zero "
                       "exit on any violation",
        "build": artifact_meta(),
        "ok": ok,
        "smoke": smoke,
        "device": device,
        "model": f"v{cfg.vocab_size}_d{cfg.d_model}_h{cfg.n_heads}"
                 f"_L{cfg.n_layers}_ff{cfg.d_ff}_f32 (seed 0, "
                 f"deterministic cross-process)",
        "scenarios": {r["scenario"]: r for r in results},
    }


def only_the_reference_flips(doc: dict) -> bool:
    """Whether a report's one violation is ``migration_int8``'s
    ``bitwise_vs_generate`` on exactly the reference's flips
    (:func:`reference_flips`): every scenario ran and every other floor
    held."""
    runs = doc["scenarios"]
    failed = [(name, floor) for name, r in runs.items()
              for floor, ok in r.get("floors", {}).items() if not ok]
    if set(runs) != set(SCENARIOS) or any("error" in r for r in
                                          runs.values()):
        return False
    checks = runs["migration_int8"]["checks"]
    return (failed == [("migration_int8", "bitwise_vs_generate")]
            and checks["bitwise_bad_rids"] == checks["reference_flips"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="flextree_tpu_torch.tools.bench_disagg",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="fewer requests, latency ratio informational "
                         "instead of gated")
    ap.add_argument("--out", default=os.path.join("tmp", "bench_disagg.json"))
    ap.add_argument("--no-artifact", action="store_true")
    ap.add_argument("--device", default=None,
                    help="the replicas' and the oracle's device: cuda "
                         "(default) or cpu")
    args = ap.parse_args(argv)
    out = None if args.no_artifact else checked_out(ap, args.out)
    doc = run_bench(smoke=args.smoke, device=args.device,
                    log=lambda m: print(m, flush=True))
    if only_the_reference_flips(doc):
        flips = doc["scenarios"]["migration_int8"]["checks"][
            "reference_flips"]
        print(f"the one violation: int8 migration flips rids {flips}, as "
              "the reference's does (the JAX gate rejects int8 for this "
              "traffic)")
    for r in doc["scenarios"].values():
        r.pop("fd", None)
    if out is not None:
        with open(out, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True, default=str)
        print(f"wrote {out} (ok={doc['ok']})")
    return 0 if doc["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
