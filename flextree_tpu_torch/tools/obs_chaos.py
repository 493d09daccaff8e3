"""Executed observability proof: a real 2-process SIGKILL run with the
flight recorder on, merged into one cross-rank timeline.

    python -m flextree_tpu_torch.tools.obs_chaos [--out PATH]
        [--timeline-out PATH] [--repeat N]
    python -m flextree_tpu_torch.tools.obs_chaos --device cpu --repeat 3

The port's counterpart of the JAX package's ``tools/obs_chaos.py``.  What
``tools.chaos_runtime`` proves about recovery, this driver proves about
evidence: when a peer dies mid-run, what each rank did in the moments
before must be answerable from the files the run left behind.

Scenario (two OS processes sharing a heartbeat directory and an obs
directory):

- **rank 0** runs the port's bucketed dense train step over an
  in-process dp-2 mesh on ``--device`` under ``fit(supervision=...)``
  with its flight recorder on (on a card the flagship model, bf16, the
  flash kernels, each bucket's fold the fold kernel), so the record holds
  provenance-annotated ``bucket_planned`` comm events beside the step
  spans;
- **rank 1** is a heartbeating peer with its own recorder, SIGKILLed
  mid-run: a killed process runs no handler, so its record is its spill
  file, flushed every step;
- rank 0's membership view confirms the death, ``fit`` shrinks 2 -> 1 and
  writes the guaranteed failure dump (``flight_00000.dump.json``).

The driver merges both ranks' files with the port's merger
(``obs.merge_events``), validates the result (``obs.validate_trace``)
and checks the JAX tool's floors (exit 1 on a violation):

1. the killed rank's record exists and carries its final events (the
   last within the flush lag of the kill);
2. the survivor's dump exists with the shrink's reason;
3. the merged timeline is valid Chrome-trace JSON holding the killed
   rank's track, the survivor's shrink marker and provenance-annotated
   bucket spans;
4. the recorder costs at most 2% of the train step
   (``OVERHEAD_BUDGET``, the bench's ``ours_fused_recorded`` row, in
   strict turns with the fused step, min over min of ``--repeat`` turns;
   the median of the turns' ratios is reported beside it).

Results go to ``--out`` (default ``tmp/obs_chaos.json``) and the merged
timeline to ``--timeline-out`` (default ``tmp/obs_timeline.json``), both
under ``tmp/``.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

from . import checked_out
from .chaos_runtime import (  # the supervision budgets are shared
    FLAGSHIP,
    HB_INTERVAL,
    LEASE_S,
    STEP_SLEEP,
    STRAGGLER_S,
    assemble,
    finish,
    reap,
    wait_for_step,
)

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

OVERHEAD_BUDGET = 1.02  # recorder-on over recorder-off train step
STEPS = 40
KILL_AT = 8
#: the JAX tool's model on the CPU; the flagship on a card
TINY = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
#: global rows and sequence length a step, on a card and on the CPU
BATCH = {"cuda": (4, 1024), "cpu": (4, 16)}
CHILD_TIMEOUT_S = 300.0


# --------------------------------------------------------------------------
# children
# --------------------------------------------------------------------------


def child_train() -> int:
    """Rank 0: the bucketed dp-2 train step, supervised, recorder on."""
    import numpy as np
    import torch

    from ..device import resolve_device
    from ..models.transformer import TransformerConfig
    from ..obs import flight_recorder
    from ..ops import flash_attention as fa
    from ..ops import reduce_stacked as rs
    from ..parallel import train as tm
    from ..parallel.loop import FitConfig, Supervision, fit
    from ..parallel.mesh import flat_mesh
    from ..runtime import MembershipView, PreemptionGuard, SupervisorConfig

    dev = resolve_device(os.environ["FT_DEVICE"])
    hb_dir = os.environ["FT_HB_DIR"]
    obs_dir = os.environ["FT_OBS_DIR"]
    world = int(os.environ["FT_WORLD"])
    steps = int(os.environ["FT_STEPS"])
    on_card = dev.type == "cuda"
    model_cfg = TransformerConfig(
        **(FLAGSHIP if on_card else TINY),
        dtype=torch.bfloat16 if on_card else torch.float32,
        attn_impl="flash" if on_card else "reference")
    batch, seq = BATCH["cuda" if on_card else "cpu"]
    vocab = model_cfg.vocab_size
    tc = tm.TrainConfig()
    mesh = flat_mesh(2, dev, "dp")
    inner = tm.make_train_step(model_cfg, tc, comm=mesh)

    def step_fn(state, tokens, targets):
        time.sleep(STEP_SLEEP)  # wall time for the supervision layer
        out = inner(state, tokens, targets)
        if on_card:
            torch.cuda.synchronize(dev)
        return out

    class _LMData:
        def batch_at(self, step):
            tok = (np.arange(batch * seq, dtype=np.int32).reshape(batch, seq)
                   + step) % vocab
            return tok, tok

    cfg_hb = SupervisorConfig(rank=0, dir=hb_dir, interval_s=HB_INTERVAL,
                              straggler_s=STRAGGLER_S, lease_s=LEASE_S)
    try:
        supervisor = assemble(cfg_hb, world)
    except RuntimeError as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    supervision = Supervision(
        supervisor=supervisor,
        membership=MembershipView.for_config(cfg_hb, configured=world),
        configured_world=world, step_timeout_s=120.0,
        on_shrink=lambda n, plan: None,  # the dp mesh is in-process
        nbytes_hint=1 << 16, preemption=PreemptionGuard().install())
    kernels = {"flash_fwd": fa.flash_fwd, "flash_bwd_dq": fa.flash_bwd_dq,
               "flash_bwd_dkv": fa.flash_bwd_dkv,
               "reduce_sources": rs.reduce_sources}
    # the recorder is installed before the first step, so the first
    # sync's bucket provenance lands in the record
    with flight_recorder(obs_dir, rank=0, source="train") as rec:
        state = tm.init_train_state(model_cfg,
                                    torch.Generator().manual_seed(0), tc,
                                    device=dev)
        for fn in kernels.values():
            fn.launches = 0
        result = fit(state, step_fn, _LMData(),
                     FitConfig(num_steps=steps, log_every=10, prefetch=0),
                     supervision=supervision)
        payload = {
            "final_step": int(result.state["step"]),
            "steps_run": result.steps_run,
            "report": result.report.to_payload(),
            "dump_path": rec.dump_path,
            "recorded": rec.recorded,
            "dumps": rec.dumps,
            "losses": [float(v) for _, v in result.losses],
            "device": str(dev), "batch": [batch, seq],
            "model": dict(FLAGSHIP if on_card else TINY),
            "launches": {k: fn.launches for k, fn in kernels.items()},
        }
    print("OBS_JSON: " + json.dumps(payload), flush=True)
    return 0


def child_peer() -> int:
    """Rank 1: a heartbeating peer with its own recorder, the victim."""
    from ..obs import flight_recorder, record_event
    from ..runtime import Supervisor, SupervisorConfig

    rank = int(os.environ["FT_RANK"])
    seconds = float(os.environ.get("FT_PEER_SECONDS", "60"))
    with flight_recorder(os.environ["FT_OBS_DIR"], rank=rank, source="peer"):
        sup = Supervisor(SupervisorConfig(
            rank=rank, dir=os.environ["FT_HB_DIR"], interval_s=HB_INTERVAL,
            straggler_s=STRAGGLER_S, lease_s=LEASE_S)).start()
        t0 = time.time()
        step = 0
        while time.time() - t0 < seconds:
            record_event("step_start", step=step)
            time.sleep(STEP_SLEEP)
            record_event("step_end", step=step)  # the per-step spill
            step += 1
            sup.record_step(step, STEP_SLEEP)
        sup.stop()
    return 0


# --------------------------------------------------------------------------
# the parent
# --------------------------------------------------------------------------


def _spawn(role: str, env: dict):
    path = os.environ.get("PYTHONPATH")
    return subprocess.Popen(
        [sys.executable, "-m", "flextree_tpu_torch.tools.obs_chaos",
         "--child"], cwd=ROOT,
        env={**os.environ, "FT_CHAOS_ROLE": role, "OMP_NUM_THREADS": "1",
             "PYTHONPATH": ROOT + (os.pathsep + path if path else ""),
             **env},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _payload(log: str) -> dict:
    for line in log.splitlines():
        if line.startswith("OBS_JSON: "):
            return json.loads(line[len("OBS_JSON: "):])
    return {}


def run_kill_scenario(workdir: str, device: str) -> dict:
    """SIGKILL the recorded peer mid-run; harvest and merge the evidence."""
    from ..obs.timeline import merge_events, read_dir, validate_trace
    from ..obs.recorder import DUMP_FILE_FMT, EVENT_FILE_FMT

    hb, obs = os.path.join(workdir, "hb"), os.path.join(workdir, "obs")
    os.makedirs(hb, exist_ok=True)
    os.makedirs(obs, exist_ok=True)
    steps = STEPS
    env = {"FT_HB_DIR": hb, "FT_OBS_DIR": obs, "FT_WORLD": "2",
           "FT_STEPS": str(steps), "FT_DEVICE": device}
    trainer = _spawn("train", env)
    peer = _spawn("peer", {**env, "FT_RANK": "1", "FT_PEER_SECONDS": "240"})
    checks: dict = {}
    try:
        checks["killed_at_trainer_step"] = wait_for_step(
            hb, 0, KILL_AT, timeout=240.0, procs=[trainer])
        checks["peer_step_at_kill"] = wait_for_step(hb, 1, 0, procs=[peer])
        os.kill(peer.pid, signal.SIGKILL)
        kill_wall = time.time()
        log, rc = finish(trainer, CHILD_TIMEOUT_S)
    finally:
        reap([trainer, peer])

    payload = _payload(log)
    epochs = payload.get("report", {}).get("membership_epochs", [])
    killed_file = os.path.join(obs, EVENT_FILE_FMT.format(rank=1))
    survivor_dump = os.path.join(obs, DUMP_FILE_FMT.format(rank=0))
    events, dumps = read_dir(obs)
    killed = [e for e in events if e.get("rank") == 1]
    survivor = [e for e in events if e.get("rank") == 0]
    buckets = [e for e in survivor if e["kind"] == "bucket_planned"
               and "predicted_us" in e and e.get("topo")]
    shrinks = [e for e in survivor if e["kind"] == "shrink"]
    last_killed_ts = max((e["ts"] for e in killed), default=0.0)
    doc = merge_events(events, dumps)
    violations = validate_trace(doc)
    names = {ev.get("name", "") for ev in doc["traceEvents"]}
    pids = {ev.get("pid") for ev in doc["traceEvents"] if ev.get("ph") != "M"}
    floors = {
        # 1. the killed rank's per-step-flushed record, fresh at the kill
        "killed_rank_file_exists": os.path.exists(killed_file),
        "killed_rank_has_events": bool(killed),
        "killed_rank_final_events_fresh": bool(killed) and (
            kill_wall - last_killed_ts < 3 * STEP_SLEEP + 1.0),
        # 2. the survivor's guaranteed dump on the shrink path
        "survivor_dump_exists": os.path.exists(survivor_dump),
        "survivor_dump_reason_shrink":
            dumps.get(0, {}).get("reason") == "peer_shrink",
        "survivor_recorded_shrink": bool(shrinks),
        # 3. the merged timeline: valid and complete
        "merge_schema_valid": not violations,
        "timeline_has_killed_track": 1 in pids,
        "timeline_has_shrink": "shrink" in names,
        "timeline_has_bucket_spans": bool(buckets),
        # the evidence run was a real recovery run
        "run_recovered": (rc == 0 and payload.get("final_step") == steps
                          and len(epochs) == 2
                          and epochs[-1]["alive"] == 1),
    }
    return {
        "scenario": "sigkill_recorded",
        "injection": "SIGKILL of recorder-on peer rank 1 mid-run",
        "ok": all(floors.values()), "floors": floors,
        "checks": {
            **checks, "trainer_rc": rc, "epochs": epochs,
            "killed_rank_events": len(killed),
            "survivor_events": len(survivor),
            "bucket_events": len(buckets),
            "bucket_provenance_example": (
                {k: buckets[0][k] for k in ("name", "topo", "codec",
                                            "nbytes", "predicted_us")
                 if k in buckets[0]} if buckets else None),
            "kill_to_last_killed_event_s": (
                round(kill_wall - last_killed_ts, 3) if killed else None),
            "schema_violations": violations[:10],
            **{k: payload.get(k) for k in ("device", "batch", "model",
                                           "launches", "steps_run")},
        },
        "timeline": doc,
        "log_tail": log.splitlines()[-30:],
    }


def run_overhead_bench(repeat: int, device: str) -> dict:
    """Recorder-on over recorder-off fused train step (the bench's
    ``ours_fused_recorded`` row), against :data:`OVERHEAD_BUDGET`."""
    from ..bench.harness import TrainStepBenchConfig, run_train_step_bench

    out = run_train_step_bench(TrainStepBenchConfig(
        repeat=repeat, supervised=False, recorder=True, device=device))
    row = out["rows"]["ours_fused_recorded"]
    overhead = row["recorder_overhead"]
    return {
        "ok": overhead <= OVERHEAD_BUDGET,
        "recorder_overhead": overhead,
        "recorder_overhead_median": row["recorder_overhead_median"],
        "budget": OVERHEAD_BUDGET,
        "rows": {name: row for name, row in out["rows"].items()
                 if name in ("ours_fused", "ours_fused_recorded")},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--device", default=None,
                    help="rank 0's device: cuda (default) or cpu")
    ap.add_argument("--out", default=os.path.join("tmp", "obs_chaos.json"))
    ap.add_argument("--timeline-out",
                    default=os.path.join("tmp", "obs_timeline.json"))
    ap.add_argument(
        "--repeat", type=int, default=24,
        help="train-step bench repetitions for the overhead floor: the "
        "recorder adds tens of microseconds to a step, and min-of-few on "
        "a shared host swings past the 2%% budget")
    ap.add_argument("--no-artifact", action="store_true")
    args = ap.parse_args(argv)
    if args.child:
        role = os.environ.get("FT_CHAOS_ROLE", "train")
        return child_train() if role == "train" else child_peer()
    out = timeline_out = None
    if not args.no_artifact:
        out = checked_out(ap, args.out)
        timeline_out = checked_out(ap, args.timeline_out)
    from ..device import resolve_device

    device = str(resolve_device(args.device))
    print("=== scenario sigkill_recorded ===", flush=True)
    with tempfile.TemporaryDirectory(prefix="ft-obs-chaos-") as wd:
        try:
            scenario = run_kill_scenario(wd, device)
        except Exception as e:  # a crashed driver is a failed floor
            scenario = {"scenario": "sigkill_recorded", "ok": False,
                        "error": f"{type(e).__name__}: {e}", "floors": {}}
    print(f"scenario sigkill_recorded: "
          f"{'OK' if scenario['ok'] else 'FAILED'} "
          + json.dumps(scenario.get("floors", {})), flush=True)
    print("=== recorder overhead bench ===", flush=True)
    try:
        overhead = run_overhead_bench(args.repeat, device)
    except Exception as e:
        overhead = {"ok": False, "error": f"{type(e).__name__}: {e}"}
    print(f"overhead: {'OK' if overhead['ok'] else 'FAILED'} "
          + json.dumps({k: v for k, v in overhead.items() if k != "rows"}),
          flush=True)
    timeline = scenario.pop("timeline", None)
    ok = scenario["ok"] and overhead["ok"]
    if out is not None:
        from ..obs.timeline import write_trace

        if timeline is not None:
            write_trace(timeline, timeline_out)
            print(f"wrote {timeline_out} "
                  f"({len(timeline['traceEvents'])} trace events)")
        with open(out, "w") as f:
            json.dump({"ok": ok, "device": device, "budgets": {
                "heartbeat_interval_s": HB_INTERVAL,
                "straggler_s": STRAGGLER_S, "lease_s": LEASE_S,
                "step_sleep_s": STEP_SLEEP,
                "recorder_overhead_budget": OVERHEAD_BUDGET},
                "scenario": scenario, "overhead": overhead,
                "timeline_artifact": os.path.basename(timeline_out),
                "finished": datetime.datetime.now(
                    datetime.timezone.utc).isoformat(timespec="seconds")},
                f, indent=1, sort_keys=True, default=str)
        print(f"wrote {out} (ok={ok})")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
