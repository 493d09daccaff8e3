"""Runtime chaos: SIGKILL, SIGSTOP and SIGTERM against a live training run.

    python -m flextree_tpu_torch.tools.chaos_runtime [--scenario NAME]...
    python -m flextree_tpu_torch.tools.chaos_runtime --device cpu \\
        --scenario sigterm

The port's counterpart of the JAX package's ``tools/chaos_runtime.py``.
``tools.chaos_bringup`` runs the bring-up's failure paths; this driver
runs the in-run failure model of ``runtime`` and
``parallel.loop.fit(supervision=...)`` against real OS processes: the
signals are real, the heartbeats cross a process boundary, and the
recovery is the production code path.

- ``sigkill``: a supervised group of 3 (one training process, two
  heartbeating peers); a peer is SIGKILLed mid-run, its lease expires,
  and ``fit`` shrinks to the survivors live (drain, restore the newest
  CRC-verified checkpoint, ``replan_for_survivors``, ``on_shrink``) and
  finishes every step without a restart: a membership epoch 3 -> 2 with
  a replanned topology.
- ``sigstop``: a group of 2; the peer is SIGSTOPped past the straggler
  threshold and SIGCONTed inside the lease: flagged a straggler, no
  shrink, the run completes.
- ``sigterm``: one training process preempted mid-run: the
  ``PreemptionGuard`` checkpoints within one step and the process exits
  cleanly; a relaunch resumes from exactly that step and completes.
- ``sigkill_sharded``: ``sigkill`` under the port's ZeRO-1 dense step on
  an in-process dp mesh that mirrors the heartbeat world (``--device``;
  on a card the flagship model, bf16, the flash kernels, the fold
  kernel's reduce-scatters): checkpoints are consolidated, and the shrink
  rebuilds the dp-2 step and recarves the checkpoint into the survivors'
  shards (``zero.make_reshard_fn``).  Held: the 3 -> 2 epoch, finite
  losses, and the reshard a bitwise fixed point (consolidate, reshard,
  consolidate).

The first three run the JAX tool's deterministic host toy step (the
supervision layer does not care what a step computes).  Exit 1 when any
scenario does not recover; results go to ``--out`` (default
``tmp/chaos_runtime.json``), under ``tmp/``.
"""

from __future__ import annotations

import argparse
import collections
import datetime
import json
import math
import os
import signal
import subprocess
import sys
import tempfile
import time

from . import FLAGSHIP as _FLAGSHIP
from . import checked_out

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SCENARIOS = ("sigkill", "sigstop", "sigterm", "sigkill_sharded")

# supervision budgets (seconds): every scenario derives its waits from
# these, so the checks are "within the lease" by construction
HB_INTERVAL = 0.2
STRAGGLER_S = 0.8
LEASE_S = 2.0
STEP_SLEEP = 0.1

#: the sharded scenario's model on a card: the flagship
#: (``__graft_entry__.py``), bf16, the flash kernels
FLAGSHIP = dict(_FLAGSHIP)
#: the JAX tool's model on the CPU
TINY = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=1, d_ff=64)
#: global rows a step (divides by 3 and by 2) and the sequence length,
#: on a card and on the CPU
SHARDED_BATCH = {"cuda": (6, 1024), "cpu": (6, 16)}
SHARDED_STEPS = 40
SHARDED_KILL_AT = 8
SHARDED_CKPT_EVERY = 4
CHILD_TIMEOUT_S = 300.0


# --------------------------------------------------------------------------
# children
# --------------------------------------------------------------------------


class _ToyData:
    def batch_at(self, step):
        import numpy as np

        tok = np.full((2, 4), float(step + 1))
        return tok, tok


def _obs_ctx(rank: int = 0):
    """A flight recorder when ``FT_OBS_DIR`` is set (any chaos run can
    leave a mergeable record), else nothing."""
    import contextlib

    obs_dir = os.environ.get("FT_OBS_DIR")
    if not obs_dir:
        return contextlib.nullcontext()
    from ..obs import flight_recorder

    return flight_recorder(obs_dir, rank=rank)


def _supervisor_cfg(rank: int, hb_dir: str):
    from ..runtime import SupervisorConfig

    return SupervisorConfig(rank=rank, dir=hb_dir, interval_s=HB_INTERVAL,
                            straggler_s=STRAGGLER_S, lease_s=LEASE_S)


def assemble(cfg_hb, world: int, timeout_s: float = 60.0):
    """Beat once, then wait for every member's first beat before
    membership is armed: a peer still importing reads as dead and would
    shrink the run at step 0.  Returns the started-less supervisor."""
    from ..runtime import MembershipView, Supervisor

    supervisor = Supervisor(cfg_hb)
    supervisor.beat_now()
    view = MembershipView.for_config(cfg_hb, configured=world)
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if all(s.step >= 0 for s in view.poll().values()):
            return supervisor
        time.sleep(0.05)
    raise RuntimeError("peers never assembled for supervision")


def child_train() -> int:
    """The supervised training process (rank 0 of the heartbeat group)."""
    import torch

    from ..parallel.loop import FitConfig, Supervision, fit
    from ..runtime import MembershipView, PreemptionGuard, Supervisor
    from ..utils.checkpoint import list_checkpoints

    hb_dir = os.environ["FT_HB_DIR"]
    world = int(os.environ["FT_WORLD"])
    steps = int(os.environ["FT_STEPS"])
    ckpt_dir = os.environ["FT_CKPT_DIR"]
    cfg_hb = _supervisor_cfg(0, hb_dir)
    if world > 1:
        try:
            supervisor = assemble(cfg_hb, world, 30.0)
        except RuntimeError as e:
            print(f"FAIL: {e}", flush=True)
            return 1
    else:
        supervisor = Supervisor(cfg_hb)
    shrinks: list = []

    def on_shrink(n_alive, plan):
        shrinks.append({"alive": n_alive, "topo": plan.to_ft_topo()})
        return None  # the toy step is world-size-agnostic: the replan is it

    supervision = Supervision(
        supervisor=supervisor,
        membership=MembershipView.for_config(cfg_hb, configured=world)
        if world > 1 else None,
        configured_world=world if world > 1 else None,
        step_timeout_s=30.0,  # armed (the real watchdog path), never hit
        on_shrink=on_shrink, nbytes_hint=1 << 20,
        preemption=PreemptionGuard().install())

    def step_fn(state, tokens, targets):
        time.sleep(STEP_SLEEP)  # a step takes wall time to supervise
        return ({"step": state["step"] + 1,
                 "w": state["w"] - 0.01 * float(tokens.mean())},
                {"loss": float(tokens.mean())})

    state = {"step": torch.tensor(0, dtype=torch.int64),
             "w": torch.zeros(4, dtype=torch.float64)}
    with _obs_ctx(rank=0):
        result = fit(state, step_fn, _ToyData(), FitConfig(
            num_steps=steps, ckpt_dir=ckpt_dir,
            ckpt_every=int(os.environ.get("FT_CKPT_EVERY", "5")),
            log_every=0, prefetch=0), supervision=supervision)
    print("CHAOS_JSON: " + json.dumps({
        "final_step": int(result.state["step"]),
        "steps_run": result.steps_run,
        "resumed_from": result.resumed_from,
        "report": result.report.to_payload(),
        "shrink_calls": shrinks,
        "ckpt_steps": [s for s, _ in list_checkpoints(ckpt_dir)],
    }), flush=True)
    return 0


def sharded_config(device: str):
    """The sharded scenario's ``arbiter_spike.SpikeConfig``: the flagship
    in bf16 on the flash kernels on a card, the JAX tool's model in
    float32 on the CPU; no pacing (the steps are paced here)."""
    import dataclasses

    from .arbiter_spike import SpikeConfig

    on_card = device.startswith("cuda")
    batch, seq = SHARDED_BATCH["cuda" if on_card else "cpu"]
    return dataclasses.replace(
        SpikeConfig(device=device), seed=0,
        train_model=dict(FLAGSHIP if on_card else TINY),
        train_dtype="bfloat16" if on_card else "float32",
        train_attn="flash" if on_card else "reference",
        train_batch=batch, train_seq=seq, train_pace_s=0.0)


def child_train_sharded() -> int:
    """The supervised ZeRO-1 training process: the dense step sharded
    over an in-process dp mesh as wide as the heartbeat world, on
    ``FT_DEVICE``; consolidated checkpoints; on a shrink the survivors'
    step is rebuilt and the checkpoint recarved into their shards."""
    import torch

    from ..device import resolve_device
    from ..ops import flash_attention as fa
    from ..ops import reduce_stacked as rs
    from ..parallel.loop import FitConfig, Supervision, fit
    from ..planner.choose import replan_for_survivors
    from ..runtime import MembershipView, PreemptionGuard
    from ..utils.checkpoint import list_checkpoints
    from ..utils.tree import tree_leaves
    from .arbiter_spike import TrainWorlds, _LMData

    dev = resolve_device(os.environ["FT_DEVICE"])
    hb_dir = os.environ["FT_HB_DIR"]
    world = int(os.environ["FT_WORLD"])
    steps = int(os.environ["FT_STEPS"])
    ckpt_dir = os.environ["FT_CKPT_DIR"]
    cfg = sharded_config(str(dev))
    worlds = TrainWorlds(cfg, dev)
    topo0 = replan_for_survivors(world, worlds.nbytes,
                                 configured=world).to_ft_topo()
    step0, _, _, pack0, unpack0 = worlds.build(world, topo0)
    cur = {"pack": pack0, "unpack": unpack0}
    shrinks: list = []
    cfg_hb = _supervisor_cfg(0, hb_dir)
    try:
        supervisor = assemble(cfg_hb, world)
    except RuntimeError as e:
        print(f"FAIL: {e}", flush=True)
        return 1

    def paced(step_fn):
        def run(state, tokens, targets):
            time.sleep(STEP_SLEEP)  # wall time for the supervision layer
            return step_fn(state, tokens, targets)
        return run

    def on_shrink(n_alive, plan):
        step, comm, _, pack, unpack = worlds.build(n_alive,
                                                   plan.to_ft_topo())
        cur["pack"], cur["unpack"] = pack, unpack
        shrinks.append({"alive": n_alive, "topo": plan.to_ft_topo()})
        return paced(step), comm, None, pack, unpack

    supervision = Supervision(
        supervisor=supervisor,
        membership=MembershipView.for_config(cfg_hb, configured=world),
        configured_world=world, step_timeout_s=120.0,
        on_shrink=on_shrink,
        nbytes_hint=worlds.nbytes, preemption=PreemptionGuard().install())
    state = worlds.initial_state(world, topo0)
    data = _LMData(cfg.train_batch, cfg.train_seq,
                   cfg.train_model["vocab_size"])
    kernels = {"flash_fwd": fa.flash_fwd, "flash_bwd_dq": fa.flash_bwd_dq,
               "flash_bwd_dkv": fa.flash_bwd_dkv,
               "reduce_sources": rs.reduce_sources}
    for fn in kernels.values():
        fn.launches = 0
    with _obs_ctx(rank=0):
        result = fit(state, paced(step0), data, FitConfig(
            num_steps=steps, ckpt_dir=ckpt_dir,
            ckpt_every=int(os.environ.get("FT_CKPT_EVERY",
                                          str(SHARDED_CKPT_EVERY))),
            log_every=10, prefetch=0), supervision=supervision,
            state_pack=pack0, state_unpack=unpack0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = {name: fn.launches for name, fn in kernels.items()}
    # the consistency proof: consolidate the final sharded state, then
    # recarve and consolidate again: a bitwise fixed point, all finite
    cons = cur["pack"](result.state)
    again = cur["pack"](cur["unpack"](cons))
    flat_a, flat_b = tree_leaves(cons), tree_leaves(again)
    consistent = len(flat_a) == len(flat_b) and all(
        torch.equal(a.cpu().view(torch.uint8) if a.dtype.is_floating_point
                    else a.cpu(),
                    b.cpu().view(torch.uint8) if b.dtype.is_floating_point
                    else b.cpu())
        for a, b in zip(flat_a, flat_b))
    finite = all(bool(torch.isfinite(a.float()).all()) for a in flat_a
                 if a.dtype.is_floating_point)
    ran = collections.Counter(n for _, _, n in worlds.step_trace)
    print("CHAOS_JSON: " + json.dumps({
        "final_step": int(result.state["step"]),
        "steps_run": result.steps_run,
        "resumed_from": result.resumed_from,
        "report": result.report.to_payload(),
        "shrink_calls": shrinks,
        "ckpt_steps": [s for s, _ in list_checkpoints(ckpt_dir)],
        "reshard_consistent": bool(consistent),
        "state_finite": bool(finite),
        "losses": [float(loss) for _, loss in result.losses],
        "device": str(dev), "model": cfg.train_model,
        "dtype": cfg.train_dtype, "batch": [cfg.train_batch, cfg.train_seq],
        "steps_by_world": {str(n): k for n, k in sorted(ran.items())},
        "step_ms_by_world": {str(n): _median([
            s * 1e3 for _, s, m in worlds.step_trace if m == n])
            for n in sorted(ran)},
        "topo0": topo0, "launches": launches,
    }), flush=True)
    return 0


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else None


def child_peer() -> int:
    """A heartbeating group member doing fake work: the one the scenarios
    stop or kill."""
    from ..runtime import Supervisor

    rank = int(os.environ["FT_RANK"])
    seconds = float(os.environ.get("FT_PEER_SECONDS", "30"))
    sup = Supervisor(_supervisor_cfg(rank, os.environ["FT_HB_DIR"])).start()
    t0 = time.time()
    step = 0
    while time.time() - t0 < seconds:
        time.sleep(STEP_SLEEP)
        step += 1
        sup.record_step(step, STEP_SLEEP)
    sup.stop()
    return 0


# --------------------------------------------------------------------------
# the parent
# --------------------------------------------------------------------------


def _spawn(role: str, hb_dir: str, ckpt_dir: str, extra_env=None):
    path = os.environ.get("PYTHONPATH")
    return subprocess.Popen(
        [sys.executable, "-m", "flextree_tpu_torch.tools.chaos_runtime",
         "--child"], cwd=ROOT,
        env={**os.environ, "FT_CHAOS_ROLE": role, "FT_HB_DIR": hb_dir,
             "FT_CKPT_DIR": ckpt_dir, "OMP_NUM_THREADS": "1",
             "PYTHONPATH": ROOT + (os.pathsep + path if path else ""),
             **(extra_env or {})},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def wait_for_step(hb_dir: str, rank: int, step: int,
                  timeout: float = 60.0, procs=()) -> int:
    """Poll ``rank``'s heartbeat file (the parent is one more membership
    observer) until it reports progress past ``step``."""
    from ..runtime import read_control_json

    path = os.path.join(hb_dir, f"hb_{rank:05d}.json")
    deadline = time.time() + timeout
    while time.time() < deadline:
        beat = read_control_json(path)
        if beat is not None and beat.get("step", -1) >= step:
            return beat["step"]
        if any(p.poll() is not None for p in procs):
            raise RuntimeError(f"a child exited before rank {rank} reached "
                               f"step {step}")
        time.sleep(0.05)
    raise TimeoutError(f"rank {rank} never reached step {step} in "
                       f"{timeout} s")


def finish(proc, timeout: float = 120.0):
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        out += f"\n[parent] TIMEOUT after {timeout} s"
    return out, proc.returncode


def reap(procs) -> None:
    """Kill and wait for every child still running (never leak one into
    the temporary directory's cleanup)."""
    for p in procs:
        if p.poll() is None:
            try:
                os.kill(p.pid, signal.SIGCONT)
            except OSError:
                pass
            p.kill()
        p.communicate()


def chaos_payload(log: str) -> dict:
    for line in log.splitlines():
        if line.startswith("CHAOS_JSON: "):
            return json.loads(line[len("CHAOS_JSON: "):])
    return {}


def _shrunk_to_two(rc, payload, steps) -> bool:
    epochs = payload.get("report", {}).get("membership_epochs", [])
    return (rc == 0 and payload.get("final_step") == steps
            and len(epochs) == 2 and epochs[0]["alive"] == 3
            and epochs[1]["alive"] == 2 and epochs[1]["dead"] == [2]
            and epochs[1]["topo"] is not None
            and payload.get("shrink_calls") == [
                {"alive": 2, "topo": epochs[1]["topo"]}])


def run_sigkill(workdir: str, device: str) -> dict:
    """A peer SIGKILLed mid-run: live shrink to the survivors."""
    hb, ck = os.path.join(workdir, "hb"), os.path.join(workdir, "ck")
    steps = 60
    trainer = _spawn("train", hb, ck, {"FT_WORLD": "3",
                                       "FT_STEPS": str(steps)})
    peers = [_spawn("peer", hb, ck, {"FT_RANK": str(r),
                                     "FT_PEER_SECONDS": "45"})
             for r in (1, 2)]
    checks: dict = {}
    try:
        checks["killed_at_trainer_step"] = wait_for_step(
            hb, 0, 10, procs=[trainer])
        os.kill(peers[1].pid, signal.SIGKILL)
        log, rc = finish(trainer, 180)
    finally:
        reap([trainer, *peers])
    payload = chaos_payload(log)
    checks.update(trainer_rc=rc,
                  epochs=payload.get("report", {}).get("membership_epochs"),
                  shrink_calls=payload.get("shrink_calls"),
                  final_step=payload.get("final_step"),
                  peer_rcs=[p.returncode for p in peers])
    return {"scenario": "sigkill",
            "injection": "SIGKILL of peer rank 2 mid-run",
            "recovered": _shrunk_to_two(rc, payload, steps),
            "checks": checks, "log": log.splitlines()[-30:]}


def run_sigkill_sharded(workdir: str, device: str) -> dict:
    """A peer SIGKILLed under the ZeRO-1 sharded step: dp-3 -> dp-2 with
    the consolidated checkpoint recarved into the survivors' shards."""
    hb, ck = os.path.join(workdir, "hb"), os.path.join(workdir, "ck")
    steps = SHARDED_STEPS
    trainer = _spawn("train_sharded", hb, ck, {
        "FT_WORLD": "3", "FT_STEPS": str(steps), "FT_DEVICE": device,
        "FT_CKPT_EVERY": str(SHARDED_CKPT_EVERY)})
    peers = [_spawn("peer", hb, ck, {"FT_RANK": str(r),
                                     "FT_PEER_SECONDS": "240"})
             for r in (1, 2)]
    checks: dict = {}
    try:
        checks["killed_at_trainer_step"] = wait_for_step(
            hb, 0, SHARDED_KILL_AT, timeout=240.0, procs=[trainer])
        os.kill(peers[1].pid, signal.SIGKILL)
        log, rc = finish(trainer, CHILD_TIMEOUT_S)
    finally:
        reap([trainer, *peers])
    payload = chaos_payload(log)
    losses = payload.get("losses", [])
    checks.update(
        trainer_rc=rc,
        epochs=payload.get("report", {}).get("membership_epochs"),
        shrink_calls=payload.get("shrink_calls"),
        final_step=payload.get("final_step"),
        reshard_consistent=payload.get("reshard_consistent"),
        state_finite=payload.get("state_finite"),
        peer_rcs=[p.returncode for p in peers],
        **{k: payload.get(k) for k in (
            "device", "model", "dtype", "batch", "steps_by_world",
            "step_ms_by_world", "topo0", "launches", "ckpt_steps")})
    recovered = (_shrunk_to_two(rc, payload, steps)
                 and payload.get("reshard_consistent") is True
                 and payload.get("state_finite") is True
                 and bool(losses) and all(math.isfinite(v) for v in losses))
    return {"scenario": "sigkill_sharded",
            "injection": "SIGKILL of peer rank 2 under a live ZeRO-1 "
                         "sharded run (dp-3 mesh -> dp-2 reshard from the "
                         "consolidated checkpoint)",
            "recovered": recovered, "checks": checks,
            "log": log.splitlines()[-30:]}


def run_sigstop(workdir: str, device: str) -> dict:
    """A peer SIGSTOPped past the straggler threshold, SIGCONTed inside
    the lease: flagged a straggler, no shrink, the run completes."""
    hb, ck = os.path.join(workdir, "hb"), os.path.join(workdir, "ck")
    steps = 55
    trainer = _spawn("train", hb, ck, {"FT_WORLD": "2",
                                       "FT_STEPS": str(steps)})
    peer = _spawn("peer", hb, ck, {"FT_RANK": "1", "FT_PEER_SECONDS": "45"})
    checks: dict = {}
    try:
        checks["stopped_at_trainer_step"] = wait_for_step(
            hb, 0, 10, procs=[trainer])
        os.kill(peer.pid, signal.SIGSTOP)
        # hold the stall past straggler_s, well inside the lease
        time.sleep((STRAGGLER_S + LEASE_S) / 2)
        os.kill(peer.pid, signal.SIGCONT)
        log, rc = finish(trainer, 180)
    finally:
        reap([trainer, peer])
    checks["peer_rc"] = peer.returncode
    payload = chaos_payload(log)
    report = payload.get("report", {})
    checks.update(trainer_rc=rc, stragglers=report.get("stragglers"),
                  epochs=report.get("membership_epochs"),
                  final_step=payload.get("final_step"))
    recovered = (rc == 0 and payload.get("final_step") == steps
                 and any(s["rank"] == 1
                         for s in report.get("stragglers", []))
                 and len(report.get("membership_epochs", [])) == 1)
    return {"scenario": "sigstop",
            "injection": f"SIGSTOP of peer rank 1 for "
                         f"{(STRAGGLER_S + LEASE_S) / 2:.1f} s (straggler "
                         f"{STRAGGLER_S} s, lease {LEASE_S} s), then SIGCONT",
            "recovered": recovered, "checks": checks,
            "log": log.splitlines()[-30:]}


def run_sigterm(workdir: str, device: str) -> dict:
    """SIGTERM mid-run: a checkpoint within one step, and a relaunch
    resumes from exactly that step."""
    hb, ck = os.path.join(workdir, "hb"), os.path.join(workdir, "ck")
    steps = 50
    env = {"FT_WORLD": "1", "FT_STEPS": str(steps),
           "FT_CKPT_EVERY": "1000"}  # no periodic saves: SIGTERM's only
    trainer = _spawn("train", hb, ck, env)
    try:
        term_at = wait_for_step(hb, 0, 10, procs=[trainer])
        os.kill(trainer.pid, signal.SIGTERM)
        log, rc = finish(trainer, 60)
    finally:
        reap([trainer])
    payload = chaos_payload(log)
    preempted_at = payload.get("report", {}).get("preempted_at")
    ckpt_steps = payload.get("ckpt_steps", [])
    # the launcher's restart: the same checkpoint directory, no signal
    resumed = _spawn("train", os.path.join(workdir, "hb2"), ck, env)
    try:
        log2, rc2 = finish(resumed, 180)
    finally:
        reap([resumed])
    payload2 = chaos_payload(log2)
    checks = {"term_at_trainer_step": term_at, "trainer_rc": rc,
              "preempted_at": preempted_at, "ckpt_steps": ckpt_steps,
              "resume_rc": rc2, "resumed_from": payload2.get("resumed_from"),
              "resume_final_step": payload2.get("final_step")}
    # "within one step": the checkpoint is the final step; the parent
    # sees progress through the heartbeat, which lags by up to
    # interval_s / step_sleep steps and the step in flight
    hb_lag = int(HB_INTERVAL / STEP_SLEEP) + 2
    recovered = (rc == 0 and preempted_at is not None
                 and payload.get("final_step") == preempted_at
                 and 0 <= preempted_at - term_at <= hb_lag
                 and ckpt_steps == [preempted_at] and rc2 == 0
                 and payload2.get("resumed_from") == preempted_at
                 and payload2.get("final_step") == steps)
    return {"scenario": "sigterm",
            "injection": "SIGTERM of the training process mid-run, then "
                         "relaunch",
            "recovered": recovered, "checks": checks,
            "log": (log.splitlines() + ["--- resumed run ---"]
                    + log2.splitlines())[-40:]}


RUNNERS = {"sigkill": run_sigkill, "sigstop": run_sigstop,
           "sigterm": run_sigterm, "sigkill_sharded": run_sigkill_sharded}


def run_matrix(names, device: str, log=print) -> list:
    results = []
    for name in names:
        log(f"=== scenario {name} ===")
        t0 = time.monotonic()
        with tempfile.TemporaryDirectory(prefix=f"ft-chaos-{name}-") as wd:
            try:
                res = RUNNERS[name](wd, device)
            except Exception as e:  # a crashed driver is a failed scenario
                res = {"scenario": name, "recovered": False,
                       "error": f"{type(e).__name__}: {e}", "log": []}
        res["seconds"] = time.monotonic() - t0
        log(f"scenario {name}: "
            f"{'RECOVERED' if res['recovered'] else 'FAILED'} "
            f"({res['seconds']:.1f} s)"
            + (f" {res['error']}" if "error" in res else ""))
        if not res["recovered"]:
            for line in res.get("log", [])[-15:]:
                log(f"  {line}")
        results.append(res)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--scenario", choices=SCENARIOS, action="append")
    ap.add_argument("--device", default=None,
                    help="sigkill_sharded's device: cuda (default) or cpu")
    ap.add_argument("--out", default=os.path.join("tmp",
                                                  "chaos_runtime.json"))
    ap.add_argument("--no-artifact", action="store_true")
    args = ap.parse_args(argv)
    if args.child:
        role = os.environ.get("FT_CHAOS_ROLE", "train")
        return {"train": child_train, "train_sharded": child_train_sharded
                }.get(role, child_peer)()
    out = None if args.no_artifact else checked_out(ap, args.out)
    from ..device import resolve_device

    device = str(resolve_device(args.device))
    names = tuple(args.scenario) if args.scenario else SCENARIOS
    results = run_matrix(names, device)
    ok = all(r["recovered"] for r in results)
    if out is not None:
        with open(out, "w") as f:
            json.dump({"ok": ok, "device": device, "budgets": {
                "heartbeat_interval_s": HB_INTERVAL,
                "straggler_s": STRAGGLER_S, "lease_s": LEASE_S,
                "step_sleep_s": STEP_SLEEP}, "scenarios": results,
                "finished": datetime.datetime.now(
                    datetime.timezone.utc).isoformat(timespec="seconds")},
                f, indent=1, sort_keys=True)
        print(f"wrote {out} (ok={ok})")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
