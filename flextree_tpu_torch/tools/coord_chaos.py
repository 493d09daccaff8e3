"""Executed consensus proof: the coordinated control plane under handshake
chaos — real processes, real signals, a real gloo wire.

    python -m flextree_tpu_torch.tools.coord_chaos [--smoke] [--out PATH]
    python -m flextree_tpu_torch.tools.coord_chaos --device cpu --smoke \\
        --gloo-count 4099

The port's counterpart of the JAX package's ``tools/coord_chaos.py``.
Two process worlds:

**The matrix world**: three OS processes sharing a heartbeat directory,
each training the same deterministic host model rank-locally under
``fit(supervision=Supervision(coordination=...))``:

- ``kill_coordinator_at_propose``: rank 0 publishes the proposal and is
  SIGKILLed before its own ack lands; the successor proposes again for
  the survivors;
- ``kill_coordinator_at_ackwait``: rank 0 collects every ack and is
  killed holding the commit; the successor completes the commit at the
  same epoch;
- ``kill_coordinator_at_commit``: rank 0 is killed right after the commit;
  the survivors apply it;
- ``stalled_follower_fenced``: rank 2 is SIGSTOPped past the ack deadline;
  the decision is proposed again without it, and after SIGCONT it exits
  with code 3 and a ``coord_fence`` dump instead of training on a stale
  plan;
- ``torn_ledger``: a scribbler truncates the control files throughout the
  handshake; the CRC trailers refuse the torn reads;
- ``coordinated_resize``: this process plays arbiter on the lease ledger;
  the grant change flows propose → commit → group apply, every rank's
  resume bitwise and its lease ack carrying the committed control epoch.

**The gloo world** (``gloo_group_replan``): three processes on
``parallel.launch.init_distributed`` over gloo; every step is a FlexTree
allreduce of this rank's gradient on ``--device`` (on a card, CUDA
tensors staged through the host, each fold the CUDA fold kernel).  Rank 0
proposes the chunk-pipelined twin of the same schedule (bitwise the
same) with an ``apply_step``; every rank blocks at the boundary for the
commit and flips at the same step.  The wire referees: ranks on
different schedules for one step would deadlock.  Each rank checks its
result on host copies of the rows at a step before and after the flip,
and counts its fold launches against the code's count.

The floors, checked per scenario (exit 1 on a violation): every survivor
on the same final control epoch and fingerprint; the trained state
bitwise an unfaulted twin's; no control epoch applied twice (the flight
records' ``coord_apply`` events); every fault leaves a dump with the
handshake phase; a coordinator's death resolves within
``RECOVERY_BOUND_WINDOWS`` lease windows.  ``--smoke`` runs the JAX
tool's smoke set (``kill_coordinator_at_ackwait``, ``torn_ledger``,
``coordinated_resize``) and the gloo world.  Every child
has a deadline, and any failure kills all of a world's processes.
Results go to ``--out`` (default ``tmp/coord_chaos.json``), under
``tmp/``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import datetime
import hashlib
import json
import os
import random
import signal
import subprocess
import sys
import tempfile
import threading
import time

from . import checked_out

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# supervision budgets (seconds): the lease bounds every protocol window
HB_INTERVAL = 0.2
STRAGGLER_S = 0.8
LEASE_S = 2.0
STEP_SLEEP = 0.1
WORLD = 3
STEPS = 40
PROPOSE_AT = 8  # the scripted replan's trigger step
RECOVERY_BOUND_WINDOWS = 4.0  # kill -> successor commit, in lease windows
GLOO_STEPS = 16
GLOO_PROPOSE_AT = 4  # the flip lands at ~step 10: margin for a rank ahead
GLOO_MARGIN = 6  # apply_step = the newest beat's step + this
#: the gloo world's gradient: the flagship model's parameter count
GLOO_COUNT = 16_781_824
#: the steps whose result each gloo rank checks on host copies of the rows
GLOO_HOST_CHECKS = (2, GLOO_STEPS - 1)
CHILD_TIMEOUT_S = 180.0

_FENCED_RC = 3  # the fenced child's own exit code


# --------------------------------------------------------------------------
# the children
# --------------------------------------------------------------------------


def _state_sha(state) -> str:
    from ..utils.tree import tree_leaves

    h = hashlib.sha256()
    for leaf in tree_leaves(state):
        h.update(leaf.detach().cpu().numpy().tobytes())
    return h.hexdigest()


class _ToyData:
    def batch_at(self, step):
        import numpy as np

        tok = np.full((2, 8), float(step + 1))
        return tok, tok


def _toy_step(step_sleep: float, chunked: bool = False):
    """The deterministic host train step.  The ``chunked`` twin updates
    the weights two elements at a time: another program, bitwise the same
    result (elementwise, no reassociation), so a committed replan swaps
    real code without moving the bits the twin comparison holds."""
    def step_fn(state, tokens, targets):
        time.sleep(step_sleep)
        g = 0.01 * float(tokens.mean())
        w = state["w"].clone()
        if chunked:
            for lo in range(0, w.numel(), 2):
                w[lo:lo + 2] = w[lo:lo + 2] - g
        else:
            w = w - g
        return ({"step": state["step"] + 1, "w": w},
                {"loss": float(tokens.mean())})

    return step_fn


def _w0():
    import torch

    return {"step": torch.tensor(0, dtype=torch.int64),
            "w": torch.zeros(8, dtype=torch.float64)}


def _replan_payload() -> dict:
    return {"topo": "chunked", "chunked": True}


class ScriptedReplan:
    """The stand-in for ``FeedbackController``'s coordinated mode: the
    ``maybe_tick``/``apply_committed`` surface ``fit`` drives, with the
    drift decision scripted to one step so faults can be timed against
    the handshake's phases."""

    refusals = 0

    def __init__(self, handle, proposer_rank: int, at_step: int):
        self.handle = handle
        self.proposer_rank = proposer_rank
        self.at_step = at_step
        self.proposed = False

    def maybe_tick(self, step):
        if (not self.proposed and self.handle.rank == self.proposer_rank
                and self.handle.is_coordinator and step >= self.at_step):
            self.proposed = self.handle.propose(
                "replan", _replan_payload()) is not None
        return None

    def apply_committed(self, payload, step=None):
        import types

        rebuilt = (_toy_step(float(os.environ.get("FT_STEP_SLEEP",
                                                  str(STEP_SLEEP))),
                             chunked=bool(payload.get("chunked"))),
                   None, None)
        return types.SimpleNamespace(
            rebuilt=rebuilt, invalidated=0, params=None,
            plan=types.SimpleNamespace(
                to_ft_topo=lambda: str(payload.get("topo", "?"))))


def _holdable_handle(hb_dir, rank, membership, cfg):
    """A ``CoordinationHandle`` with the chaos holds: ``FT_COORD_HOLD`` =
    ``selfack`` skips the proposer's own ack (a SIGKILL between the two
    atomic writes) or ``commit`` collects acks and never commits (the
    kill-at-ack-wait window)."""
    from ..runtime.coordination import CoordinationHandle

    hold = os.environ.get("FT_COORD_HOLD", "")

    class HoldableHandle(CoordinationHandle):
        def _ack(self, decision):
            if hold == "selfack" and decision.coordinator == self.rank:
                self._acked_epoch = decision.epoch
                self._pending = (decision.epoch, decision.apply_step)
                return
            super()._ack(decision)

        def _drive(self, prop):
            if hold == "commit" and prop is not None:
                return  # collect acks forever: the parent kills us here
            super()._drive(prop)

    return HoldableHandle(hb_dir, rank, membership=membership, cfg=cfg)


def child_worker() -> int:
    """One rank of the matrix world: rank-local training under full
    supervision and the coordination handle; prints a ``COORD_JSON``
    line with the state's hash and the applied control epochs."""
    from ..obs import flight_recorder
    from ..parallel.loop import FitConfig, Supervision, fit
    from ..runtime import (
        EpochFenced,
        LeaseLedger,
        MembershipView,
        Supervisor,
        SupervisorConfig,
        TrainLeaseClient,
    )
    from ..runtime.coordination import CoordinationConfig

    rank = int(os.environ["FT_RANK"])
    world = int(os.environ["FT_WORLD"])
    steps = int(os.environ["FT_STEPS"])
    hb_dir = os.environ["FT_HB_DIR"]
    obs_dir = os.environ["FT_OBS_DIR"]
    ckpt_dir = os.environ["FT_CKPT_DIR"]
    step_sleep = float(os.environ.get("FT_STEP_SLEEP", str(STEP_SLEEP)))
    resize_mode = os.environ.get("FT_COORD_RESIZE") == "1"

    cfg_hb = SupervisorConfig(rank=rank, dir=hb_dir, interval_s=HB_INTERVAL,
                              straggler_s=STRAGGLER_S, lease_s=LEASE_S)
    supervisor = Supervisor(cfg_hb)
    supervisor.beat_now()
    barrier = MembershipView.for_config(cfg_hb, configured=world)
    deadline = time.time() + 60.0
    while time.time() < deadline:
        if all(s.step >= 0 for s in barrier.poll().values()):
            break
        time.sleep(0.05)
    else:
        print("FAIL: peers never assembled", flush=True)
        return 1

    membership = MembershipView.for_config(cfg_hb, configured=world)
    handle = _holdable_handle(hb_dir, rank, membership,
                              CoordinationConfig.for_lease(LEASE_S))
    scripted = None if resize_mode else ScriptedReplan(handle, 0, PROPOSE_AT)
    client = None
    if resize_mode:
        client = TrainLeaseClient(
            LeaseLedger(hb_dir), initial_chips=tuple(
                int(c) for c in os.environ["FT_CHIPS"].split(",")),
            on_resize=lambda chips, plan: None,  # rank-local: keep the step
            coordination=handle, poll_interval_s=0.1)
    supervision = Supervision(
        supervisor=supervisor, membership=membership, configured_world=world,
        step_timeout_s=60.0, on_shrink=lambda n, plan: None,
        nbytes_hint=1 << 16, coordination=handle, feedback=scripted)
    payload: dict = {"rank": rank}
    rc = 0
    with flight_recorder(obs_dir, rank=rank) as rec:
        try:
            result = fit(_w0(), _toy_step(step_sleep), _ToyData(),
                         FitConfig(num_steps=steps, ckpt_dir=ckpt_dir,
                                   ckpt_every=5, log_every=0, prefetch=0),
                         supervision=supervision, arbiter=client)
            payload.update(
                final_step=int(result.state["step"]),
                state_sha=_state_sha(result.state),
                control_epochs=result.report.control_epochs,
                membership_epochs=result.report.membership_epochs,
                lease_epochs=result.report.lease_epochs,
                feedback_replans=result.report.feedback_replans,
                fenced=False)
        except EpochFenced as e:
            payload.update(fenced=True, fence_error=str(e)[:200])
            rc = _FENCED_RC
        payload["dumps"] = rec.dumps
        payload["dump_path"] = rec.dump_path
    if client is not None:
        payload["lease_acked"] = client.ledger.acked_epoch("train")
        payload["lease_control_epoch"] = \
            client.ledger.acked_control_epoch("train")
    print("COORD_JSON: " + json.dumps(payload), flush=True)
    return rc


def gloo_fold_launches(n: int, topo, count: int, chunks: int) -> int:
    """The fold kernel's launches on one rank of a process group for one
    allreduce of ``count`` elements, from the code: one fold a stage in
    which the rank owns a tile (``allreduce.call_shape``), for each of
    the head's ``chunks`` pieces, and one fold of the ranks' tails."""
    from ..parallel.allreduce import call_shape, chunk_sizes

    head = count - count % n
    launches = 0
    for size in chunk_sizes(head, n, chunks) if head else []:
        launches += len(call_shape(n, topo, size).folds)
    return launches + (1 if count > head else 0)


def child_gloo() -> int:
    """One rank of the gloo world (module docstring)."""
    import numpy as np
    import torch

    from ..obs import flight_recorder
    from ..ops import reduce_stacked as rs
    from ..parallel.allreduce import allreduce
    from ..parallel.launch import (
        ClusterConfig,
        init_distributed,
        shutdown_distributed,
    )
    from ..runtime import MembershipView, Supervisor, SupervisorConfig
    from ..runtime.coordination import CoordinationConfig, CoordinationHandle

    dev = torch.device(os.environ["FT_DEVICE"])
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    init_distributed(ClusterConfig.from_env(), backend="gloo", device=dev,
                     timeout=120.0, retries=0)
    try:
        import torch.distributed as dist

        rank, n = dist.get_rank(), dist.get_world_size()
        steps = int(os.environ["FT_STEPS"])
        count = int(os.environ["FT_GLOO_COUNT"])
        hb_dir = os.environ["FT_HB_DIR"]
        replan = os.environ.get("FT_GLOO_REPLAN") == "1"
        topo = str(n)

        # this rank's gradient: seeded once, scaled a step (a fresh draw
        # of 16.8M normals a step would time numpy, not the wire)
        base = torch.from_numpy(np.random.default_rng(1000 + rank)
                                .standard_normal(count).astype(np.float32))

        def grad_row(step, on=dev):
            return (base * (1.0 + 0.001 * step)).to(on)

        def reduce(x, chunks):
            out = allreduce(x, None, topo, "sum", chunks)
            if out.is_cuda:
                torch.cuda.synchronize(out.device)
            return out

        # the chunk-pipelined twin is the same bits (a schedule property)
        probe = grad_row(0)
        twin_bitwise = bool(torch.equal(reduce(probe, 1).view(torch.int32),
                                        reduce(probe, 2).view(torch.int32)))
        cfg_hb = SupervisorConfig(rank=rank, dir=hb_dir,
                                  interval_s=HB_INTERVAL,
                                  straggler_s=STRAGGLER_S, lease_s=LEASE_S)
        w = torch.zeros(count, dtype=torch.float32, device=dev)
        chunks, proposed, applied, host_ok = 1, False, [], []
        launches, want = 0, 0
        with flight_recorder(os.environ["FT_OBS_DIR"], rank=rank):
            with Supervisor(cfg_hb) as sup:
                membership = MembershipView.for_config(cfg_hb, configured=n)
                handle = CoordinationHandle(
                    hb_dir, rank, membership=membership,
                    cfg=CoordinationConfig.for_lease(
                        LEASE_S, apply_margin_steps=GLOO_MARGIN))
                rs.reduce_sources.launches = 0
                for step in range(steps):
                    dec = handle.gate(step)  # blocks at the boundary
                    if dec is not None:
                        chunks = int(dec.payload["chunks"])
                        handle.mark_applied(dec)
                        applied.append({"step": step, "epoch": dec.epoch,
                                        "fingerprint": dec.fingerprint})
                    if (replan and not proposed and rank == 0
                            and step >= GLOO_PROPOSE_AT):
                        proposed = handle.propose(
                            "replan", {"chunks": 2, "topo": topo},
                            apply_step=handle.suggest_apply_step(),
                        ) is not None
                    before = rs.reduce_sources.launches
                    out = reduce(grad_row(step), chunks)
                    launches += rs.reduce_sources.launches - before
                    want += gloo_fold_launches(n, topo, count, chunks) \
                        if dev.type == "cuda" else 0
                    if step in GLOO_HOST_CHECKS:
                        # the same allreduce on host copies of the rows:
                        # the plain fold, the same bits
                        host = reduce(grad_row(step, "cpu"), chunks)
                        host_ok.append(bool(torch.equal(
                            out.cpu().view(torch.int32),
                            host.view(torch.int32))))
                    w -= 0.01 * out
                    sup.record_step(step, STEP_SLEEP)
                    time.sleep(0.05)  # keep the ranks loosely in step
        payload = {
            "rank": rank, "final_step": steps, "device": str(dev),
            "count": count,
            "state_sha": hashlib.sha256(
                w.cpu().numpy().tobytes()).hexdigest(),
            "chunk_twin_bitwise": twin_bitwise, "applied": applied,
            "final_chunks": chunks, "host_copies_bitwise": host_ok,
            "fold_launches": launches, "fold_launches_want": want,
        }
    finally:
        shutdown_distributed()
    print("COORD_JSON: " + json.dumps(payload), flush=True)
    return 0


def child_twin() -> int:
    """The unfaulted twin: the same model, data and steps with no
    supervision, coordination or fault; its hash is the oracle."""
    from ..parallel.loop import FitConfig, fit

    result = fit(_w0(), _toy_step(0.0), _ToyData(),
                 FitConfig(num_steps=int(os.environ["FT_STEPS"]),
                           log_every=0, prefetch=0))
    print("COORD_JSON: " + json.dumps({
        "final_step": int(result.state["step"]),
        "state_sha": _state_sha(result.state)}), flush=True)
    return 0


# --------------------------------------------------------------------------
# the parent
# --------------------------------------------------------------------------


def _spawn(role: str, env: dict) -> subprocess.Popen:
    path = os.environ.get("PYTHONPATH")
    return subprocess.Popen(
        [sys.executable, "-m", "flextree_tpu_torch.tools.coord_chaos",
         "--child"],
        cwd=ROOT,
        env={**os.environ, "FT_COORD_ROLE": role,
             "PYTHONPATH": ROOT + (os.pathsep + path if path else ""),
             "OMP_NUM_THREADS": "1", **env},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _payload(log: str) -> dict:
    for line in log.splitlines():
        if line.startswith("COORD_JSON: "):
            return json.loads(line[len("COORD_JSON: "):])
    return {}


def _read_ctrl(path):
    from ..runtime import read_control_json

    return read_control_json(path)


def _wait_for(pred, timeout: float, what: str, procs=()):
    deadline = time.time() + timeout
    while time.time() < deadline:
        out = pred()
        if out:
            return out
        if procs and any(p.poll() is not None for p in procs):
            raise RuntimeError(f"a child exited before {what}")
        time.sleep(0.03)
    raise TimeoutError(f"never observed: {what}")


def _harvest(procs, timeout=CHILD_TIMEOUT_S):
    """Every child's output and exit code within one shared deadline; on
    a timeout the rest are killed (no orphan keeps a device)."""
    outs, rcs = [], []
    deadline = time.time() + timeout
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            for q in procs:
                if q.poll() is None:
                    q.kill()
            out, _ = p.communicate()
            out += "\n[parent] TIMEOUT"
        outs.append(out)
        rcs.append(p.returncode)
    return outs, rcs


def _kill_all(procs) -> None:
    for p in procs:
        if p.poll() is None:
            try:
                os.kill(p.pid, signal.SIGCONT)
            except OSError:
                pass
            p.kill()
        p.wait()
        if p.stdout is not None:
            p.stdout.close()


def _double_applies(obs_dir: str) -> int:
    """``coord_apply`` events per (rank, epoch) beyond the first."""
    from ..obs.timeline import read_dir

    counts: dict = {}
    for ev in read_dir(obs_dir)[0]:
        if ev.get("kind") == "coord_apply":
            key = (ev.get("rank"), ev.get("epoch"))
            counts[key] = counts.get(key, 0) + 1
    return sum(c - 1 for c in counts.values() if c > 1)


def _dump_with_phase(obs_dir: str) -> dict | None:
    from ..obs.timeline import read_dir

    _, dumps = read_dir(obs_dir)
    for rank in sorted(dumps):
        d = dumps[rank]
        if d.get("coord_phase") is not None:
            return {"rank": rank, "reason": d.get("reason"),
                    "coord_phase": d.get("coord_phase")}
    return None


def _trails(payloads):
    return [[(e["epoch"], e["fingerprint"]) for e in p.get(
        "control_epochs", ())] for p in payloads]


def _replan_fingerprint() -> str:
    from ..runtime.coordination import decision_fingerprint

    return decision_fingerprint("replan", _replan_payload())


def run_twin(workdir: str) -> dict:
    p = _spawn("twin", {"FT_STEPS": str(STEPS)})
    (out,), (rc,) = _harvest([p])
    if rc != 0:
        raise RuntimeError(f"twin failed:\n{out[-1500:]}")
    return _payload(out)


def _matrix_env(workdir: str, rank: int, extra=None) -> dict:
    return {"FT_RANK": str(rank), "FT_WORLD": str(WORLD),
            "FT_STEPS": str(STEPS), "FT_HB_DIR": os.path.join(workdir, "hb"),
            "FT_OBS_DIR": os.path.join(workdir, "obs"),
            "FT_CKPT_DIR": os.path.join(workdir, f"ck{rank}"),
            **(extra or {})}


def _dirs(workdir):
    hb, obs = os.path.join(workdir, "hb"), os.path.join(workdir, "obs")
    os.makedirs(hb, exist_ok=True)
    os.makedirs(obs, exist_ok=True)
    return hb, obs


def run_kill_scenario(workdir: str, phase: str, twin: dict) -> dict:
    """SIGKILL the coordinator at ``phase``: propose, ackwait or commit."""
    hb, obs = _dirs(workdir)
    hold = {"propose": "selfack", "ackwait": "commit", "commit": ""}[phase]
    procs = [_spawn("worker", _matrix_env(
        workdir, r, {"FT_COORD_HOLD": hold} if r == 0 and hold else None))
        for r in range(WORLD)]
    prop_path = os.path.join(hb, "coord_proposal.json")
    try:
        if phase == "propose":
            _wait_for(lambda: _read_ctrl(prop_path), 60, "proposal", procs)
        elif phase == "ackwait":
            def all_acked():
                prop = _read_ctrl(prop_path)
                if not prop:
                    return False
                acks = [_read_ctrl(os.path.join(hb, f"coord_ack_{r:05d}.json"))
                        for r in range(WORLD)]
                return all(a is not None and a.get("epoch", -1)
                           >= prop["epoch"] for a in acks)

            _wait_for(all_acked, 60, "all acks", procs)
        else:
            _wait_for(lambda: _read_ctrl(os.path.join(
                hb, "coord_commit.json")), 60, "commit", procs)
        os.kill(procs[0].pid, signal.SIGKILL)
        kill_wall = time.time()
        outs, rcs = _harvest(procs)
    finally:
        _kill_all(procs)
    payloads = [_payload(o) for o in outs]
    survivors = [payloads[r] for r in (1, 2)]
    commit = _read_ctrl(os.path.join(hb, "coord_commit.json"))
    commit_wall = float(commit["wall"]) if commit else None
    recovery = (max(0.0, commit_wall - kill_wall) / LEASE_S
                if commit_wall is not None and phase != "commit" else None)
    trails = _trails(survivors)
    shas = {s.get("state_sha") for s in survivors}
    dump = _dump_with_phase(obs)
    floors = {
        "survivors_completed": all(rcs[r] == 0 and payloads[r].get(
            "final_step") == STEPS for r in (1, 2)),
        "same_control_trail": bool(len(set(map(tuple, trails))) == 1
                                   and trails[0]),
        "replan_applied": any(e[1] == _replan_fingerprint()
                              for e in (trails[0] or ())),
        "bitwise_vs_twin": shas == {twin["state_sha"]},
        "zero_double_applies": _double_applies(obs) == 0,
        "fault_dump_with_phase": dump is not None,
        "recovery_within_bound": recovery is None
        or recovery <= RECOVERY_BOUND_WINDOWS,
    }
    return {"scenario": f"kill_coordinator_at_{phase}",
            "injection": f"SIGKILL of rank 0 at handshake phase {phase}",
            "ok": all(floors.values()), "floors": floors,
            "checks": {"rcs": rcs, "recovery_windows": recovery,
                       "control_trails": trails, "state_shas": sorted(
                           s for s in shas if s),
                       "twin_sha": twin["state_sha"], "dump": dump,
                       "commit_epoch": commit["epoch"] if commit else None,
                       "log_tail": outs[1].splitlines()[-8:]}}


def run_stall_scenario(workdir: str, twin: dict) -> dict:
    """SIGSTOP rank 2 past the ack deadline: excluded, then fenced on
    SIGCONT (exit code 3 and a ``coord_fence`` dump)."""
    hb, obs = _dirs(workdir)
    procs = [_spawn("worker", _matrix_env(workdir, r)) for r in range(WORLD)]
    try:
        def rank2_at(at):
            beat = _read_ctrl(os.path.join(hb, "hb_00002.json"))
            return beat is not None and beat.get("step", -1) >= at

        _wait_for(lambda: rank2_at(3), 60, "rank 2 at step 3", procs)
        os.kill(procs[2].pid, signal.SIGSTOP)
        stop_wall = time.time()

        def excluding_commit():
            c = _read_ctrl(os.path.join(hb, "coord_commit.json"))
            return c if (c and 2 not in c["participants"]) else None

        commit = _wait_for(excluding_commit, 60, "a commit without rank 2")
        os.kill(procs[2].pid, signal.SIGCONT)
        outs, rcs = _harvest(procs)
    finally:
        _kill_all(procs)
    from ..obs.timeline import read_dir

    payloads = [_payload(o) for o in outs]
    survivors = payloads[:2]
    shas = {s.get("state_sha") for s in survivors}
    trails = _trails(survivors)
    _, dumps = read_dir(obs)
    fence_dump = None
    if 2 in dumps and dumps[2].get("reason") == "coord_fence":
        fence_dump = {"reason": dumps[2]["reason"],
                      "coord_phase": dumps[2].get("coord_phase")}
    floors = {
        "survivors_completed": all(rcs[r] == 0 and payloads[r].get(
            "final_step") == STEPS for r in (0, 1)),
        "stalled_rank_fenced": rcs[2] == _FENCED_RC
        and payloads[2].get("fenced") is True,
        "fence_dump_with_phase": fence_dump is not None
        and fence_dump.get("coord_phase") is not None,
        "same_control_trail": bool(len(set(map(tuple, trails))) == 1
                                   and trails[0]),
        "bitwise_vs_twin": shas == {twin["state_sha"]},
        "zero_double_applies": _double_applies(obs) == 0,
        "excluded_from_commit": 2 not in commit["participants"],
    }
    return {"scenario": "stalled_follower_fenced",
            "injection": "SIGSTOP of rank 2 past the ack deadline, then "
                         "SIGCONT",
            "ok": all(floors.values()), "floors": floors,
            "checks": {"rcs": rcs, "stop_to_commit_s":
                       float(commit["wall"]) - stop_wall,
                       "control_trails": trails, "fence_dump": fence_dump,
                       "fence_error": payloads[2].get("fence_error"),
                       "log_tail": outs[2].splitlines()[-8:]}}


def run_torn_scenario(workdir: str, twin: dict) -> dict:
    """A scribbler tears the control files mid-handshake: truncate to a
    random prefix, hold the torn bytes a moment, restore."""
    hb, obs = _dirs(workdir)
    stop = threading.Event()
    torn = {"n": 0}

    def scribbler():
        rng = random.Random(7)
        names = ["coord_proposal.json", "coord_commit.json",
                 "coord_ack_00000.json", "coord_ack_00001.json",
                 "coord_ack_00002.json", "lease_ledger.json",
                 "hb_00001.json"]
        while not stop.is_set():
            path = os.path.join(hb, rng.choice(names))
            try:
                with open(path, "rb") as f:
                    raw = f.read()
                if len(raw) > 2:
                    with open(path, "wb") as f:
                        f.write(raw[:rng.randrange(1, len(raw))])
                    torn["n"] += 1
                    time.sleep(0.02)  # the torn window readers see
                    with open(path, "wb") as f:
                        f.write(raw)
            except OSError:
                pass
            time.sleep(0.03)

    procs = [_spawn("worker", _matrix_env(workdir, r)) for r in range(WORLD)]
    thread = threading.Thread(target=scribbler, daemon=True)
    thread.start()
    try:
        outs, rcs = _harvest(procs)
    finally:
        stop.set()
        thread.join(timeout=5)
        _kill_all(procs)
    from ..obs.timeline import read_dir

    payloads = [_payload(o) for o in outs]
    shas = {p.get("state_sha") for p in payloads}
    trails = _trails(payloads)
    torn_events = sum(1 for e in read_dir(obs)[0]
                      if e.get("kind") == "torn_control_file")
    floors = {
        "all_completed": all(rcs[r] == 0 and payloads[r].get("final_step")
                             == STEPS for r in range(WORLD)),
        "same_control_trail": bool(len(set(map(tuple, trails))) == 1
                                   and trails[0]),
        "replan_applied": any(e[1] == _replan_fingerprint()
                              for e in (trails[0] or ())),
        "bitwise_vs_twin": shas == {twin["state_sha"]},
        "zero_double_applies": _double_applies(obs) == 0,
    }
    return {"scenario": "torn_ledger",
            "injection": f"{torn['n']} truncate-hold-restore tears across "
                         "the control files",
            "ok": all(floors.values()), "floors": floors,
            "checks": {"rcs": rcs, "tears_injected": torn["n"],
                       "torn_events_observed": torn_events,
                       "control_trails": trails}}


def run_resize_scenario(workdir: str, twin: dict) -> dict:
    """This process plays arbiter: a grant change flows propose → commit
    → group apply, bitwise resumes, the lease ack fenced on the committed
    control epoch."""
    from ..runtime import LeaseLedger

    hb, obs = _dirs(workdir)
    ledger = LeaseLedger(hb)
    ledger.publish(0, {"train": (0, 1, 2, 3)}, reason="initial")
    procs = [_spawn("worker", _matrix_env(
        workdir, r, {"FT_COORD_RESIZE": "1", "FT_CHIPS": "0,1,2,3"}))
        for r in range(WORLD)]
    try:
        def rank0_at(at):
            beat = _read_ctrl(os.path.join(hb, "hb_00000.json"))
            return beat is not None and beat.get("step", -1) >= at

        _wait_for(lambda: rank0_at(PROPOSE_AT), 60, "steady state", procs)
        ledger.publish(1, {"train": (0, 1), "arbiter": (2, 3)},
                       reason="chaos revoke")
        outs, rcs = _harvest(procs)
    finally:
        _kill_all(procs)
    payloads = [_payload(o) for o in outs]
    shas = {p.get("state_sha") for p in payloads}
    trails = _trails(payloads)
    resizes = [p.get("lease_epochs", []) for p in payloads]
    floors = {
        "all_completed": all(rcs[r] == 0 and payloads[r].get("final_step")
                             == STEPS for r in range(WORLD)),
        "same_control_trail": bool(len(set(map(tuple, trails))) == 1
                                   and trails[0]),
        "resize_applied_once_per_rank": all(
            len(r) == 1 and r[0]["epoch"] == 1 for r in resizes),
        "bitwise_resume_everywhere": all(
            r and r[0]["bitwise_resume"] for r in resizes),
        "ack_carries_control_epoch": all(
            p.get("lease_acked") == 1
            and p.get("lease_control_epoch") is not None for p in payloads),
        "bitwise_vs_twin": shas == {twin["state_sha"]},
        "zero_double_applies": _double_applies(obs) == 0,
    }
    return {"scenario": "coordinated_resize",
            "injection": "the arbiter revokes chips 2,3 mid-run (lease "
                         "epoch 1)",
            "ok": all(floors.values()), "floors": floors,
            "checks": {"rcs": rcs, "control_trails": trails,
                       "lease_epochs": resizes,
                       "lease_control_epochs": [
                           p.get("lease_control_epoch") for p in payloads]}}


def run_gloo_scenario(workdir: str, device: str, count: int) -> dict:
    """Three processes on a gloo wire: the committed replan flips every
    rank to the chunk-pipelined schedule at one agreed boundary."""
    from ..parallel.launch import free_port

    def launch(tag: str, replan: bool):
        hb = os.path.join(workdir, f"hb_{tag}")
        obs = os.path.join(workdir, f"obs_{tag}")
        os.makedirs(hb, exist_ok=True)
        os.makedirs(obs, exist_ok=True)
        base = dict(FT_STEPS=str(GLOO_STEPS), FT_HB_DIR=hb, FT_OBS_DIR=obs,
                    FT_GLOO_REPLAN="1" if replan else "0",
                    FT_COORDINATOR=f"127.0.0.1:{free_port()}",
                    FT_NUM_PROCESSES=str(WORLD), FT_DEVICE=device,
                    FT_GLOO_COUNT=str(count))
        procs = [_spawn("gloo", dict(base, FT_PROCESS_ID=str(r)))
                 for r in range(WORLD)]
        try:
            outs, rcs = _harvest(procs, timeout=2 * CHILD_TIMEOUT_S)
        finally:
            _kill_all(procs)
        return [_payload(o) for o in outs], rcs, outs

    payloads, rcs, outs = launch("replan", True)
    twin_payloads, twin_rcs, _ = launch("twin", False)
    shas = {p.get("state_sha") for p in payloads}
    twin_shas = {p.get("state_sha") for p in twin_payloads}
    applied = [p.get("applied", []) for p in payloads]
    floors = {
        "wire_completed": all(rc == 0 for rc in rcs),
        "twin_completed": all(rc == 0 for rc in twin_rcs),
        "chunk_twin_bitwise": all(p.get("chunk_twin_bitwise")
                                  for p in payloads),
        "replan_applied_same_epoch_everywhere": (
            all(len(a) == 1 for a in applied)
            and len({(a[0]["epoch"], a[0]["fingerprint"])
                     for a in applied if a}) == 1
            and all(p.get("final_chunks") == 2 for p in payloads)),
        "same_apply_boundary": len({a[0]["step"] for a in applied
                                    if a}) == 1,
        "ranks_bitwise_identical": len(shas) == 1,
        "bitwise_vs_unfaulted_twin": shas == twin_shas and len(shas) == 1,
        "host_copies_bitwise": all(
            p.get("host_copies_bitwise") == [True] * len(GLOO_HOST_CHECKS)
            for p in payloads + twin_payloads),
        "fold_launches_the_codes": all(
            p.get("fold_launches") == p.get("fold_launches_want")
            for p in payloads + twin_payloads),
    }
    return {"scenario": "gloo_group_replan",
            "injection": "a coordinated replan (the chunk-pipelined twin) "
                         f"on a live {WORLD}-process gloo wire, "
                         f"{count} f32 a rank on {device}",
            "ok": all(floors.values()), "floors": floors,
            "checks": {"rcs": rcs, "twin_rcs": twin_rcs, "applied": applied,
                       "state_shas": sorted(s for s in shas if s),
                       "twin_shas": sorted(s for s in twin_shas if s),
                       "fold_launches": [p.get("fold_launches")
                                         for p in payloads],
                       "twin_fold_launches": [p.get("fold_launches")
                                              for p in twin_payloads],
                       "log_tail": outs[0].splitlines()[-8:]}}


SMOKE = ("kill_ackwait", "torn", "resize", "gloo")
FULL = ("kill_propose", "kill_ackwait", "kill_commit", "stall", "torn",
        "resize", "gloo")


def run_matrix(scenarios, device: str, count: int, log=print) -> list:
    """Run ``scenarios``; returns their results in that order.  The twin,
    a host process, runs beside the gloo world, which does not read it,
    so the gloo world goes first."""
    results = {}
    with tempfile.TemporaryDirectory(prefix="ft-coord-chaos-") as wd, \
            concurrent.futures.ThreadPoolExecutor(1) as ex:
        twin_run = ex.submit(run_twin, wd)
        twin = None
        for name in sorted(scenarios, key=lambda n: n != "gloo"):
            if name != "gloo" and twin is None:
                twin = twin_run.result()
                log(f"twin: step {twin['final_step']} "
                    f"sha {twin['state_sha'][:16]}")
            sub = os.path.join(wd, name)
            os.makedirs(sub, exist_ok=True)
            t0 = time.monotonic()
            try:
                if name.startswith("kill_"):
                    res = run_kill_scenario(sub, name[len("kill_"):], twin)
                elif name == "stall":
                    res = run_stall_scenario(sub, twin)
                elif name == "torn":
                    res = run_torn_scenario(sub, twin)
                elif name == "resize":
                    res = run_resize_scenario(sub, twin)
                else:
                    res = run_gloo_scenario(sub, device, count)
            except Exception as e:  # a crashed scenario is a failed floor
                res = {"scenario": name, "ok": False, "floors": {},
                       "error": f"{type(e).__name__}: {e}"}
            res["seconds"] = time.monotonic() - t0
            log(f"scenario {res['scenario']}: "
                f"{'OK' if res['ok'] else 'FAILED'} "
                + json.dumps(res.get("floors", {}))
                + (f" {res['error']}" if "error" in res else "")
                + f" ({res['seconds']:.1f} s)")
            results[name] = res
        twin_run.result()  # a failed twin fails the matrix
    return [results[name] for name in scenarios]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--smoke", action="store_true",
                    help="the subset " + ", ".join(SMOKE))
    ap.add_argument("--device", default=None,
                    help="the gloo world's device: cuda (default) or cpu")
    ap.add_argument("--gloo-count", type=int, default=GLOO_COUNT,
                    help="f32 elements a rank in the gloo world")
    ap.add_argument("--out", default=os.path.join("tmp", "coord_chaos.json"))
    args = ap.parse_args(argv)
    if args.child:
        role = os.environ.get("FT_COORD_ROLE", "worker")
        return {"gloo": child_gloo, "twin": child_twin}.get(
            role, child_worker)()
    out = checked_out(ap, args.out)
    from ..device import resolve_device

    device = str(resolve_device(args.device))
    results = run_matrix(SMOKE if args.smoke else FULL, device,
                         args.gloo_count)
    ok = all(r["ok"] for r in results)
    doc = {
        "ok": ok, "smoke": args.smoke, "device": device,
        "budgets": {"heartbeat_interval_s": HB_INTERVAL,
                    "straggler_s": STRAGGLER_S, "lease_s": LEASE_S,
                    "step_sleep_s": STEP_SLEEP,
                    "recovery_bound_lease_windows": RECOVERY_BOUND_WINDOWS},
        "world": WORLD, "steps": STEPS, "gloo_count": args.gloo_count,
        "recovery_windows": {
            r["scenario"]: r["checks"]["recovery_windows"] for r in results
            if r.get("checks", {}).get("recovery_windows") is not None},
        "scenarios": {r["scenario"]: r for r in results},
        "finished": datetime.datetime.now(datetime.timezone.utc).isoformat(
            timespec="seconds"),
    }
    with open(out, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
    print(f"wrote {out} (ok={ok})")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
