"""Executed chaos for elastic serving tenancy: a real-process replica fleet
holding chips through the lease ledger, scaled by the arbiter.

    python -m flextree_tpu_torch.tools.serve_elastic_chaos [--smoke]
        [--only NAME,...] [--out PATH]
    python -m flextree_tpu_torch.tools.serve_elastic_chaos --device cpu \\
        --only drain_race

The port's counterpart of the JAX package's
``tools/serve_elastic_chaos.py``: replica processes
(``python -m flextree_tpu_torch.serving.replica_main``, given ``--cpu`` on
the CPU, float32 on the paged kernel on a card) behind a real :class:`FrontDoor`,
holding chips through :class:`~..runtime.ServeLeaseClient` under a
:class:`~..arbiter.PoolArbiter` that reads the front door's
``metrics_fd_*.json`` windows.  Each floor is checked (exit 1 on any
violation):

- ``autoscale`` (``elastic_autoscale``): a ZeRO-1 trainer in a process of
  its own (``fit(arbiter=TrainLeaseClient(...))``, dp-3 on its in-process
  mesh) and a one-replica fleet share four chips; an open-loop burst
  breaches the windowed TTFT p99; the arbiter preempts two training
  chips, training checkpoints and shrinks (a bitwise resume), the grant
  activates two pre-warmed standby replicas; p99 recovers within two
  windows; a sustained clear returns the chips, the revoked replicas
  SIGTERM-drain before the serve ack releases them, and training expands
  again, bitwise.  Every observed ledger publish holds one holder a chip.
- ``handoff`` (``prefix_handoff_warm_vs_cold``): a draining replica
  exports its radix prefix index, the successor pre-warms from it and the
  front door's affinity follows; the successor's first-touch hit rate
  reaches half the predecessor's, against a cold successor.
- ``sigkill_handoff`` (``sigkill_mid_handoff``): the drainer SIGKILLed
  before its export lands: no handoff file, the successor cold-starts
  loudly, every in-flight request completes exactly once.
- ``arbiter_restart`` (``arbiter_restart_mid_grant``): the arbiter
  dropped between parking chips and the grant; a new one rebuilds its
  inventory from the ledger, resumes the pending handoff from
  ``arbiter_state.json``, completes the grant, and a real replica serves
  on the granted chip.
- ``drain_race`` (``drains_races_revoke``): a revoke lands while requests
  are in flight on the revoked chip: an ack before the drain raises
  ``ProtocolViolation`` and writes no ack; the drain-then-ack path
  completes exactly once.
- ``shed_miss_first`` (``shed_miss_first_load``): at one max-inflight
  cap, reserving headroom for predicted prefix hits beats the flat
  policy on admitted-token throughput.

Every result's tokens are held to ``rpc_chaos.Oracle`` (the
single-process ``generate`` on the replicas' weights, float32, greedy).  On one card the
four chips are logical slots, as in ``tools.arbiter_spike``: the
trainer's in-process mesh ranks and the replica processes.  ``--smoke``
runs :data:`SMOKE`; results go to ``--out`` (default
``tmp/serve_elastic_chaos.json``), under ``tmp/``.
"""

from __future__ import annotations

import collections
import datetime
import json
import os
import signal
import subprocess
import sys
import time
from collections import deque

import numpy as np

from . import checked_out
from . import rpc_chaos as rc

ROOT = rc.ROOT
_mono = time.monotonic

WINDOW_S = 6.0
TICK_S = 0.4
# the front door's TTFT is time to result over the RPC (one call answers
# the whole generation), so the SLO sits above an unloaded completion and
# the breach is queueing delay
SLO_P99_MS = 1500.0
CHIPS = (0, 1, 2, 3)
TRAIN_CHIPS = (0, 1, 2)  # chip 3 is serving's baseline replica
BURST_CHIPS = 2
# decode pacing (FT_RPC_DECODE_SLEEP): a fixed sleep a round maps
# capacity to the replica count, not to the host's scheduling luck
DECODE_SLEEP = "0.02"
READY_TIMEOUT_S = 240.0
HANDOFF_SUFFIX_WARM = "32:4"  # a cached 32-token prefix, 4-token suffixes
#: the autoscale trainer process's deadline after its SIGTERM
TRAIN_CHILD_TIMEOUT_S = 600.0


def _strk(d: dict) -> dict:
    return {str(k): v for k, v in d.items()}


def _spawn(ctrl, rank, device, extra_env=None, extra_args=(),
           warm_lens=rc.PROMPT_LENS, warm_max_new: int = 48,
           suffix_lens: str = ""):
    return rc.spawn_replica(ctrl, rank, device, extra_env, extra_args,
                            warm_lens=warm_lens, warm_max_new=warm_max_new,
                            suffix_lens=suffix_lens)


def _submit(fd, req) -> bool:
    return fd.submit(req["rid"], req["prompt"], req["max_new"])


def _as_req(r) -> dict:
    return {"rid": r.rid, "prompt": np.asarray(r.prompt, np.int32),
            "max_new": r.max_new_tokens}


def _prefix_pool(seed: int, n: int, length: int = 32) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 64, (length,)).astype(np.int32)
            for _ in range(n)]


def _prefix_req(rid, prefix, rng, suffix_len=4, max_new=8) -> dict:
    suffix = rng.integers(0, 64, (suffix_len,)).astype(np.int32)
    return {"rid": rid,
            "prompt": np.concatenate([np.asarray(prefix, np.int32), suffix]),
            "max_new": max_new}


def _prefix_hit_rids(events, lo: int, hi: int) -> set:
    return {int(e["rid"]) for e in events
            if e.get("kind") == "serve_prefix_hit"
            and lo <= e.get("rid", -1) < hi}


def _single_holder(docs: dict, chipset: set) -> dict:
    out = {}
    for epoch, grants in sorted(docs.items()):
        seen = [c for chips in grants.values() for c in chips]
        out[epoch] = len(seen) == len(set(seen)) and set(seen) == chipset
    return out


class FleetManager:
    """Binds :class:`ServeLeaseClient`'s hooks to the real fleet: a grant
    activates a pre-warmed standby replica (its endpoint file copied from
    the staging directory into the live one, where the front door finds
    it at once); a revoke SIGTERM-drains the replicas of the revoked chips
    and returns once they exited, so the ack that follows means the chips
    are free.  :meth:`inflight` counts the front door's outstanding
    requests on replicas revoked but not yet drained: the drain fence's
    evidence."""

    def __init__(self, fd, ctrl, procs, device, *, staging=None,
                 standby_ranks=(), chip_to_rank=None,
                 decode_sleep=DECODE_SLEEP):
        self.fd, self.ctrl, self.procs = fd, ctrl, procs
        self.device = device
        self.staging = staging
        self.standby: deque = deque(standby_ranks)
        self.chip_to_rank: dict = dict(chip_to_rank or {})
        self.pending_revoke: set = set()
        self.drain_rcs: dict = {}
        self._next_rank = 1 + max(list(procs) + list(standby_ranks),
                                  default=0)
        self._decode_sleep = decode_sleep
        self.activated: list = []  # (wall, rank) of each granted replica

    def note_directive(self, d) -> None:
        """Record the replicas a directive revokes before it is applied:
        from here until their drain ends, an ack while they hold work is
        a protocol violation."""
        self.pending_revoke |= {self.chip_to_rank[c] for c in d.revoked
                                if c in self.chip_to_rank}

    def inflight(self) -> int:
        return sum(self.fd.clients[r].outstanding
                   for r in self.pending_revoke if r in self.fd.clients)

    def _await_standby(self, rank: int):
        from ..runtime.ctrlfile import read_control_json
        from ..serving.rpc import RpcConnection, RpcError

        path = os.path.join(self.staging, f"rpc_{rank:05d}.json")
        deadline = _mono() + READY_TIMEOUT_S
        while _mono() < deadline:
            ep = read_control_json(path)
            if ep is not None:
                try:
                    conn = RpcConnection.connect(ep["host"], int(ep["port"]),
                                                 timeout_s=1.0)
                    try:
                        if conn.call({"kind": "ping"},
                                     timeout_s=2.0).get("ok"):
                            return ep
                    finally:
                        conn.close()
                except RpcError:
                    pass
            time.sleep(0.1)
        raise TimeoutError(f"standby replica {rank} never became ready")

    def on_grant(self, chips) -> None:
        from ..runtime.ctrlfile import write_control_json

        for c in chips:
            rank = self.standby.popleft()
            ep = self._await_standby(rank)
            write_control_json(self.ctrl, os.path.join(
                self.ctrl, f"rpc_{rank:05d}.json"), ep)
            self.chip_to_rank[c] = rank
        self.fd.refresh()
        self.activated += [(time.time(), self.chip_to_rank[c])
                           for c in chips]

    def on_revoke(self, chips) -> None:
        ranks = [self.chip_to_rank[c] for c in chips]
        for r in ranks:
            if self.procs[r].poll() is None:
                try:
                    self.procs[r].send_signal(signal.SIGTERM)
                except OSError:
                    pass
        for c, r in zip(chips, ranks):
            proc = self.procs[r]
            try:
                proc.wait(timeout=30.0)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            self.drain_rcs[r] = proc.returncode
            if self.staging is not None:
                try:  # the live endpoint copy is ours to retract
                    os.unlink(os.path.join(self.ctrl, f"rpc_{r:05d}.json"))
                except OSError:
                    pass
            self.fd.forget_replica(r)
            self.pending_revoke.discard(r)
            del self.chip_to_rank[c]
            if self.staging is not None:
                # refill the standby bench for a later breach
                nr = self._next_rank
                self._next_rank += 1
                self.procs[nr] = _spawn(
                    self.staging, nr, self.device,
                    {"FT_RPC_DECODE_SLEEP": self._decode_sleep})
                self.standby.append(nr)


# --------------------------------------------------------------------------
# scenario 1: SLO autoscaling with the trainer in a process of its own
# --------------------------------------------------------------------------


def train_config(device: str):
    """The autoscale trainer's ``arbiter_spike.SpikeConfig``: phase 27's
    trainer on a card (the flagship, bf16, the flash kernels, 12 rows of
    1024, 0.1 s between steps), the JAX tool's small model on the CPU."""
    import dataclasses

    from .arbiter_spike import SpikeConfig
    from .chaos_runtime import FLAGSHIP

    cfg = SpikeConfig(device=device)
    if device.startswith("cuda"):
        cfg = dataclasses.replace(
            cfg, train_model=dict(FLAGSHIP), train_dtype="bfloat16",
            train_attn="flash", train_batch=12, train_seq=1024,
            train_pace_s=0.1)
    return cfg


def child_trainer() -> int:
    """The autoscale trainer process: ``fit(arbiter=TrainLeaseClient)``
    on the lease ledger in ``FT_HB_DIR``; each step appended to
    ``FT_TRACE`` as ``[wall, seconds, world]``; SIGTERM ends the run
    (the preemption guard) and the result is printed."""
    from ..device import resolve_device
    from ..ops import flash_attention as fa
    from ..ops import reduce_stacked as rs
    from ..planner.choose import replan_for_survivors
    from ..runtime import LeaseLedger, PreemptionGuard, TrainLeaseClient
    from .arbiter_spike import TrainWorlds, start_trainer

    dev = resolve_device(os.environ["FT_DEVICE"])
    cfg = train_config(str(dev))
    worlds = TrainWorlds(cfg, dev)
    nbytes = worlds.nbytes
    plans = {n: replan_for_survivors(n, nbytes, configured=len(TRAIN_CHIPS)
                                     ).to_ft_topo()
             for n in (len(TRAIN_CHIPS), len(TRAIN_CHIPS) - BURST_CHIPS)}
    trace_path = os.environ["FT_TRACE"]
    trace = open(trace_path, "a", buffering=1)  # a line a step

    class Traced(list):
        def append(self, item):
            super().append(item)
            trace.write(json.dumps(list(item)) + "\n")

    # before any build: each built step appends to this list
    worlds.step_trace = Traced()
    for n, topo in plans.items():
        worlds.warm(n, topo)
    kernels = {"flash_fwd": fa.flash_fwd, "flash_bwd_dq": fa.flash_bwd_dq,
               "flash_bwd_dkv": fa.flash_bwd_dkv,
               "reduce_sources": rs.reduce_sources}
    for fn in kernels.values():
        fn.launches = 0
    ledger = LeaseLedger(os.environ["FT_HB_DIR"])
    client = TrainLeaseClient(ledger, initial_chips=TRAIN_CHIPS,
                              configured=len(TRAIN_CHIPS),
                              nbytes_hint=nbytes, poll_interval_s=0.1)
    guard = PreemptionGuard().install()
    print("TRAINER_READY", flush=True)
    thread, holder = start_trainer(worlds, client, os.environ["FT_CKPT_DIR"],
                                   guard, plans, cfg)
    thread.join()
    trace.close()
    result = holder.get("result")
    ran = collections.Counter(n for _, _, n in worlds.step_trace)
    step_ms = {str(n): float(np.median([s * 1e3 for _, s, m in
                                        worlds.step_trace if m == n]))
               for n in sorted(ran)}
    print("TRAINER_JSON: " + json.dumps({
        "error": holder.get("error"),
        "lease_epochs": list(result.report.lease_epochs)
        if result is not None else [],
        "steps_by_world": {str(n): k for n, k in sorted(ran.items())},
        "step_ms_by_world": step_ms, "plans": {str(k): v for k, v in
                                               plans.items()},
        "device": str(dev), "model": cfg.train_model,
        "batch": [cfg.train_batch, cfg.train_seq],
        "launches": {k: fn.launches for k, fn in kernels.items()},
    }, default=str), flush=True)
    return 0


def _read_trace(path: str) -> list:
    try:
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]
    except (OSError, ValueError):
        return []


def _recovery_breakdown(ref, preempts, grants, recovery_wall, activated,
                        completed, arrivals, wall0, spike_end,
                        backlog) -> dict:
    """Where the time from ``ref`` = max(grant, burst end) to the first
    sub-SLO window goes, from the run's own records (walls, seconds):
    the trainer's drain, checkpoint and ack (preempt to grant, before
    ``ref`` when the grant is late); the granted standbys' activation
    (they booted, loaded the kernels and the weights, and warmed before
    any traffic); their first answers; the burst's backlog served; and
    the window's memory: a request answered over the SLO keeps the
    windowed p99 over it until it ages out of the window."""
    done = {rid: wall0 + arrivals[rid] + r.ttft_s
            for rid, r in completed.items()}
    act = max(w for w, _ in activated) if activated else None
    granted = {rank for _, rank in activated}
    first_new = min((w for rid, w in done.items()
                     if completed[rid].rank in granted
                     and act is not None and w >= act), default=None)
    slow = [w for rid, w in done.items()
            if completed[rid].ttft_s * 1e3 > SLO_P99_MS]
    burst = [w for rid, w in done.items() if arrivals[rid] <= spike_end]

    def rel(w):
        return None if w is None else w - ref

    at_ref = min(backlog, key=lambda b: abs(b[0] - ref))[1] if backlog \
        else None
    peak = max(backlog, key=lambda b: b[1]) if backlog else None
    return {
        "preempt_to_grant_s": (grants[0] - preempts[0]) if preempts
        else None,
        "grant_after_burst_end_s": grants[0] - (wall0 + spike_end),
        "activation_after_grant_s": None if act is None else act - grants[0],
        "first_answer_of_a_granted_replica_s": rel(first_new),
        "burst_backlog_served_s": rel(max(burst, default=None)),
        "last_answer_over_slo_s": rel(max(slow, default=None)),
        "window_age_out_s": (recovery_wall - max(slow)) if slow else None,
        "recovery_s": recovery_wall - ref,
        "backlog_at_ref": at_ref,
        "backlog_peak": None if peak is None else
        {"requests": peak[1], "at_s": rel(peak[0])},
        "answers_over_slo": len(slow),
        "answers_by_rank": {str(k): v for k, v in collections.Counter(
            r.rank for r in completed.values()).items()},
    }


def run_autoscale_scenario(workdir: str, oracle) -> dict:
    from ..arbiter import (
        ArbiterConfig,
        DeviceInventory,
        PoolArbiter,
        file_slo_reader,
    )
    from ..runtime import SERVE, TRAIN, LeaseLedger, ServeLeaseClient
    from ..serving.workload import build_spike_workload

    device = oracle.device
    ctrl, staging = os.path.join(workdir, "ctrl"), os.path.join(workdir,
                                                                "stage")
    hb, slo_dir = os.path.join(workdir, "hb"), os.path.join(workdir, "slo")
    ck = os.path.join(workdir, "ck")
    for d in (ctrl, staging, hb, slo_dir, ck):
        os.makedirs(d, exist_ok=True)
    trace_path = os.path.join(workdir, "train_trace.jsonl")

    # ~14 requests/s on one replica (4 slots, ~29 paced 10 ms rounds):
    # the 2/s baseline holds, the 20/s burst queues past the SLO, and
    # three replicas drain the backlog once the grant lands
    sleep = "0.01"
    env = {"FT_RPC_DECODE_SLEEP": sleep}
    procs = {0: _spawn(ctrl, 0, device, env)}
    procs.update({r: _spawn(staging, r, device, env) for r in (1, 2)})
    reqs, spike_start, spike_end = build_spike_workload(
        seed=13, base_rate=2.0, spike_rate=20.0, t_base=10.0, t_spike=12.0,
        t_tail=4.0, vocab=64)
    requests = [_as_req(r) for r in reqs]
    arrivals = {r.rid: r.arrival_s for r in reqs}

    ledger = LeaseLedger(hb)
    inventory = DeviceInventory(CHIPS, train=TRAIN_CHIPS)
    acfg = ArbiterConfig(
        slo_p99_ms=SLO_P99_MS, window_s=WINDOW_S, release_frac=0.5,
        breach_ticks=2, clear_ticks=10, cooldown_s=6.0, min_train_chips=1,
        burst_chips=BURST_CHIPS, min_samples=6)
    arbiter = PoolArbiter(inventory, ledger, acfg,
                          slo_reader=file_slo_reader(slo_dir,
                                                     window_s=WINDOW_S),
                          serve_is_tenant=True)
    path = os.environ.get("PYTHONPATH")
    trainer = subprocess.Popen(
        [sys.executable, "-m",
         "flextree_tpu_torch.tools.serve_elastic_chaos", "--child"],
        cwd=ROOT, env={**os.environ, "OMP_NUM_THREADS": "1",
                       "PYTHONPATH": ROOT + (os.pathsep + path
                                             if path else ""),
                       "FT_DEVICE": device, "FT_HB_DIR": hb,
                       "FT_CKPT_DIR": ck, "FT_TRACE": trace_path},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ledger_docs: dict = {}

    def observe_ledger():
        g = ledger.read()
        if g is not None:
            ledger_docs[g.epoch] = dict(g.grants)

    idle, fd, mgr, counts = False, None, None, {}
    train_log, train_rc = "", None
    try:
        rc.wait_ready(ctrl, [0], procs)
        rc.wait_ready(staging, [1, 2], procs)
        # wait for the trainer's first steps at dp-3 before any traffic
        deadline = _mono() + READY_TIMEOUT_S
        while len(_read_trace(trace_path)) < 3:
            if _mono() > deadline or trainer.poll() is not None:
                trainer.kill()
                raise RuntimeError("the trainer process never stepped: "
                                   + trainer.communicate()[0][-2000:])
            time.sleep(0.2)
        # dispatchers bound fleet-wide concurrency: sized for the grown
        # fleet, or the granted replicas idle behind the dispatch pool
        with rc.Serving(ctrl, request_timeout_s=120.0, max_attempts=20,
                        shed_outstanding=256, slo_window_s=WINDOW_S,
                        dispatchers=16) as fd:
            mgr = FleetManager(fd, ctrl, procs, device, staging=staging,
                               standby_ranks=(1, 2), chip_to_rank={3: 0},
                               decode_sleep=sleep)
            sclient = ServeLeaseClient(
                ledger, on_grant=mgr.on_grant, on_revoke=mgr.on_revoke,
                inflight=mgr.inflight, initial_chips=(3,),
                poll_interval_s=0.1)
            pending = deque(sorted(requests,
                                   key=lambda r: arrivals[r["rid"]]))
            t0 = _mono()
            wall0 = time.time()
            last_tick = t0
            backlog: list = []  # (wall, submitted and not yet answered)
            deadline = t0 + 300.0
            while _mono() < deadline:
                now = _mono()
                while pending and arrivals[pending[0]["rid"]] <= now - t0:
                    _submit(fd, pending.popleft())
                if now - last_tick >= TICK_S:
                    fd.write_metrics(slo_dir)
                    arbiter.tick()
                    observe_ledger()
                    last_tick = now
                    backlog.append((time.time(), len(requests) - len(pending)
                                    - len(fd.completed) - len(fd.failed)))
                d = sclient.poll()
                if d is not None:
                    mgr.note_directive(d)
                    sclient.apply(d)
                if (not pending
                        and len(fd.completed) + len(fd.failed)
                        == len(requests)
                        and not arbiter.loaned
                        and not arbiter.pending_handoff
                        and any(dd["action"] == "return"
                                for dd in arbiter.decisions)):
                    # the return completed: wait for training to ack the
                    # expand epoch and step twice in the expanded world
                    grants = [dd for dd in arbiter.decisions
                              if dd["action"] == "grant"]
                    if grants:
                        last = grants[-1]
                        expanded = sum(
                            1 for w, _, n in _read_trace(trace_path)
                            if n == len(TRAIN_CHIPS) and w >= last["wall"])
                        if ledger.acked_epoch(TRAIN) >= last["epoch"] \
                                and expanded >= 2:
                            break
                time.sleep(0.02)
            observe_ledger()
            idle = fd.wait_idle(timeout_s=60.0)
            counts = rc.counters(fd.metrics)
        trainer.send_signal(signal.SIGTERM)  # the guard ends fit
        try:
            train_log, _ = trainer.communicate(timeout=TRAIN_CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            trainer.kill()
            train_log, _ = trainer.communicate()
        train_rc = trainer.returncode
    finally:
        if trainer.poll() is None:
            trainer.kill()
            trainer.communicate()
        rcs = rc.shutdown(procs)
    tdoc = {}
    for line in train_log.splitlines():
        if line.startswith("TRAINER_JSON: "):
            tdoc = json.loads(line[len("TRAINER_JSON: "):])
    lease_epochs = tdoc.get("lease_epochs", [])
    decisions = list(arbiter.decisions)

    def walls(action):
        return [d["wall"] for d in decisions if d["action"] == action]

    preempts, grants, returns = walls("preempt"), walls("grant"), \
        walls("return")
    recovery_wall = None
    if grants:
        for d in decisions:
            if d["wall"] < grants[0]:
                continue
            p99 = d["reading"]["p99_ms"]
            if d["reading"]["samples"] == 0 or (p99 is not None
                                                and p99 <= SLO_P99_MS):
                recovery_wall = d["wall"]
                break
    ref = max(grants[0], wall0 + spike_end) if grants else None
    recovery_s = None if recovery_wall is None or ref is None else max(
        0.0, recovery_wall - ref)
    breakdown = None
    if ref is not None and recovery_wall is not None and fd is not None:
        breakdown = _recovery_breakdown(
            ref, preempts, grants, recovery_wall, mgr.activated,
            fd.completed, arrivals, wall0, spike_end, backlog)
    single = _single_holder(ledger_docs, set(CHIPS))
    final = ledger.read()
    bad = rc.bitwise_violations(fd, requests, oracle) if fd else []
    drained = dict(mgr.drain_rcs) if mgr else {}
    trace = _read_trace(trace_path)
    pre_spike = [s * 1e3 for w, s, n in trace
                 if n == len(TRAIN_CHIPS) and w < wall0 + spike_start]
    floors = {
        "arbiter_preempted": len(preempts) >= 1,
        "serve_granted": len(grants) >= 1,
        "chips_returned": len(returns) >= 1 and final is not None
        and final.chips(TRAIN) == tuple(TRAIN_CHIPS)
        and final.chips(SERVE) == (3,) and not arbiter.loaned
        and not arbiter.pending_handoff,
        "p99_recovered_within_two_windows": recovery_s is not None
        and recovery_s <= 2 * WINDOW_S,
        "train_resumed_bitwise": len(lease_epochs) >= 2
        and all(e["bitwise_resume"] for e in lease_epochs)
        and tdoc.get("error") is None and train_rc == 0,
        "single_holder_every_publish": bool(single) and all(single.values()),
        "all_completed_exactly_once": idle and fd is not None
        and sorted(fd.completed) == sorted(r["rid"] for r in requests)
        and not fd.failed and not fd.shed_rids,
        "bitwise_vs_generate": not bad,
        "revoked_replicas_drained_clean": bool(drained)
        and all(v == 0 for v in drained.values()),
    }
    return {"scenario": "elastic_autoscale",
            "injection": "open-loop Poisson burst (2 -> 20 rps) over a "
                         "1-replica fleet; the arbiter autoscales through "
                         "the lease ledger off metrics_fd_*.json windows; "
                         "the trainer in a process of its own",
            "ok": all(floors.values()), "floors": floors,
            "checks": {
                "decisions_actions": [{k: d[k] for k in ("action", "epoch")}
                                      for d in decisions if d["action"]],
                "recovery_s": recovery_s,
                "recovery_windows": None if recovery_s is None
                else recovery_s / WINDOW_S,
                "recovery_breakdown": breakdown,
                "lease_epochs": lease_epochs,
                "trainer_error": tdoc.get("error"), "trainer_rc": train_rc,
                "trainer_log_tail": train_log.splitlines()[-12:],
                "trainer": {k: tdoc.get(k) for k in (
                    "steps_by_world", "step_ms_by_world", "plans", "device",
                    "model", "batch", "launches")},
                "pre_spike_step_ms_median": float(np.median(pre_spike))
                if pre_spike else None,
                "single_holder_by_epoch": _strk(single),
                "drained_rcs": _strk(drained), "rcs": _strk(rcs),
                "counters": counts, "bitwise_bad_rids": bad,
                "failed": dict(fd.failed) if fd else {},
                "completed": len(fd.completed) if fd else 0,
                "n_requests": len(requests),
                "spike_window_s": [spike_start, spike_end]}}


# --------------------------------------------------------------------------
# scenario 2: prefix-warm drain handoff against a cold successor
# --------------------------------------------------------------------------


def run_handoff_scenario(workdir: str, oracle) -> dict:
    from ..obs.timeline import read_dir
    from ..runtime.ctrlfile import read_control_json

    device = oracle.device
    ctrl, ctrl_cold = os.path.join(workdir, "ctrl"), os.path.join(
        workdir, "ctrl_cold")
    os.makedirs(ctrl, exist_ok=True)
    os.makedirs(ctrl_cold, exist_ok=True)
    handoff = os.path.join(ctrl, "handoff_00000.json")
    pool = _prefix_pool(seed=71, n=3)
    rng = np.random.default_rng(73)
    round1 = [_prefix_req(i, pool[i], rng) for i in range(3)]
    round2 = [_prefix_req(10 + i, pool[i], rng) for i in range(3)]
    # one request a prefix in the warm round: a cold successor cannot
    # warm itself inside it, so first-touch hits prove the prewarm
    warm_round = [_prefix_req(20 + i, pool[i], rng) for i in range(3)]
    everything = round1 + round2 + warm_round

    def spawn(d, rank, extra):
        return _spawn(d, rank, device,
                      extra_args=("--prefix-cache", *extra), warm_lens=(36,),
                      warm_max_new=8, suffix_lens=HANDOFF_SUFFIX_WARM)

    procs = {0: spawn(ctrl, 0, ("--handoff-out", handoff))}
    moved, a_rc, exported = 0, None, None
    try:
        rc.wait_ready(ctrl, [0], procs)
        with rc.Serving(ctrl) as fd:
            for req in round1:
                _submit(fd, req)
            fd.wait_idle(timeout_s=rc.RUN_TIMEOUT_S)
            for req in round2:
                _submit(fd, req)
            fd.wait_idle(timeout_s=rc.RUN_TIMEOUT_S)
            procs[0].send_signal(signal.SIGTERM)  # drain -> export
            procs[0].wait(timeout=30.0)
            a_rc = procs[0].returncode
            exported = read_control_json(handoff)
            procs[1] = spawn(ctrl, 1, ("--handoff-in", handoff))
            rc.wait_ready(ctrl, [1], procs)
            moved = fd.reassign_affinity(0, 1)
            fd.forget_replica(0)
            fd.refresh()
            for req in warm_round:
                _submit(fd, req)
            warm_idle = fd.wait_idle(timeout_s=rc.RUN_TIMEOUT_S)
            counts = rc.counters(fd.metrics)
    finally:
        rcs = rc.shutdown(procs)
    # the control: the same first-touch round on a replica that never
    # saw the handoff
    cold = {0: spawn(ctrl_cold, 0, ())}
    try:
        rc.wait_ready(ctrl_cold, [0], cold)
        with rc.Serving(ctrl_cold) as fd_cold:
            for req in warm_round:
                _submit(fd_cold, req)
            cold_idle = fd_cold.wait_idle(timeout_s=rc.RUN_TIMEOUT_S)
    finally:
        cold_rcs = rc.shutdown(cold)
    events = read_dir(ctrl)[0]
    cold_events = read_dir(ctrl_cold)[0]
    a_rate = len(_prefix_hit_rids(events, 10, 20)) / len(round2)
    b_rate = len(_prefix_hit_rids(events, 20, 30)) / len(warm_round)
    c_rate = len(_prefix_hit_rids(cold_events, 20, 30)) / len(warm_round)
    bad = rc.bitwise_violations(fd, everything, oracle)
    bad_cold = rc.bitwise_violations(fd_cold, warm_round, oracle)
    cold_started = any(e.get("kind") == "serve_handoff_cold_start"
                       for e in events)
    floors = {
        "drainer_exported_handoff": a_rc == 0 and exported is not None
        and len(exported.get("entries", ())) >= 1,
        "successor_prewarmed_not_cold": not cold_started,
        "warm_hit_rate_at_least_half_of_predecessor": a_rate > 0
        and b_rate >= 0.5 * a_rate,
        "cold_control_below_warm": c_rate < b_rate,
        "affinity_followed_the_handoff": moved >= 1,
        "all_completed_exactly_once": warm_idle and cold_idle
        and sorted(fd.completed) == sorted(r["rid"] for r in everything)
        and sorted(fd_cold.completed) == sorted(r["rid"]
                                                for r in warm_round)
        and not fd.failed and not fd_cold.failed,
        "bitwise_vs_generate": not bad and not bad_cold,
    }
    return {"scenario": "prefix_handoff_warm_vs_cold",
            "injection": "SIGTERM drain exports the radix prefix index "
                         "(prefix tokens + block hashes); the successor "
                         "prewarms from it; a cold twin is the control",
            "ok": all(floors.values()), "floors": floors,
            "checks": {"predecessor_hit_rate": a_rate,
                       "warm_successor_hit_rate": b_rate,
                       "cold_control_hit_rate": c_rate,
                       "handoff_entries": len(exported.get("entries", ()))
                       if exported else 0,
                       "affinity_moved": moved,
                       "rcs": {**_strk(rcs), "cold": _strk(cold_rcs)},
                       "counters": counts,
                       "bitwise_bad_rids": bad + bad_cold}}


# --------------------------------------------------------------------------
# scenario 3: SIGKILL mid-handoff
# --------------------------------------------------------------------------


def run_sigkill_handoff_scenario(workdir: str, oracle) -> dict:
    from ..obs.timeline import read_dir

    device = oracle.device
    ctrl = os.path.join(workdir, "ctrl")
    os.makedirs(ctrl, exist_ok=True)
    handoff = os.path.join(ctrl, "handoff_00000.json")
    pool = _prefix_pool(seed=83, n=2)
    rng = np.random.default_rng(87)
    warm = [_prefix_req(100 + i, pool[i], rng) for i in range(2)]
    inflight = [_prefix_req(i, pool[i % 2], rng, max_new=16)
                for i in range(6)]

    def spawn(rank, extra):
        return _spawn(ctrl, rank, device, {"FT_RPC_DECODE_SLEEP": "0.05"},
                      extra_args=("--prefix-cache", *extra), warm_lens=(36,),
                      warm_max_new=16, suffix_lens=HANDOFF_SUFFIX_WARM)

    procs = {0: spawn(0, ("--handoff-out", handoff))}
    kill_rc, handoff_absent = None, False
    try:
        rc.wait_ready(ctrl, [0], procs)
        with rc.Serving(ctrl, request_timeout_s=240.0,
                        max_attempts=20) as fd:
            for req in warm:
                _submit(fd, req)
            fd.wait_idle(timeout_s=rc.RUN_TIMEOUT_S)
            for req in inflight:
                _submit(fd, req)
            time.sleep(0.4)  # decode in flight on the drainer
            os.kill(procs[0].pid, signal.SIGKILL)
            procs[0].wait(timeout=10.0)
            kill_rc = procs[0].returncode
            handoff_absent = not os.path.exists(handoff)
            # the successor boots after the crash; the front door's
            # retries keep the in-flight requests alive across its boot
            procs[1] = spawn(1, ("--handoff-in", handoff))
            idle = fd.wait_idle(timeout_s=READY_TIMEOUT_S)
            counts = rc.counters(fd.metrics)
    finally:
        rcs = rc.shutdown(procs)
    cold_starts = [e for e in read_dir(ctrl)[0]
                   if e.get("kind") == "serve_handoff_cold_start"]
    want = warm + inflight
    bad = rc.bitwise_violations(fd, want, oracle)
    floors = {
        "killed_by_sigkill": kill_rc == -signal.SIGKILL,
        "no_partial_handoff_accepted": handoff_absent,
        "successor_cold_started_loudly": len(cold_starts) >= 1,
        "all_completed_exactly_once": idle
        and sorted(fd.completed) == sorted(r["rid"] for r in want)
        and not fd.failed,
        "bitwise_vs_generate": not bad,
        "zero_duplicate_results":
            counts.get("serve.duplicate_results", 0) == 0,
        "successor_exited_clean": rcs.get(1) == 0,
    }
    return {"scenario": "sigkill_mid_handoff",
            "injection": "SIGKILL of the drain-exporting replica with "
                         "decode in flight; the successor boots against "
                         "the absent handoff file",
            "ok": all(floors.values()), "floors": floors,
            "checks": {"rcs": _strk({**rcs, 0: kill_rc}),
                       "cold_start_events": cold_starts[:2],
                       "counters": counts, "bitwise_bad_rids": bad,
                       "failed": dict(fd.failed),
                       "launches": rc.launch_checks(ctrl, oracle)}}


# --------------------------------------------------------------------------
# scenario 4: the arbiter restarted between parking chips and the grant
# --------------------------------------------------------------------------


def run_arbiter_restart_scenario(workdir: str, oracle) -> dict:
    from ..arbiter import ArbiterConfig, DeviceInventory, PoolArbiter
    from ..arbiter.core import SloReading
    from ..runtime import SERVE, TRAIN, LeaseLedger

    device = oracle.device
    ctrl, hb = os.path.join(workdir, "ctrl"), os.path.join(workdir, "hb")
    os.makedirs(ctrl, exist_ok=True)
    os.makedirs(hb, exist_ok=True)
    cfg = ArbiterConfig(slo_p99_ms=100.0, window_s=WINDOW_S, breach_ticks=2,
                        clear_ticks=999, cooldown_s=0.0, min_train_chips=1,
                        burst_chips=1, min_samples=1)
    ledger = LeaseLedger(hb)
    docs: dict = {}

    def observe():
        g = ledger.read()
        if g is not None:
            docs[g.epoch] = dict(g.grants)

    def breach():
        return SloReading(p99_ms=5000.0, samples=50)

    def quiet():
        return SloReading(p99_ms=0.0, samples=0)

    arb1 = PoolArbiter(DeviceInventory((0, 1), train=(0, 1)), ledger, cfg,
                       slo_reader=breach, serve_is_tenant=True)
    observe()
    arb1.tick()
    parked = arb1.tick()  # the breach streak reaches 2: chips parked
    observe()
    pending_before = tuple(arb1.pending_handoff)
    del arb1  # the crash: the pending handoff survives only on disk
    # training acks the park (its client would; the scenario is the
    # arbiter's, so the ack is direct)
    ledger.ack(TRAIN, ledger.read().epoch)
    granted_chips: list = []
    procs: dict = {}

    def on_serve_grant(chips):
        granted_chips.extend(chips)
        procs[0] = _spawn(ctrl, 0, device, warm_max_new=16)

    arb2 = PoolArbiter(DeviceInventory.from_grants(ledger.read().grants),
                       ledger, cfg, slo_reader=quiet,
                       on_serve_grant=on_serve_grant, serve_is_tenant=True)
    observe()
    resumed = tuple(arb2.pending_handoff)
    granted = arb2.tick()  # completes the resumed handoff
    observe()
    requests = rc.build_requests(seed=41, n=3)
    fd, idle = None, False
    try:
        if procs:
            rc.wait_ready(ctrl, [0], procs)
            with rc.Serving(ctrl) as fd:
                for req in requests:
                    _submit(fd, req)
                idle = fd.wait_idle(timeout_s=rc.RUN_TIMEOUT_S)
    finally:
        rcs = rc.shutdown(procs)
    single = _single_holder(docs, {0, 1})
    final = ledger.read()
    bad = rc.bitwise_violations(fd, requests, oracle) if fd else []
    floors = {
        "preempt_parked_before_crash": parked["action"] == "preempt"
        and pending_before == (1,),
        "pending_handoff_resumed_from_disk": bool(resumed)
        and resumed == pending_before,
        "grant_completed_after_restart": granted["action"] == "grant"
        and granted_chips == [1],
        "chip_landed_on_serve": final is not None
        and final.chips(SERVE) == (1,) and final.chips(TRAIN) == (0,),
        "single_holder_every_publish": bool(single) and all(single.values()),
        "served_on_granted_chip": idle and fd is not None
        and sorted(fd.completed) == [r["rid"] for r in requests]
        and not fd.failed,
        "bitwise_vs_generate": not bad,
        "replica_exited_clean": rcs.get(0) == 0,
    }
    return {"scenario": "arbiter_restart_mid_grant",
            "injection": "arbiter dropped between the preempt publish "
                         "(chips parked on ARBITER) and the grant; the "
                         "restart rebuilds the inventory from the ledger "
                         "and resumes arbiter_state.json",
            "ok": all(floors.values()), "floors": floors,
            "checks": {"single_holder_by_epoch": _strk(single),
                       "pending_before": list(pending_before),
                       "resumed": list(resumed), "rcs": _strk(rcs),
                       "bitwise_bad_rids": bad,
                       "launches": rc.launch_checks(ctrl, oracle)}}


# --------------------------------------------------------------------------
# scenario 5: a revoke racing live traffic, the drain fence
# --------------------------------------------------------------------------


def run_drain_race_scenario(workdir: str, oracle) -> dict:
    from ..runtime import ARBITER, SERVE, LeaseLedger, ServeLeaseClient
    from ..runtime.coordination import ProtocolViolation

    device = oracle.device
    ctrl, hb = os.path.join(workdir, "ctrl"), os.path.join(workdir, "hb")
    os.makedirs(ctrl, exist_ok=True)
    os.makedirs(hb, exist_ok=True)
    procs = {r: _spawn(ctrl, r, device, {"FT_RPC_DECODE_SLEEP": "0.05"})
             for r in range(2)}
    requests = rc.build_requests(seed=53, n=8)
    ledger = LeaseLedger(hb)
    ledger.publish(1, {SERVE: (0, 1)}, reason="baseline")
    violation = premature = acked_after = drain_rc = None
    inflight_at_revoke, idle, counts, mgr = 0, False, {}, None
    try:
        rc.wait_ready(ctrl, procs, procs)
        with rc.Serving(ctrl) as fd:
            mgr = FleetManager(fd, ctrl, procs, device,
                               chip_to_rank={0: 0, 1: 1})
            sclient = ServeLeaseClient(ledger, on_revoke=mgr.on_revoke,
                                       inflight=mgr.inflight,
                                       initial_chips=(0, 1),
                                       poll_interval_s=0.0)
            if sclient.poll() is not None:  # epoch 1 matches: acked
                raise RuntimeError("the baseline epoch was not in place")
            for req in requests:
                _submit(fd, req)
            time.sleep(0.4)  # in flight on both replicas
            ledger.publish(2, {SERVE: (1,), ARBITER: (0,)}, reason="revoke")
            d = sclient.poll()
            mgr.note_directive(d)
            inflight_at_revoke = mgr.inflight()
            try:
                sclient.ack(d)  # the race: an ack with requests in flight
            except ProtocolViolation as e:
                violation = str(e)
            premature = ledger.acked_epoch(SERVE)
            sclient.apply(d)  # the right path: drain rank 0, then ack
            acked_after = ledger.acked_epoch(SERVE)
            idle = fd.wait_idle(timeout_s=rc.RUN_TIMEOUT_S)
            counts = rc.counters(fd.metrics)
        drain_rc = mgr.drain_rcs.get(0)
    finally:
        rcs = rc.shutdown(procs)
    bad = rc.bitwise_violations(fd, requests, oracle)
    floors = {
        "revoke_raced_live_traffic": inflight_at_revoke >= 1,
        "early_ack_refused_loudly": violation is not None
        and "still in flight" in violation,
        "no_ack_written_by_refusal": premature == 1,
        "drain_then_ack_succeeded": acked_after == 2 and drain_rc == 0,
        "all_completed_exactly_once": idle
        and sorted(fd.completed) == [r["rid"] for r in requests]
        and not fd.failed,
        "bitwise_vs_generate": not bad,
        "zero_duplicate_results":
            counts.get("serve.duplicate_results", 0) == 0,
    }
    return {"scenario": "drain_races_revoke",
            "injection": "revoke published while the revoked replica holds "
                         "in-flight decode; ack attempted before the drain",
            "ok": all(floors.values()), "floors": floors,
            "checks": {"inflight_at_revoke": inflight_at_revoke,
                       "violation": violation,
                       "acked_epoch_after_refusal": premature,
                       "acked_epoch_after_drain": acked_after,
                       "rcs": _strk({**rcs, 0: drain_rc}),
                       "counters": counts, "bitwise_bad_rids": bad,
                       "launches": rc.launch_checks(ctrl, oracle)}}


# --------------------------------------------------------------------------
# scenario 6: prefix-aware miss-first shedding under overload
# --------------------------------------------------------------------------


def _shed_run(workdir, tag, oracle, warm, burst, gaps, **shed_cfg):
    ctrl = os.path.join(workdir, f"ctrl_{tag}")
    os.makedirs(ctrl, exist_ok=True)
    procs = {0: _spawn(ctrl, 0, oracle.device,
                       {"FT_RPC_DECODE_SLEEP": DECODE_SLEEP},
                       extra_args=("--prefix-cache",), warm_lens=(6, 36),
                       warm_max_new=16, suffix_lens=HANDOFF_SUFFIX_WARM)}
    try:
        rc.wait_ready(ctrl, [0], procs)
        with rc.Serving(ctrl, **shed_cfg) as fd:
            for req in warm:  # seed the prefix index and the affinity
                _submit(fd, req)
            fd.wait_idle(timeout_s=rc.RUN_TIMEOUT_S)
            t0 = _mono()
            for req, gap in zip(burst, gaps):
                time.sleep(float(gap))
                _submit(fd, req)
            idle = fd.wait_idle(timeout_s=rc.RUN_TIMEOUT_S)
            wall_s = _mono() - t0
            counts = rc.counters(fd.metrics)
    finally:
        rcs = rc.shutdown(procs)
    by_rid = {r["rid"]: r for r in burst}
    done = {rid for rid in fd.completed if rid in by_rid}
    shed, failed = set(fd.shed_rids), set(fd.failed)
    tokens = sum(len(by_rid[r]["prompt"]) + by_rid[r]["max_new"]
                 for r in done)
    return {"fd": fd, "idle": idle, "rcs": rcs, "counters": counts,
            "completed": len(done), "shed": len(shed),
            "tokens_per_s": tokens / wall_s if wall_s > 0 else 0.0,
            "accounted": (not (done & shed) and not (done & failed)
                          and not (shed & failed) and not failed
                          and done | shed == set(by_rid)),
            "bad": rc.bitwise_violations(fd, warm + burst, oracle)}


def run_shed_scenario(workdir: str, oracle) -> dict:
    pool = _prefix_pool(seed=91, n=2)
    rng = np.random.default_rng(97)
    warm = [_prefix_req(1000 + i, pool[i], rng, max_new=16)
            for i in range(2)]
    burst = []
    for i in range(60):
        if i % 2 == 0:  # a predicted prefix hit: a long shared prompt
            burst.append(_prefix_req(i, pool[(i // 2) % 2], rng,
                                     max_new=16))
        else:  # a miss: a short unshared prompt
            burst.append({"rid": i, "prompt": rng.integers(
                0, 64, (6,)).astype(np.int32), "max_new": 16})
    gaps = np.random.default_rng(101).exponential(1.0 / 30.0, size=60)
    # one max-inflight cap (8) on both sides: A keeps the upper half for
    # predicted hits, B spends it on whoever arrives first
    a = _shed_run(workdir, "miss_first", oracle, warm, burst, gaps,
                  shed_outstanding=4, shed_hit_headroom=4)
    b = _shed_run(workdir, "flat", oracle, warm, burst, gaps,
                  shed_outstanding=8, shed_hit_headroom=0)
    floors = {
        "both_overloaded_and_shed": a["shed"] >= 1 and b["shed"] >= 1,
        "miss_first_sheds_accounted":
            a["counters"].get("serve.shed_miss_first", 0) >= 1,
        "flat_policy_never_miss_first":
            b["counters"].get("serve.shed_miss_first", 0) == 0,
        "miss_first_beats_flat_token_throughput":
            a["tokens_per_s"] > b["tokens_per_s"],
        "every_rid_accounted_once": a["accounted"] and b["accounted"]
        and a["idle"] and b["idle"],
        "bitwise_vs_generate": not a["bad"] and not b["bad"],
    }
    return {"scenario": "shed_miss_first_load",
            "injection": "~30 rps open-loop burst (50% shared-prefix hits, "
                         "50% misses) into one paced replica; "
                         "shed_outstanding=4+headroom=4 vs 8+0, the same "
                         "max-inflight cap",
            "ok": all(floors.values()), "floors": floors,
            "checks": {side: {
                "tokens_per_s": run["tokens_per_s"],
                "completed": run["completed"], "shed": run["shed"],
                "shed_miss_first": run["counters"].get(
                    "serve.shed_miss_first", 0),
                "rcs": _strk(run["rcs"]), "bitwise_bad_rids": run["bad"]}
                for side, run in (("miss_first", a), ("flat", b))}}


SCENARIOS = {
    "autoscale": run_autoscale_scenario,
    "handoff": run_handoff_scenario,
    "sigkill_handoff": run_sigkill_handoff_scenario,
    "arbiter_restart": run_arbiter_restart_scenario,
    "drain_race": run_drain_race_scenario,
    "shed_miss_first": run_shed_scenario,
}
# the three kill-chaos protocol scenarios (no trainer, no SLO phases)
SMOKE = ["sigkill_handoff", "arbiter_restart", "drain_race"]


def run_matrix(names, oracle, log=print) -> list:
    return rc.run_matrix(names, oracle, log=log, runners=SCENARIOS)


def main(argv=None) -> int:
    ap = rc.parser(__doc__.split("\n\n")[0], SCENARIOS, SMOKE,
                   os.path.join("tmp", "serve_elastic_chaos.json"))
    ap.add_argument("--child", action="store_true", help=__import__(
        "argparse").SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return child_trainer()
    out = None if args.no_artifact else checked_out(ap, args.out)
    names = rc.names_of(ap, args, SCENARIOS, SMOKE)
    from ..device import resolve_device

    device = str(resolve_device(args.device))
    print("building the generate oracle (single-process greedy, f32)...",
          flush=True)
    oracle = rc.Oracle(device)
    results = run_matrix(names, oracle)
    ok = all(r["ok"] for r in results)
    if out is not None:
        with open(out, "w") as f:
            json.dump({"ok": ok, "smoke": args.smoke, "device": device,
                       "model": rc.model_args(device),
                       "scenarios": {r["scenario"]: r for r in results},
                       "finished": datetime.datetime.now(
                           datetime.timezone.utc).isoformat(
                               timespec="seconds")},
                      f, indent=1, sort_keys=True, default=str)
        print(f"wrote {out} (ok={ok})")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
