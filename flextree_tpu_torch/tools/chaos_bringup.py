"""Chaos bring-up: kill, restart and degrade a real 4-process world
mid-handshake.

    python -m flextree_tpu_torch.tools.chaos_bringup [--scenario NAME]...
    python -m flextree_tpu_torch.tools.chaos_bringup --device cpu \\
        --scenario degrade --count 4099

The port's counterpart of the JAX package's ``tools/chaos_bringup.py``.
``tools.multiproc_bringup`` runs the happy path of
``parallel.launch``; this driver runs its failure paths (the
retry/backoff wrapper, the error taxonomy and the degrade-to-survivors
bring-up) under real process faults:

- ``retry``: the coordinator starts :data:`LATE_BY_S` seconds late, past
  the other processes' per-attempt deadline (``FT_INIT_TIMEOUT``), so
  their first attempts fail and the backoff loop must reconnect
  (asserted: ``attempts > 1`` in their reports);
- ``restart``: process 1 is killed before it reaches the handshake and
  restarted by the launcher; the coordinator, inside its deadline, never
  notices;
- ``degrade``: process 3 never joins; the launcher (the only party that
  knows its children died) reports 3 survivors, and
  ``init_distributed_or_degrade`` forms the world of 3 directly, with the
  topology replanned for it (``planner.replan_for_survivors(3, 4 << 20,
  configured=4)``).  Process ids stay contiguous, as the launcher's
  contract requires.

In every scenario the world that came up runs its planner-picked tree and
the ring over the group on ``--device`` (``multiproc_bringup.
check_allreduce``: bitwise the same allreduce of host copies, the
library's sum, the analytic sum, the fold launches the code's).

Deviation from the JAX tool: the world is 4 configured processes of one
rank each (the JAX tool's is 2 processes of 4 virtual devices), as in
``tools.multiproc_bringup``.  Exit 1 when any scenario fails; results go
to ``--out`` (default ``tmp/chaos_bringup.json``), under ``tmp/``.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import time

from . import checked_out
from .multiproc_bringup import (
    COUNT,
    NUM_PROCESSES,
    PLAN_BYTES,
    check_allreduce,
    harvest,
    payloads,
    spawn_child,
)

SCENARIOS = ("retry", "restart", "degrade")
SURVIVORS = NUM_PROCESSES - 1
#: the late coordinator's delay after the others reach their handshake:
#: more than one failed attempt at their per-attempt deadline (3 s) and
#: backoff, well within their budget
LATE_BY_S = 5.0
_TAG = "CHAOS_JSON: "


def child_main() -> int:
    """One process of the world; its behavior comes from ``FT_CHAOS_*``."""
    if os.environ.get("FT_CHAOS_DIE") == "1":
        # the injected fault: die before ever reaching the handshake
        print("[chaos] dying mid-handshake (injected)", flush=True)
        os._exit(3)

    import torch

    from ..parallel.launch import (
        BringupTimeout,
        ClusterConfig,
        init_distributed,
        init_distributed_or_degrade,
        shutdown_distributed,
    )
    from ..planner.choose import choose_topology

    dev = torch.device(os.environ["FT_DEVICE"])
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    scenario = os.environ.get("FT_CHAOS_SCENARIO", "restart")
    pid = os.environ.get("FT_PROCESS_ID", "?")

    def log(msg):
        print(f"[proc {pid}] {msg}", flush=True)

    mark = os.environ.get("FT_CHAOS_MARK_DIR")
    if mark:  # tell the launcher this process is about to hand-shake
        open(os.path.join(mark, f"ready_{pid}"), "w").close()
    plan = None
    try:
        if scenario == "degrade":
            survivors = int(os.environ["FT_CHAOS_SURVIVORS"])
            report, plan = init_distributed_or_degrade(
                ClusterConfig.from_env(), nbytes=PLAN_BYTES,
                survivors=survivors, backend="gloo", device=dev)
            if report.degraded_to != survivors:
                log(f"FAIL: expected degraded_to={survivors}, got "
                    f"{report.degraded_to}")
                return 1
        else:
            report = init_distributed(ClusterConfig.from_env(),
                                      backend="gloo", device=dev)
    except BringupTimeout as e:
        log(f"FAIL: bring-up exhausted its retries: {e}")
        for err in e.errors:
            log(f"  attempt error: {err}")
        return 1
    try:
        import torch.distributed as dist

        n = dist.get_world_size()
        log(f"bring-up OK after {report.attempts} attempt(s): {n} processes"
            + (f" (degraded from {NUM_PROCESSES})" if report.degraded_to
               else ""))
        if os.environ.get("FT_CHAOS_EXPECT_RETRIES") == "1" and \
                report.attempts < 2:
            log("FAIL: expected the retry loop to fire (attempts < 2)")
            return 1
        if plan is None:
            plan = choose_topology(n, PLAN_BYTES)
        count = int(os.environ["FT_COUNT"])
        checks = [check_allreduce(dev, plan.to_ft_topo(), count, log),
                  check_allreduce(dev, "1", count, log)]
        ok = all(c["ok"] for c in checks)
        print(_TAG + json.dumps({
            "rank": dist.get_rank(), "attempts": report.attempts,
            "errors": report.errors, "degraded_to": report.degraded_to,
            "world": n, "topo": plan.to_ft_topo(),
            "advisory": list(plan.advisory), "checks": checks}), flush=True)
    finally:
        shutdown_distributed()
    log("PASS" if ok else "FAIL")
    return 0 if ok else 1


def _spawn(pid, port, scenario, device, count, extra_env=None):
    return spawn_child("chaos_bringup", pid, port, device,
                       {"FT_CHAOS_SCENARIO": scenario, "FT_COUNT": str(count),
                        **(extra_env or {})})


def _summarize(name: str, logs, rcs, expect_pass: int) -> dict:
    reports = payloads(logs, _TAG)
    checks = [c for r in reports for c in r["checks"]]
    ok = (all(rc == 0 for rc in rcs)
          and sum("PASS" in log for log in logs) == expect_pass
          and len(reports) == expect_pass
          and all(c["ok"] for c in checks))
    return {"scenario": name, "ok": ok, "returncodes": rcs,
            "reports": reports,
            "fold_launches": sum(c["fold_launches"] for c in checks),
            "logs": [log.splitlines()[-14:] for log in logs]}


def run_retry(port: int, device: str, count: int) -> dict:
    """The coordinator starts late: the others' backoff loops must
    survive at least one failed attempt and reconnect.  The delay counts
    from the moment every other process is about to hand-shake (a marker
    file each), so a slow interpreter start cannot hide the fault."""
    import tempfile

    marks = tempfile.mkdtemp(prefix="ft-chaos-marks-")
    early = {"FT_INIT_TIMEOUT": "3", "FT_INIT_RETRIES": "8",
             "FT_CHAOS_EXPECT_RETRIES": "1", "FT_CHAOS_MARK_DIR": marks}
    procs = [_spawn(pid, port, "retry", device, count, early)
             for pid in range(1, NUM_PROCESSES)]
    try:
        deadline = time.monotonic() + 120.0
        while len(os.listdir(marks)) < len(procs):
            if time.monotonic() > deadline or any(
                    p.poll() is not None for p in procs):
                raise RuntimeError("the early processes never reached "
                                   "their handshake")
            time.sleep(0.05)
        time.sleep(LATE_BY_S)
        # the late coordinator gets one roomy attempt, so the processes
        # already backing off land in it
        procs.insert(0, _spawn(0, port, "retry", device, count,
                               {"FT_INIT_TIMEOUT": "60",
                                "FT_INIT_RETRIES": "2"}))
    finally:
        logs, rcs = harvest(procs)
        for name in os.listdir(marks):
            os.unlink(os.path.join(marks, name))
        os.rmdir(marks)
    return _summarize("retry", logs, rcs, expect_pass=NUM_PROCESSES)


def run_restart(port: int, device: str, count: int) -> dict:
    """Kill process 1 before its handshake, restart it; the coordinator,
    inside its handshake deadline, never notices."""
    env = {"FT_INIT_TIMEOUT": "90", "FT_INIT_RETRIES": "2"}
    procs = [_spawn(0, port, "restart", device, count, env)]
    try:
        doomed = _spawn(1, port, "restart", device, count,
                        {**env, "FT_CHAOS_DIE": "1"})
        (doomed_out,), (doomed_rc,) = harvest([doomed], timeout=60)
        # the launcher observes the death and restarts the rank
        procs += [_spawn(pid, port, "restart", device, count, env)
                  for pid in range(1, NUM_PROCESSES)]
    finally:
        logs, rcs = harvest(procs)
    summary = _summarize("restart", logs, rcs, expect_pass=NUM_PROCESSES)
    summary["killed_process"] = {"rc": doomed_rc,
                                 "log": doomed_out.splitlines()}
    summary["ok"] = summary["ok"] and doomed_rc == 3
    return summary


def run_degrade(port: int, device: str, count: int) -> dict:
    """Process 3 never joins: the launcher reports 3 survivors and they
    form the degraded world with the replanned topology."""
    env = {"FT_INIT_TIMEOUT": "30", "FT_INIT_RETRIES": "0",
           "FT_CHAOS_SURVIVORS": str(SURVIVORS)}
    procs = [_spawn(pid, port, "degrade", device, count, env)
             for pid in range(SURVIVORS)]
    logs, rcs = harvest(procs)
    summary = _summarize("degrade", logs, rcs, expect_pass=SURVIVORS)
    from ..planner.choose import replan_for_survivors

    want = replan_for_survivors(SURVIVORS, PLAN_BYTES,
                                configured=NUM_PROCESSES)
    summary["replanned_topo"] = want.to_ft_topo()
    summary["ok"] = summary["ok"] and all(
        r.get("degraded_to") == SURVIVORS and r.get("world") == SURVIVORS
        and r.get("topo") == want.to_ft_topo()
        for r in summary["reports"])
    return summary


RUNNERS = {"retry": run_retry, "restart": run_restart,
           "degrade": run_degrade}


def run_matrix(names, device: str, count: int, port: int | None = None,
               log=print) -> list:
    """Run the scenarios in order, each on its own coordinator port; a
    crashed driver is a failed scenario, never a missing one."""
    from ..parallel.launch import free_port

    results = []
    for i, name in enumerate(names):
        log(f"=== scenario {name} ===")
        t0 = time.monotonic()
        try:
            res = RUNNERS[name](free_port() if port is None else port + i,
                                device, count)
        except Exception as e:
            res = {"scenario": name, "ok": False, "returncodes": [],
                   "reports": [], "fold_launches": 0,
                   "logs": [[f"driver error: {type(e).__name__}: {e}"]]}
        res["seconds"] = time.monotonic() - t0
        log(f"scenario {name}: {'OK' if res['ok'] else 'FAIL'} "
            f"({res['seconds']:.1f} s)")
        if not res["ok"]:
            for lines in res["logs"]:
                for line in lines:
                    log(f"  {line}")
        results.append(res)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None,
                    help="first coordinator port (default: free ports)")
    ap.add_argument("--scenario", choices=SCENARIOS, action="append")
    ap.add_argument("--device", default=None,
                    help="the ranks' device: cuda (default) or cpu")
    ap.add_argument("--count", type=int, default=COUNT,
                    help="float32 a rank in each allreduce check")
    ap.add_argument("--out", default=os.path.join("tmp",
                                                  "chaos_bringup.json"))
    ap.add_argument("--no-artifact", action="store_true")
    args = ap.parse_args(argv)
    if args.child:
        return child_main()
    out = None if args.no_artifact else checked_out(ap, args.out)
    from ..device import resolve_device

    device = str(resolve_device(args.device))
    names = tuple(args.scenario) if args.scenario else SCENARIOS
    results = run_matrix(names, device, args.count, args.port)
    # any scenario that failed to recover fails the run, with the result
    # file still written for the postmortem
    ok = all(r["ok"] for r in results)
    if out is not None:
        with open(out, "w") as f:
            json.dump({"ok": ok, "device": device,
                       "num_processes": NUM_PROCESSES, "count": args.count,
                       "scenarios": results,
                       "finished": datetime.datetime.now(
                           datetime.timezone.utc).isoformat(
                               timespec="seconds")},
                      f, indent=1, sort_keys=True)
        print(f"wrote {out} (ok={ok})")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
