"""Executed bring-up: a 4-process ``torch.distributed`` world on one host.

    python -m flextree_tpu_torch.tools.multiproc_bringup [--out PATH]
    python -m flextree_tpu_torch.tools.multiproc_bringup --device cpu \\
        --count 4099 --timing-count 65536 --repeat 2

The port's counterpart of the JAX package's ``tools/multiproc_bringup.py``:
the parent spawns :data:`NUM_PROCESSES` child processes, each one rank,
brought up by the production ``parallel.launch.init_distributed`` from
the launcher's env triple (``FT_COORDINATOR`` / ``FT_NUM_PROCESSES`` /
``FT_PROCESS_ID``, the MPI-rank analog) over gloo.  Each child then:

1. asks the planner for the allreduce of :data:`PLAN_BYTES` over the
   world (``planner.choose.choose_topology``; two stages, ``2,2``, at
   this size);
2. runs that tree and the ring over the group on ``--device`` (on a card
   each local fold is the CUDA fold kernel, the rows staged through the
   host for gloo), and checks each result bitwise against the same
   allreduce of host copies of the rows (the plain fold), against the
   library's ``all_reduce`` within float32 rounding, and against the
   analytic sum;
3. times the library call, the flat tree, the two-stage tree and the
   ring at ``--timing-count`` float32 a rank, every rank in one order.

Deviation from the JAX tool: its children each hold 4 virtual devices of
a 2 x 4 hybrid mesh; the port's process group is one data-parallel axis
of one rank a process (the hybrid meshes are ROADMAP.md Queue 1, item
11), so the world is 4 processes of one rank each.

Floors (exit 1 on a violation): every child exits 0 and reports PASS;
every result bitwise its host copies; every rank's fold launches equal
the code's count.  Results go to ``--out`` (default
``tmp/multiproc_bringup.json``), under ``tmp/``.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import time

from . import checked_out

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

NUM_PROCESSES = 4
#: the bytes a rank asks the planner about (the JAX tool's 4 MB)
PLAN_BYTES = 4 << 20
#: float32 a rank in the correctness check: the planner's bytes
COUNT = PLAN_BYTES // 4
TIMING_COUNT = 1 << 20
REPEAT = 8
CHILD_TIMEOUT_S = 300.0
TIMED = ("library", "flat", "two_level:2,2", "ring")


def rank_rows(rank: int, count: int):
    """This rank's row: ``arange(count) * (rank + 1)`` in float32."""
    import torch

    return torch.arange(count, dtype=torch.float32) * float(rank + 1)


def check_allreduce(dev, topo: str, count: int, log) -> dict:
    """One allreduce of ``count`` float32 a rank over the default group
    with ``topo`` on ``dev``: bitwise against the same allreduce of host
    copies (the plain fold), within float32 rounding of the library's
    ``all_reduce``, and the analytic sum at column 1.  Returns the
    checks and this rank's fold launches against the code's count."""
    import torch
    import torch.distributed as dist

    from ..ops import reduce_stacked as rs
    from ..parallel.allreduce import allreduce
    from .coord_chaos import gloo_fold_launches

    rank, n = dist.get_rank(), dist.get_world_size()
    row = rank_rows(rank, count)
    before = rs.reduce_sources.launches
    got = allreduce(row.to(dev), None, topo, "sum")
    if got.is_cuda:
        torch.cuda.synchronize(got.device)
    launches = rs.reduce_sources.launches - before
    host = allreduce(row.clone(), None, topo, "sum")
    lib = row.clone()
    dist.all_reduce(lib)
    got = got.cpu()
    want_col1 = float(sum(r + 1 for r in range(n)))
    out = {
        "topo": topo,
        "count": count,
        "host_copies_bitwise": bool(torch.equal(got.view(torch.int32),
                                                host.view(torch.int32))),
        "library_close": bool(torch.allclose(got, lib, rtol=1e-6, atol=0)),
        "analytic": count < 2 or float(got[1]) == want_col1,
        "fold_launches": launches,
        # the plain fold on the CPU launches nothing
        "fold_launches_want": gloo_fold_launches(n, topo, count, 1)
        if dev.type == "cuda" else 0,
    }
    out["ok"] = (out["host_copies_bitwise"] and out["library_close"]
                 and out["analytic"]
                 and out["fold_launches"] == out["fold_launches_want"])
    log(f"allreduce[{topo}] across {n} processes: "
        f"{'OK' if out['ok'] else 'MISMATCH'} {json.dumps(out)}")
    return out


def timed_runs(dev, count: int, repeat: int) -> dict:
    """The library call and the FlexTree shapes at ``count`` float32 a
    rank, each warmed once, then ``repeat`` timed calls; every rank runs
    them in one order (the collectives stay matched)."""
    import torch
    import torch.distributed as dist

    from ..parallel.allreduce import allreduce

    x = torch.ones(count, dtype=torch.float32, device=dev)

    def call(name):
        if name == "library":
            y = x.cpu() if x.is_cuda else x.clone()
            dist.all_reduce(y)
            return y
        topo = {"flat": str(dist.get_world_size()), "ring": "1"}.get(
            name, name.partition(":")[2])
        out = allreduce(x, None, topo, "sum")
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        return out

    rows = {}
    for name in TIMED:
        call(name)
        ts = []
        for _ in range(repeat):
            dist.barrier()
            t0 = time.perf_counter()
            call(name)
            ts.append(time.perf_counter() - t0)
        rows[name] = {"min_s": min(ts), "avg_s": sum(ts) / len(ts),
                      "reps": len(ts)}
    return rows


def child_main() -> int:
    """One process of the world (``--child``)."""
    import torch

    from ..parallel.launch import (
        ClusterConfig,
        init_distributed,
        shutdown_distributed,
    )
    from ..planner.choose import choose_topology

    dev = torch.device(os.environ["FT_DEVICE"])
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 1
    pid = os.environ.get("FT_PROCESS_ID", "?")

    def log(msg):
        print(f"[proc {pid}] {msg}", flush=True)

    report = init_distributed(ClusterConfig.from_env(), backend="gloo",
                              device=dev)
    try:
        import torch.distributed as dist

        n = dist.get_world_size()
        log(f"bring-up OK after {report.attempts} attempt(s): {n} "
            f"processes, backend {report.backend}, device {dev}")
        if n != NUM_PROCESSES:
            log(f"FAIL: expected {NUM_PROCESSES} processes")
            return 1
        plan = choose_topology(n, PLAN_BYTES)
        log(f"planner picked FT_TOPO={plan.to_ft_topo()} for "
            f"{PLAN_BYTES} bytes")
        count = int(os.environ["FT_COUNT"])
        checks = [check_allreduce(dev, plan.to_ft_topo(), count, log),
                  check_allreduce(dev, "1", count, log)]
        timings = timed_runs(dev, int(os.environ["FT_TIMING_COUNT"]),
                             int(os.environ["FT_REPEAT"]))
        for name, t in timings.items():
            log(f"timing[{name}]: min {t['min_s'] * 1e3:.3f} ms avg "
                f"{t['avg_s'] * 1e3:.3f} ms")
        ok = all(c["ok"] for c in checks)
        print("BRINGUP_JSON: " + json.dumps({
            "rank": dist.get_rank(), "attempts": report.attempts,
            "planner_pick": plan.to_ft_topo(), "checks": checks,
            "timings": timings}), flush=True)
    finally:
        shutdown_distributed()
    log("PASS" if ok else "FAIL")
    return 0 if ok else 1


def spawn_child(module: str, pid: int, port: int, device: str,
                extra_env=None) -> subprocess.Popen:
    """A child ``python -m flextree_tpu_torch.tools.<module> --child``
    with the launcher's env triple, on one torch thread."""
    path = os.environ.get("PYTHONPATH")
    env = {**os.environ,
           "FT_COORDINATOR": f"127.0.0.1:{port}",
           "FT_NUM_PROCESSES": str(NUM_PROCESSES),
           "FT_PROCESS_ID": str(pid), "FT_DEVICE": device,
           "OMP_NUM_THREADS": "1",
           "PYTHONPATH": ROOT + (os.pathsep + path if path else ""),
           **(extra_env or {})}
    env.pop("FLEXTREE_CALIBRATION", None)  # no ambient calibration skews
    return subprocess.Popen(
        [sys.executable, "-m", f"flextree_tpu_torch.tools.{module}",
         "--child"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def harvest(procs, timeout: float = CHILD_TIMEOUT_S):
    """Every child's log and exit code within one shared deadline; on a
    timeout every child still running is killed."""
    logs, rcs = [], []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            try:
                out, _ = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                for q in procs:
                    if q.poll() is None:
                        q.kill()
                out, _ = p.communicate()
                out += f"\n[parent] TIMEOUT after {timeout:.0f} s"
            logs.append(out)
            rcs.append(p.returncode)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return logs, rcs


def payloads(logs, tag: str = "BRINGUP_JSON: ") -> list:
    out = []
    for log in logs:
        for line in log.splitlines():
            if line.startswith(tag):
                out.append(json.loads(line[len(tag):]))
    return out


def run(device: str, count: int, timing_count: int, repeat: int) -> dict:
    """The 4-process world; returns the result with its floors."""
    from ..parallel.launch import free_port

    port = free_port()
    env = {"FT_COUNT": str(count), "FT_TIMING_COUNT": str(timing_count),
           "FT_REPEAT": str(repeat)}
    procs = [spawn_child("multiproc_bringup", pid, port, device, env)
             for pid in range(NUM_PROCESSES)]
    logs, rcs = harvest(procs)
    reports = payloads(logs)
    checks = [c for r in reports for c in r["checks"]]
    floors = {
        "all_exited_zero": all(rc == 0 for rc in rcs),
        "all_passed": sum("PASS" in log for log in logs) == NUM_PROCESSES
        and len(reports) == NUM_PROCESSES,
        "host_copies_bitwise": bool(checks)
        and all(c["host_copies_bitwise"] for c in checks),
        "library_and_analytic": bool(checks)
        and all(c["library_close"] and c["analytic"] for c in checks),
        "fold_launches_the_codes": bool(checks) and all(
            c["fold_launches"] == c["fold_launches_want"] for c in checks),
    }
    timings = reports[0]["timings"] if reports else None
    if timings:
        flat = timings["flat"]["min_s"]
        two = timings["two_level:2,2"]["min_s"]
        timings = {"configs": timings, "two_level_vs_flat": flat / two,
                   "buffer_bytes_per_rank": timing_count * 4,
                   "planner_pick": reports[0]["planner_pick"]}
    return {"ok": all(floors.values()), "floors": floors,
            "num_processes": NUM_PROCESSES, "device": device,
            "count": count, "returncodes": rcs,
            "planner_pick": reports[0]["planner_pick"] if reports else None,
            "fold_launches": [sum(c["fold_launches"] for c in r["checks"])
                              for r in reports],
            "timings": timings,
            "logs": [log.splitlines()[-12:] for log in logs]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--device", default=None,
                    help="the ranks' device: cuda (default) or cpu")
    ap.add_argument("--count", type=int, default=COUNT,
                    help="float32 a rank in the correctness check")
    ap.add_argument("--timing-count", type=int, default=TIMING_COUNT)
    ap.add_argument("--repeat", type=int, default=REPEAT)
    ap.add_argument("--out", default=os.path.join("tmp",
                                                  "multiproc_bringup.json"))
    ap.add_argument("--no-artifact", action="store_true")
    args = ap.parse_args(argv)
    if args.child:
        return child_main()
    out = None if args.no_artifact else checked_out(ap, args.out)
    from ..device import resolve_device

    device = str(resolve_device(args.device))
    res = run(device, args.count, args.timing_count, args.repeat)
    print(f"multiproc bring-up: {'OK' if res['ok'] else 'FAILED'} "
          + json.dumps(res["floors"]), flush=True)
    for i, log in enumerate(res["logs"]):
        print(f"----- process {i} (rc={res['returncodes'][i]}) -----")
        print("\n".join(log))
    if out is not None:
        res["finished"] = datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds")
        with open(out, "w") as f:
            json.dump(res, f, indent=1, sort_keys=True)
        print(f"wrote {out} (ok={res['ok']})")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
