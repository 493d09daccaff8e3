"""The bring-up's store keys after a failed attempt, on the CPU: a
process that first asks for a larger world on the coordinator of a
smaller one must not meet that world's keys (the default group's keys are
prefixed by the world size), and the reset of torch's group counter after
a failed attempt, which a retry needs to meet its peers' keys, refuses
loudly when torch no longer has that counter."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from flextree_tpu_torch.parallel import launch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_reset_refuses_without_the_group_counter(monkeypatch):
    """Torch's private group counter gone: the reset after a failed
    attempt refuses loudly instead of letting a survivor hang."""
    from torch.distributed import distributed_c10d as c10d

    monkeypatch.setattr(c10d, "_world", object())
    with pytest.raises(launch.BringupConfigError, match="group_count"):
        launch._reset_partial_bringup()


RACE_CHILD = r"""
import json, sys
import torch, torch.distributed as dist
from flextree_tpu_torch.parallel import launch
rank, port = int(sys.argv[1]), int(sys.argv[2])
addr = f"127.0.0.1:{port}"
first = None
if rank == 1:
    # a full world of 3 tried first, on the coordinator that serves the
    # world of 2: it must time out, not meet the smaller world's keys
    try:
        launch.init_distributed(launch.ClusterConfig(addr, 3, 1),
                                timeout=3.0, retries=0, backend="gloo",
                                merge_env=False)
        first = "up"
    except launch.BringupTimeout:
        first = "timeout"
rep = launch.init_distributed(launch.ClusterConfig(addr, 2, rank),
                              timeout=30.0 if rank == 0 else 15.0,
                              retries=0, backend="gloo", merge_env=False)
x = torch.full((5,), float(rank + 1))
dist.all_reduce(x)
print("RACE_JSON " + json.dumps({
    "rank": rank, "first": first, "world": dist.get_world_size(),
    "sum": x.tolist()}), flush=True)
launch.shutdown_distributed()
"""


def test_a_smaller_world_meets_no_keys_of_a_larger_one():
    """Process 1 first asks for a world of 3, then of 2, in one process
    and on one coordinator port, while process 0 serves the world of 2:
    the store keys are the world size's own, so the larger attempt times
    out and the world of 2 comes up and reduces right (the reset of the
    group counter lets the second attempt meet process 0's keys)."""
    port = launch.free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    for var in ("FT_COORDINATOR", "FT_NUM_PROCESSES", "FT_PROCESS_ID"):
        env.pop(var, None)
    procs = [subprocess.Popen([sys.executable, "-c", RACE_CHILD, str(r),
                               str(port)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=60)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    docs = {}
    for out in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith("RACE_JSON ")]
        assert lines, out[-3000:]
        d = json.loads(lines[-1][len("RACE_JSON "):])
        docs[d["rank"]] = d
    assert docs[1]["first"] == "timeout"
    for d in docs.values():
        assert d["world"] == 2 and d["sum"] == [3.0] * 5
