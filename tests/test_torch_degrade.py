"""The degrade-to-survivors bring-up, ``parallel.launch.
init_distributed_or_degrade``, against the JAX package's on the CPU.

Scripted scenarios (the JAX ``tests/test_chaos.py`` bring-up cases): a
short world reported upfront, a full attempt that times out and a re-poll
that finds fewer, a config file caught mid-write, and a survivor count
below ``min_processes``.  Each package monkeypatches its own
``init_distributed`` with the same script; both must give the same
``degraded_to``, attempts and error counts, and the same plan field by
field.  Then a real gloo world: 3 processes configured, 2 alive, the full
rendezvous times out catchably and the survivors form their world on the
same coordinator port.  Also the device repair: with no GPU,
``init_distributed`` with no device refuses instead of bringing up gloo.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from flextree_tpu.parallel import launch as j_launch
from flextree_tpu.planner import calibrate as j_calibrate
from flextree_tpu.planner import cost_model as j_cost
from flextree_tpu_torch.parallel import launch
from flextree_tpu_torch.planner import calibrate, cost_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clean_env(monkeypatch):
    for var in ("FT_COORDINATOR", "FT_NUM_PROCESSES", "FT_PROCESS_ID",
                "FT_INIT_TIMEOUT", "FT_INIT_RETRIES", "FLEXTREE_CALIBRATION",
                "FLEXTREE_CALIBRATION_BACKEND"):
        monkeypatch.delenv(var, raising=False)


def plan_view(plan):
    if plan is None:
        return None
    return (plan.num_nodes, plan.nbytes, str(plan.topology),
            plan.to_ft_topo(), plan.advisory,
            [(c.shape_label(), c.family, c.ports, c.lonely, c.torus_aligned,
              dataclasses.astuple(c.cost) + (c.cost.total_us,))
             for c in plan.candidates])


def _scripted(mod, monkeypatch, fail_worlds, on_call=None):
    """``mod.init_distributed`` replaced: a world whose size is in
    ``fail_worlds`` raises ``BringupTimeout`` after 3 attempts; any other
    comes up in one.  Returns the list of world sizes asked for."""
    asked = []

    def fake(config=None, **kw):
        cfg = config if isinstance(config, mod.ClusterConfig) else None
        n = cfg.num_processes if cfg is not None else None
        asked.append(n)
        if on_call is not None:
            on_call()
        if cfg is None or n in fail_worlds:
            raise mod.BringupTimeout("scripted timeout", 3,
                                     ["e1", "e2", "e3"])
        return mod.BringupReport(attempts=1, errors=[])

    monkeypatch.setattr(mod, "init_distributed", fake)
    return asked


#: one set of cost constants for both planners (the packages' defaults
#: differ: each is fitted to its own device)
CONSTANTS = dict(reduce_bw_GBps=352.2, control_us_per_width=0.3,
                 launch_us=2.6, codec_bw_GBps=350.0)


def _run(mod, monkeypatch, scenario, tmp_path):
    """One scripted scenario on one package: ``(outcome, asked)``."""
    _clean_env(monkeypatch)
    cost, cal = (cost_model, calibrate) if mod is launch else \
        (j_cost, j_calibrate)
    params = cost.TpuCostParams(ici=cost.LinkParams(176.0, 9.1),
                                dcn=cost.LinkParams(12.5, 40.0), **CONSTANTS)
    monkeypatch.setattr(cal, "default_params", lambda *a, **k: params)
    polls = {"n": 0}

    def poll(seq):
        def survivors():
            polls["n"] += 1
            return seq[min(polls["n"], len(seq)) - 1]
        return survivors

    cfg = mod.ClusterConfig("h0:1234", 8, 0)
    kw = {}
    if scenario == "upfront":
        asked = _scripted(mod, monkeypatch, ())
        kw["survivors"] = poll([7])
    elif scenario == "repoll":
        asked = _scripted(mod, monkeypatch, (8,))
        kw["survivors"] = poll([8, 6])
    elif scenario == "mid_write":
        path = tmp_path / f"{mod.__name__}.json"
        path.write_text('{"coordinator": "h0:1234", "num_pro')

        def finish():
            path.write_text(json.dumps({"coordinator": "h0:1234",
                                        "num_processes": 8,
                                        "process_id": 0}))

        asked = _scripted(mod, monkeypatch, (8,), on_call=finish)
        cfg = str(path)
        kw["survivors"] = poll([5])
    else:  # below min_processes: never degrade
        asked = _scripted(mod, monkeypatch, (8,))
        kw["survivors"] = poll([2])
        kw["min_processes"] = 4
    try:
        report, plan = mod.init_distributed_or_degrade(cfg, nbytes=1 << 20,
                                                       **kw)
    except mod.BringupTimeout as e:
        return ("raised", e.attempts, len(e.errors), polls["n"]), asked
    return (report.degraded_to, report.attempts, len(report.errors),
            polls["n"], plan_view(plan)), asked


@pytest.mark.parametrize("scenario", ("upfront", "repoll", "mid_write",
                                      "below_min"))
def test_degrade_scenarios_equal_jax(scenario, monkeypatch, tmp_path):
    ours, ours_asked = _run(launch, monkeypatch, scenario, tmp_path)
    theirs, their_asked = _run(j_launch, monkeypatch, scenario, tmp_path)
    assert ours == theirs
    assert ours_asked == their_asked
    want = {"upfront": (7, 1, 0), "repoll": (6, 4, 3), "mid_write": (5, 4, 3),
            "below_min": ("raised", 3, 3)}[scenario]
    assert ours[:3] == want
    if scenario != "below_min":
        assert ours[4][0] == want[0]
        assert any("DEGRADED WORLD" in note for note in ours[4][4])


def test_no_gpu_refuses_without_a_device(monkeypatch):
    """The repair: the default device is ``cuda``; with no GPU the
    bring-up refuses at once and no gloo group comes up."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    _clean_env(monkeypatch)
    port = launch.free_port()
    cfg = launch.ClusterConfig(f"127.0.0.1:{port}", 2, 0)
    with pytest.raises(launch.BringupConfigError, match="no CUDA device"):
        launch.init_distributed(cfg, timeout=1.0, retries=3,
                                merge_env=False)
    assert not torch.distributed.is_initialized()
    with pytest.raises(launch.BringupConfigError, match="no CUDA device"):
        launch.init_distributed_or_degrade(cfg, nbytes=1 << 20, survivors=1,
                                           timeout=1.0)
    assert not torch.distributed.is_initialized()


CHILD = r"""
import json, sys, time
import torch, torch.distributed as dist
from flextree_tpu_torch.parallel import launch
rank, port = int(sys.argv[1]), int(sys.argv[2])
polls = []
def survivors():
    polls.append(1)
    return 3 if len(polls) == 1 else 2
rep, plan = launch.init_distributed_or_degrade(
    launch.ClusterConfig(f"127.0.0.1:{port}", 3, rank), nbytes=4 << 20,
    survivors=survivors, timeout=2.5, retries=2, backend="gloo")
x = torch.full((5,), float(rank + 1))
dist.all_reduce(x)
print("DEGRADE_JSON " + json.dumps({
    "rank": rank, "world": dist.get_world_size(), "attempts": rep.attempts,
    "errors": rep.errors, "degraded_to": rep.degraded_to, "polls": len(polls),
    "sum": x.tolist(), "topo": plan.to_ft_topo()}), flush=True)
launch.shutdown_distributed()
"""


def test_real_gloo_world_degrades_on_the_same_port():
    """3 configured, 2 alive: the full rendezvous times out catchably,
    the re-poll finds 2, and both survivors come up on the same port."""
    port = launch.free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    for var in ("FT_COORDINATOR", "FT_NUM_PROCESSES", "FT_PROCESS_ID"):
        env.pop(var, None)
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(r), str(port)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    docs = []
    for out in outs:
        lines = [ln for ln in out.splitlines()
                 if ln.startswith("DEGRADE_JSON ")]
        assert lines, out[-3000:]
        docs.append(json.loads(lines[-1][len("DEGRADE_JSON "):]))
    for d in docs:
        assert d["world"] == 2 and d["degraded_to"] == 2 and d["polls"] == 2
        assert d["sum"] == [3.0] * 5
        assert d["topo"] == "2"
        # the full world's timeout is among the errors, and the degraded
        # bring-up reused the coordinator's port
        assert d["attempts"] >= 2 and d["errors"]
        assert not any("EADDRINUSE" in e or "address already in use" in e
                       for e in d["errors"])

