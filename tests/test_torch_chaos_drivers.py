"""The port's chaos drivers (``flextree_tpu_torch/tools/``) against the JAX
package's tools: their floors, their exit codes and their outputs.

- Every scenario function of each driver checks the floors, by name, that
  the JAX tool's function of the same name checks (read from both
  sources).
- A driver exits non-zero when a scenario does not recover or its runner
  crashes, and 0 when all recover (the JAX ``tests/test_chaos.py:645,
  :664`` gates), with no result file unless asked for one.
- ``--out`` goes under ``tmp/``; a committed result name is refused.

The real scenarios run in ``test_torch_chaos_*.py``, each under
:func:`no_open_sockets`, the spy that fails a test leaving a socket open.
"""

from __future__ import annotations

import ast
import gc
import json
import os
import socket
import weakref

import pytest

from flextree_tpu_torch.tools import (
    chaos_bringup,
    chaos_runtime,
    committed,
    multiproc_bringup,
    obs_chaos,
    rpc_chaos,
    serve_elastic_chaos,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIVERS = {"chaos_bringup": chaos_bringup, "chaos_runtime": chaos_runtime,
           "multiproc_bringup": multiproc_bringup, "obs_chaos": obs_chaos,
           "rpc_chaos": rpc_chaos,
           "serve_elastic_chaos": serve_elastic_chaos}


@pytest.fixture
def no_open_sockets(monkeypatch):
    """Fails the test if a socket made in this process during it is still
    open at its end (a dropped one would be finalized unclosed in some
    later test, which ``filterwarnings = error`` fails)."""
    made = []
    init = socket.socket.__init__

    def spy(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(weakref.ref(self))

    monkeypatch.setattr(socket.socket, "__init__", spy)
    yield made
    monkeypatch.undo()
    gc.collect()
    left = [s for s in (r() for r in made)
            if s is not None and s.fileno() != -1]
    for s in left:
        s.close()
    assert not left, f"{len(left)} socket(s) left open: {left}"


def floors_by_function(path: str) -> dict:
    """``{function: sorted floor names}`` for each function of ``path``
    that builds a ``floors = {...}`` dict."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    out = {}
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Dict) and any(
                    isinstance(t, ast.Name) and t.id == "floors"
                    for t in node.targets):
                out[fn.name] = sorted(k.value for k in node.value.keys)
    return out


@pytest.mark.parametrize("name", ("obs_chaos", "rpc_chaos",
                                  "serve_elastic_chaos"))
def test_every_jax_floor_is_checked_by_name(name):
    theirs = floors_by_function(os.path.join(ROOT, "tools", f"{name}.py"))
    ours = floors_by_function(DRIVERS[name].__file__)
    assert theirs and set(theirs) <= set(ours)
    for fn, floors in theirs.items():
        assert ours[fn] == floors, fn


@pytest.mark.parametrize("name", ("chaos_bringup", "chaos_runtime"))
def test_the_jax_scenarios_and_their_names(name):
    """The two drivers whose JAX tools gate on ``ok``/``recovered`` keep
    the JAX scenario names, runner names and verdict key."""
    mod = DRIVERS[name]
    path = os.path.join(ROOT, "tools", f"{name}.py")
    with open(path, encoding="utf-8") as f:
        src = f.read()
    runners = {n.name for n in ast.walk(ast.parse(src))
               if isinstance(n, ast.FunctionDef) and n.name.startswith("run_")}
    assert runners <= set(dir(mod))
    scenarios = [a.value for a in ast.parse(src.split("SCENARIOS = ")[1]
                                            .split("\n")[0]).body[0]
                 .value.elts]
    assert list(mod.SCENARIOS) == scenarios
    key = "recovered" if name == "chaos_runtime" else "ok"
    assert f'"{key}"' in src


def _fake(name, **kw):
    return {"scenario": name, "ok": True, "recovered": True, "checks": {},
            "log": [], "logs": [], "returncodes": [], "reports": [],
            "fold_launches": 0, **kw}


def test_chaos_bringup_exits_nonzero_on_an_unrecovered_scenario(monkeypatch):
    ok = _fake("retry")
    monkeypatch.setitem(chaos_bringup.RUNNERS, "retry", lambda *a: ok)
    argv = ["--scenario", "retry", "--no-artifact", "--device", "cpu"]
    assert chaos_bringup.main(argv) == 0
    monkeypatch.setitem(chaos_bringup.RUNNERS, "retry",
                        lambda *a: {**ok, "ok": False})
    assert chaos_bringup.main(argv) == 1

    def crash(*a):
        raise RuntimeError("driver exploded")

    monkeypatch.setitem(chaos_bringup.RUNNERS, "retry", crash)
    assert chaos_bringup.main(argv) == 1


def test_chaos_runtime_exits_nonzero_on_an_unrecovered_scenario(monkeypatch):
    ok = _fake("sigterm")
    argv = ["--scenario", "sigterm", "--no-artifact", "--device", "cpu"]
    monkeypatch.setitem(chaos_runtime.RUNNERS, "sigterm", lambda *a: ok)
    assert chaos_runtime.main(argv) == 0
    monkeypatch.setitem(chaos_runtime.RUNNERS, "sigterm",
                        lambda *a: {**ok, "recovered": False})
    assert chaos_runtime.main(argv) == 1


def test_multiproc_bringup_exits_nonzero_on_a_failed_floor(monkeypatch,
                                                           tmp_path):
    res = {"ok": True, "floors": {"all_passed": True}, "returncodes": [0],
           "logs": [[]]}
    monkeypatch.setattr(multiproc_bringup, "run", lambda *a: res)
    monkeypatch.chdir(tmp_path)
    assert multiproc_bringup.main(["--device", "cpu"]) == 0
    with open(tmp_path / "tmp" / "multiproc_bringup.json") as f:
        assert json.load(f)["ok"] is True
    monkeypatch.setattr(multiproc_bringup, "run", lambda *a: {
        **res, "ok": False, "floors": {"all_passed": False}})
    assert multiproc_bringup.main(["--device", "cpu",
                                   "--no-artifact"]) == 1


def test_obs_chaos_exits_nonzero_on_a_failed_floor(monkeypatch):
    good = {"scenario": "sigkill_recorded", "ok": True, "floors": {}}
    over = {"ok": True, "recorder_overhead": 1.0, "budget": 1.02}
    argv = ["--no-artifact", "--device", "cpu"]
    monkeypatch.setattr(obs_chaos, "run_kill_scenario", lambda *a: good)
    monkeypatch.setattr(obs_chaos, "run_overhead_bench", lambda *a: over)
    assert obs_chaos.main(argv) == 0
    monkeypatch.setattr(obs_chaos, "run_overhead_bench",
                        lambda *a: {**over, "ok": False})
    assert obs_chaos.main(argv) == 1
    monkeypatch.setattr(obs_chaos, "run_overhead_bench", lambda *a: over)
    monkeypatch.setattr(obs_chaos, "run_kill_scenario",
                        lambda *a: {**good, "ok": False})
    assert obs_chaos.main(argv) == 1


@pytest.mark.parametrize("name", ("rpc_chaos", "serve_elastic_chaos"))
def test_serving_drivers_exit_nonzero_on_a_failed_floor(name, monkeypatch):
    mod = DRIVERS[name]
    first = mod.SMOKE[0]
    monkeypatch.setattr(rpc_chaos, "Oracle", lambda device: object())
    table = dict(mod.SCENARIOS)
    monkeypatch.setattr(mod, "SCENARIOS", table)
    argv = ["--only", first, "--no-artifact", "--device", "cpu"]
    table[first] = lambda wd, oracle: {"scenario": first, "ok": True,
                                       "floors": {}}
    assert mod.main(argv) == 0
    table[first] = lambda wd, oracle: {"scenario": first, "ok": False,
                                       "floors": {"x": False}}
    assert mod.main(argv) == 1
    with pytest.raises(SystemExit):
        mod.main(["--only", "no_such_scenario", "--no-artifact"])


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_results_go_under_tmp_never_to_a_committed_file(name, tmp_path,
                                                        monkeypatch):
    monkeypatch.chdir(tmp_path)
    for bad in ("CHAOS_RUNTIME.json", "tmp/RPC_CHAOS.json",
                os.path.join(ROOT, "elsewhere.json")):
        with pytest.raises(SystemExit):
            DRIVERS[name].main(["--out", bad, "--device", "cpu"])


def test_the_committed_results_are_the_jax_drivers():
    for name in ("CHAOS_BRINGUP", "MULTIPROC_BRINGUP", "CHAOS_RUNTIME",
                 "OBS_CHAOS", "OBS_TIMELINE", "RPC_CHAOS", "SERVE_ELASTIC",
                 "COORD_CHAOS", "ARBITER_SPIKE"):
        assert committed(f"{name}.json")
        assert os.path.exists(os.path.join(ROOT, f"{name}.json"))
    assert not committed("chaos_runtime.json")
