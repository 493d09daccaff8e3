"""The port's A/B drivers (``flextree_tpu_torch/tools/``: ``bench_bucketing``,
``zigzag_accounting``, ``bench_prefix``, ``bench_quantize``,
``bench_sharded``, ``bench_overlap``, ``bench_disagg``) against the JAX
package's tools of the same names:

- every floor constant equal, read from the JAX tool's source;
- the workloads bitwise the JAX builders' from the same seed (zigzag's
  schedule tables for n = 1..8, ``bench_prefix.build_round``,
  ``bench_disagg.build_workload``);
- every driver raises without a card unless asked for the CPU, and
  refuses an ``--out`` that names a committed result or lies outside
  ``tmp/``;
- the in-process drivers and the replica fleets run once at tiny sizes on
  the CPU, their reports carrying the JAX tool's keys and floors;
- the prefix cache's negative control catches a cache that invents
  sharing.

The gloo drivers run in ``test_torch_ab_gloo.py``; the transports'
counters in ``test_torch_wire_counters.py``.
"""

from __future__ import annotations

import ast
import importlib.util
import json
import os

import numpy as np
import pytest
import torch
from test_torch_bench_tools import jax_dict_keys
from test_torch_chaos_drivers import floors_by_function
from test_torch_chaos_drivers import no_open_sockets  # noqa: F401

from flextree_tpu_torch.serving import prefix_index
from flextree_tpu_torch.tools import (
    bench_bucketing,
    bench_disagg,
    bench_overlap,
    bench_prefix,
    bench_quantize,
    bench_sharded,
    zigzag_accounting,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIVERS = {"bench_bucketing": bench_bucketing,
           "zigzag_accounting": zigzag_accounting,
           "bench_prefix": bench_prefix, "bench_quantize": bench_quantize,
           "bench_sharded": bench_sharded, "bench_overlap": bench_overlap,
           "bench_disagg": bench_disagg}
#: each driver's JAX result file, which the port never writes
COMMITTED = {"bench_bucketing": "BENCH_BUCKETING.json",
             "zigzag_accounting": "ZIGZAG_ACCOUNTING.json",
             "bench_prefix": "BENCH_PREFIX.json",
             "bench_quantize": "BENCH_QUANT.json",
             "bench_sharded": "BENCH_SHARDED.json",
             "bench_overlap": "BENCH_OVERLAP.json",
             "bench_disagg": "BENCH_DISAGG.json"}
TINY = dict(vocab_size=256, d_model=32, n_heads=4, n_layers=2, d_ff=64)


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_tool(name: str):
    """The JAX package's ``tools/<name>.py``, loaded from its file."""
    path = os.path.join(ROOT, "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_constants(name: str) -> dict:
    """The module-level UPPER_CASE constants of a JAX tool (and the
    function-level ``MIN_MEASURABLE_MS``), evaluated from its source."""
    with open(os.path.join(ROOT, "tools", f"{name}.py"),
              encoding="utf-8") as f:
        tree = ast.parse(f.read())
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            key = node.targets[0].id
            if key.isupper() and (node in tree.body
                                  or key == "MIN_MEASURABLE_MS"):
                try:
                    out[key] = eval(compile(ast.Expression(node.value), "",
                                            "eval"), {"__builtins__": {}})
                except Exception:  # a path or a call: not a constant
                    continue
    return out


def returned_keys(name: str, fn: str) -> set:
    """Keys of the dict literal the JAX tool's function ``fn`` returns."""
    with open(os.path.join(ROOT, "tools", f"{name}.py"),
              encoding="utf-8") as f:
        tree = ast.parse(f.read())
    func = next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == fn)

    def own(node):  # the function's own statements, not nested defs'
        for child in ast.iter_child_nodes(node):
            if not isinstance(child, (ast.FunctionDef, ast.Lambda)):
                yield child
                yield from own(child)

    return {k.value for n in own(func) if isinstance(n, ast.Return)
            and isinstance(n.value, ast.Dict) for k in n.value.keys}


# the JAX overlap tool's model constants, kept as the port's WIDTHS["jax"]
OVERLAP_MODEL = {"VOCAB": "vocab_size", "D_MODEL": "d_model",
                 "N_HEADS": "n_heads", "N_LAYERS": "n_layers",
                 "D_FF": "d_ff"}


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_floor_constants_are_the_jax_tools(name):
    theirs = {k: v for k, v in jax_constants(name).items()
              if k not in ("REPO", "TOOLS")}
    mod = DRIVERS[name]
    for key, value in theirs.items():
        if name == "bench_overlap" and key in OVERLAP_MODEL:
            assert mod.WIDTHS["jax"][OVERLAP_MODEL[key]] == value, key
        else:
            assert getattr(mod, key) == value, key
    if name in ("bench_bucketing", "zigzag_accounting"):
        assert theirs == {}  # the JAX tools have no floor constant


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_raises_without_a_card(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DRIVERS[name].main(["--out", os.path.join("tmp", "x.json")])


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_out_refuses_committed_results_and_paths_outside_tmp(name, tmp_path,
                                                             monkeypatch):
    monkeypatch.chdir(tmp_path)
    for out in (COMMITTED[name], os.path.join("tmp", COMMITTED[name]),
                os.path.join(os.sep, "ft-results", "x.json")):
        with pytest.raises(SystemExit):
            DRIVERS[name].main(["--out", out, "--device", "cpu"])
    assert os.listdir(tmp_path) == []


def test_zigzag_tables_are_the_jax_tools_bitwise():
    theirs = jax_tool("zigzag_accounting")
    for n in range(1, 9):
        t = zigzag_accounting.schedule_tables(n)
        assert t == theirs.schedule_tables(n), n
        assert zigzag_accounting.table_violations(t) == []
        assert (t["plain_critical_path"], t["zigzag_critical_path"],
                t["plain_total_work"]) == (4 * n - 2, 2 * n, 2 * n * n)


def test_zigzag_table_check_catches_a_wrong_branch(monkeypatch):
    from flextree_tpu_torch.parallel import zigzag

    # the late pair's order not flipped: zigzag loses its balance
    monkeypatch.setattr(zigzag, "hop_branches", lambda src, idx: (
        (0, 0) if src == idx else ((1, 1) if src < idx else (2, 2))))
    bad = zigzag_accounting.table_violations(
        zigzag_accounting.schedule_tables(4))
    assert any("zigzag critical path" in v for v in bad)


def test_zigzag_driver_runs_and_keeps_the_jax_keys(tmp_path, monkeypatch,
                                                   one_thread):
    monkeypatch.chdir(tmp_path)
    assert zigzag_accounting.main(["--device", "cpu",
                                   "--skip-wallclock"]) == 0
    with open(os.path.join("tmp", "zigzag_accounting.json")) as f:
        doc = json.load(f)
    assert jax_dict_keys("zigzag_accounting", "doc") <= set(doc)
    assert doc["violations"] == [] and "wall_clock_1core_host" not in doc
    # the wall rows at a shorter sequence (the CLI runs the JAX T=2048)
    wall = zigzag_accounting.wall_clock("cpu", t_total=256, reps=2)
    assert returned_keys("zigzag_accounting", "wall_clock_8vdev") <= \
        set(wall)
    assert set(wall["impls"]) == {"reference", "flash"}
    for row in wall["impls"].values():
        assert row["outputs_agree"] and row["wall_ratio_plain_over_zigzag"] > 0


def _jax_requests(reqs):
    return [(r.rid, np.asarray(r.prompt).tobytes(), r.max_new_tokens)
            for r in reqs]


def test_prefix_round_is_the_jax_tools_bitwise():
    theirs = jax_tool("bench_prefix")
    for seed in (0, 3):
        rounds = []
        for build in (theirs.build_round, bench_prefix.build_round):
            rng = np.random.default_rng(seed)
            sys_prompts = [rng.integers(0, bench_prefix.WORKLOAD_VOCAB,
                                        (bench_prefix.SYS_LEN,)).astype(
                                            np.int32)
                           for _ in range(bench_prefix.N_SYS)]
            rounds.append([_jax_requests(build(
                rng, sys_prompts, 24, 24 * k, bench_prefix.WORKLOAD_VOCAB))
                for k in range(3)])
        assert rounds[0] == rounds[1]


def test_disagg_workload_is_the_jax_tools_bitwise():
    theirs = jax_tool("bench_disagg")
    for seed in (29, 37, 43):
        a = theirs.build_workload(seed, 28)
        b = bench_disagg.build_workload(seed, 28)
        assert [(r["rid"], r["prompt"].tobytes(), r["max_new"], r["gap_s"])
                for r in a] == [(r["rid"], r["prompt"].tobytes(),
                                 r["max_new"], r["gap_s"]) for r in b]


def test_bucketing_runs_and_keeps_the_jax_keys(one_thread):
    doc = bench_bucketing.run_bench(
        quick=True, device="cpu", leaf_size=64, n_leaves=6, large=4096,
        model=dict(vocab_size=64, d_model=32, n_heads=4, d_ff=64),
        repeat=(2, 2), log=lambda m: None)
    assert jax_dict_keys("bench_bucketing", "doc") <= set(doc)
    assert set(doc["results"]) == {"sync_many_small", "sync_single_large",
                                   "train_step"}
    for regime in ("sync_many_small", "sync_single_large"):
        assert doc["results"][regime]["identical"]
        assert {"per_leaf", "ours_fused", "ours_chunked"} <= \
            set(doc["results"][regime]["rows"])
    assert doc["results"]["train_step"]["identical"]
    assert "in-process mesh" in doc["host"]["note"]
    assert "1-core" not in doc["diagnosis"]


def test_prefix_floors_are_the_jax_tools_by_name():
    theirs = floors_by_function(os.path.join(ROOT, "tools",
                                             "bench_prefix.py"))
    ours = floors_by_function(bench_prefix.__file__)
    # the JAX tool builds them in main; the port in run_bench
    assert ours == {"run_bench": theirs["main"]}


def test_prefix_runs_with_every_floor(one_thread):
    doc = bench_prefix.run_bench(smoke=True, device="cpu", widths=TINY,
                                 log=lambda m: None)
    theirs = jax_dict_keys("bench_prefix", "floors") | {"bitwise_ok"}
    assert theirs == set(doc["floors"])
    assert jax_dict_keys("bench_prefix", "doc") <= set(doc)
    assert jax_dict_keys("bench_prefix", "stat") <= set(doc["rounds"][0])
    assert returned_keys("bench_prefix", "negative_control") <= \
        set(doc["negative_control"])
    fl = doc["floors"]
    assert doc["ok"] and fl["bitwise_ok"] and fl["negative_control_ok"]
    assert not fl["ttft_floor_enforced"] and fl["ttft_ok"]
    # the fused path ran every decode round of both engines
    assert doc["fused_rounds"]["warm"] > 0 and doc["fused_rounds"]["cold"] > 0


def test_negative_control_catches_a_cache_that_invents_sharing(
        monkeypatch, one_thread):
    # the full run's control: 12 unique prompts through 4 slots, so later
    # admissions meet the index the first retirements filled
    cfg, params = bench_prefix._model(TINY, torch.device("cpu"))
    pcfg = bench_prefix._pcfg()
    honest = bench_prefix.negative_control(cfg, params, pcfg, 7, 12, "cpu")
    assert honest["ok"] and honest["hits"] == 0
    # a key that ignores the tokens: every block j matches any block j
    monkeypatch.setattr(prefix_index.PrefixIndex, "_key",
                        staticmethod(lambda tokens, j, bs: (j,)))
    lying = bench_prefix.negative_control(cfg, params, pcfg, 7, 12, "cpu")
    assert not lying["ok"] and lying["hits"] > 0


def test_disagg_runs_with_every_floor(no_open_sockets):  # noqa: F811
    doc = bench_disagg.run_bench(smoke=True, device="cpu", n=4,
                                 log=lambda m: None)
    assert doc["ok"], json.dumps(doc["scenarios"], default=str)[:3000]
    assert set(doc["scenarios"]) == set(bench_disagg.SCENARIOS)
    # the JAX tool's result document: the dict it hands write_result_file
    with open(os.path.join(ROOT, "tools", "bench_disagg.py"),
              encoding="utf-8") as f:
        call = next(n for n in ast.walk(ast.parse(f.read()))
                    if isinstance(n, ast.Call)
                    and ast.unparse(n.func) == "write_result_file")
    assert {k.value for k in call.args[1].keys} <= set(doc)
    identity = returned_keys("bench_disagg", "_identity_floors")
    for name, r in doc["scenarios"].items():
        r.pop("fd", None)
        assert identity <= set(r["floors"]), name
        assert returned_keys("bench_disagg", "run_migration_scenario") <= \
            set(r), name
        # each drained replica's paged launches: none on the CPU
        lc = r["checks"]["launches"]
        for fleet in ([lc] if "by_rank" in lc else lc.values()):
            assert fleet["launches_the_codes"]
    mig8 = doc["scenarios"]["migration_int8"]["floors"]
    assert mig8["codec_error_bound_ok"]
    perf = doc["scenarios"]["disagg_vs_colocated"]
    assert perf["floors"]["colocated_control_clean"]
    assert perf["floors"]["decode_p99_ratio_recorded"]
    assert perf["checks"]["p99_ratio_floor"] is None


def test_disagg_crossover_comes_from_the_planner():
    from flextree_tpu_torch.serving.costs import migration_crossover_tokens

    cross = bench_disagg.crossover("int8", "cpu")
    cfg, pcfg = bench_disagg._bench_geometry("cpu")
    assert cross["tokens"] == migration_crossover_tokens(cfg, pcfg, "int8",
                                                         device="cpu")
    assert {k: getattr(pcfg, k) for k in bench_disagg.rc.CACHE} == \
        bench_disagg.rc.CACHE
