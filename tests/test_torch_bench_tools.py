"""The port's kernel drivers on the CPU: ``tools.bench_attention``,
``tools.roofline_reduce``, ``tools.bench_paged`` and
``tools.measure_launch``, each against its JAX tool's report keys and
floors, each refusing a committed result or a path outside ``tmp/``, and
each raising without a card unless asked for the CPU."""

import ast
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_chaos_drivers import floors_by_function

from flextree_tpu.ops.pallas_reduce import reduce_stacked as jreduce
from flextree_tpu_torch.bench import harness
from flextree_tpu_torch.ops.reduce_stacked import (
    reduce_stacked,
    reduce_stacked_reference,
)
from flextree_tpu_torch.tools import bench_attention as ba
from flextree_tpu_torch.tools import bench_paged as bp
from flextree_tpu_torch.tools import measure_launch as ml
from flextree_tpu_torch.tools import roofline_reduce as rr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = {"bench_attention": ba, "roofline_reduce": rr, "bench_paged": bp,
         "measure_launch": ml}
SMALL = ["--batch", "1", "--seq-len", "32", "--heads", "2", "--head-dim",
         "16", "--dtype", "float32", "--samples", "1"]


@pytest.fixture
def one_thread():
    """The tiny models run faster on one intra-op thread than on a pool
    that shares the host with the JAX package's."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_dict_keys(tool: str, target: str) -> set:
    """Keys of the dict literals the JAX tool passes to ``target`` (a call
    like ``rows.append({...})``) or assigns to ``target``."""
    with open(os.path.join(ROOT, "tools", f"{tool}.py"), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    keys = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and ast.unparse(node.func) == target and node.args
                and isinstance(node.args[0], ast.Dict)):
            keys |= {k.value for k in node.args[0].keys}
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(ast.unparse(t) == target for t in node.targets)):
            keys |= {k.value for k in node.value.keys if k is not None}
    return keys


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_out_refuses_committed_results_and_paths_outside_tmp(tool, tmp_path,
                                                             monkeypatch):
    monkeypatch.chdir(tmp_path)
    # (tmp_path lies under the system's temporary directory, which tools
    # may write; a path at the file system's root lies outside both)
    for out in ("BENCH_PAGED.json", os.path.join("tmp", "BENCH_X.json"),
                os.path.join(os.sep, "ft-results", "x.json")):
        with pytest.raises(SystemExit):
            TOOLS[tool].main(["--out", out, "--device", "cpu"])
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_raises_without_a_card(tool, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TOOLS[tool].main(["--out", os.path.join("tmp", "x.json")])


def test_bench_attention_rows_keep_the_jax_names(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert ba.main([*SMALL, "--device", "cpu"]) == 0
    with open(os.path.join("tmp", "bench_attention.json")) as f:
        doc = json.load(f)
    jax_doc = jax_dict_keys("bench_attention", "doc")
    assert jax_doc - {"chip_peak_bf16_tflops"} <= set(doc)
    assert doc["ok"] and set(doc["entries"]) == set(ba.ROWS)
    # every JAX row name is timed or names the timed row it stands for
    with open(os.path.join(ROOT, "tools", "bench_attention.py")) as f:
        src = f.read()
    jax_rows = set(ba.FORWARD_NAMES) | {
        n for n in ("stock_tuned_1024_512", "stock_default_shape_512",
                    "xla_full_matrix", "ours_grad_loop_256_512",
                    "stock_grad_1024_512", "stock_grad_512_512")
        if f'"{n}"' in src}
    assert jax_rows == set(ba.ROWS) | set(ba.SAME_KERNEL)
    assert set(ba.SAME_KERNEL.values()) <= set(ba.ROWS)
    for name, row in doc["entries"].items():
        assert row["device"] == "cpu" and row["per_call_s"] > 0, name
    stock = doc["entries"]["stock_tuned_1024_512"]["per_call_s"]
    ours = doc["entries"]["ours_loop_256_512"]["per_call_s"]
    assert doc["vs_tuned_stock"] == pytest.approx(stock / ours, rel=1e-3)


def test_bench_attention_exits_1_on_a_failing_row(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    real = harness.run_attention_bench

    def failing(cfg, **kw):
        if cfg.impl == "stock":
            raise RuntimeError("launch failed")
        return real(cfg, **kw)

    monkeypatch.setattr(harness, "run_attention_bench", failing)
    assert ba.main([*SMALL, "--device", "cpu"]) == 1
    with open(os.path.join("tmp", "bench_attention.json")) as f:
        doc = json.load(f)
    assert not doc["ok"]
    assert "launch failed" in doc["entries"]["stock_tuned_1024_512"]["error"]
    assert doc["vs_tuned_stock"] is None


def test_roofline_rows_and_every_tile_bitwise(tmp_path, monkeypatch,
                                             one_thread):
    monkeypatch.chdir(tmp_path)
    length = 1003
    assert rr.main(["--device", "cpu", "--length", str(length),
                    "--sweep-tiles"]) == 0
    with open(os.path.join("tmp", "roofline_reduce.json")) as f:
        doc = json.load(f)
    assert jax_dict_keys("roofline_reduce", "rows.append") <= \
        set(doc["results"][0])
    jax_doc = jax_dict_keys("roofline_reduce", "doc")
    assert jax_doc - {"xla_fused_sum_w8_GBps", "xla_fused_sum_isolated",
                      "ceiling_note"} <= set(doc)
    assert [(r["w"], r["dtype"]) for r in doc["results"]] == \
        [(w, d) for w in rr.WIDTHS for d in rr.DTYPES]
    for row in doc["results"]:
        assert row["rows_tile"] is None and row["bitwise_vs_plain"]
        want_tiles = [st for st in rr.SWEEP if st == 1 or row["w"] % st == 0]
        assert sorted(map(int, row["tiles"])) == want_tiles
        # the fold the tool timed, at every tile, against the JAX kernel
        # (interpret mode) on the same sources, and at 1 the left fold
        dtype = harness.torch_dtype(row["dtype"])
        x = harness.seeded_rows(row["w"], length, dtype, seed=row["w"])
        xj = jnp.asarray(x.float().numpy(),
                         dtype=jnp.float32 if dtype == torch.float32
                         else jnp.bfloat16)
        for st in want_tiles:
            got = reduce_stacked(x, "sum", sources_tile=st)
            want = jreduce(xj, op="sum", sources_tile=st, interpret=True)
            assert got.float().numpy().tobytes() == \
                np.asarray(want.astype(jnp.float32)).tobytes(), (row["w"], st)
        assert torch.equal(reduce_stacked(x, "sum"),
                           reduce_stacked_reference(x, "sum"))


def test_bench_paged_smoke_checks_every_jax_floor(tmp_path, monkeypatch,
                                                  one_thread):
    monkeypatch.chdir(tmp_path)
    assert bp.main(["--device", "cpu", "--width", "tiny", "--smoke"]) == 0
    with open(os.path.join("tmp", "bench_paged.json")) as f:
        doc = json.load(f)
    theirs = floors_by_function(os.path.join(ROOT, "tools", "bench_paged.py"))
    assert sorted(doc["floors"]) == theirs["main"]
    assert doc["ok"] and doc["device"]["type"] == "cpu"
    floors = doc["floors"]
    assert floors["fused_correct_ok"] and floors["concurrency_ok"]
    # every request exactly once, on generate's tokens, with a preemption
    for key in ("admission_ondemand", "preempt_recompute"):
        s = doc[key]
        assert s["preempts"] >= 1 and s["oracle_violations"] == 0
        assert s["completed"] == s["completed_unique"] == s["submitted"]
    assert doc["admission_reserve"]["oracle_violations"] == 0
    assert bp.LOGITS_ATOL == pytest.approx(2e-4)  # the JAX tool's


def test_measure_launch_keys(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert ml.main(["--device", "cpu"]) == 0
    with open(os.path.join("tmp", "measure_launch.json")) as f:
        doc = json.load(f)
    assert {"device_op_us", "host_dispatch_us", "launch_us",
            "provenance"} <= set(doc)
    lo, hi = sorted((max(doc["device_op_us"], 1e-3),
                     max(doc["host_dispatch_us"], 1e-3)))
    assert doc["launch_us"] == pytest.approx((lo * hi) ** 0.5)
    assert doc["device"] == "cpu"
