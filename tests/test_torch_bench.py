"""The port's benchmark CLI and harness (``python -m
flextree_tpu_torch.bench``) on the CPU: the allreduce bench is correct and
reports the JAX harness's payload keys, the fold bench runs and its kernel
path matches the plain fold, the bus-bandwidth formula is the JAX
package's, the timing loops count what they should, and without a GPU the
CLI refuses to run unless asked for the CPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from flextree_tpu.bench import harness as jharness
from flextree_tpu.planner.cost_model import bus_bandwidth_GBps as j_bus
from flextree_tpu.utils.timing import BenchResult as JBenchResult
from flextree_tpu_torch.bench import harness
from flextree_tpu_torch.utils import timing

ROOT = Path(__file__).resolve().parent.parent


def cli(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-m", "flextree_tpu_torch.bench",
                           *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=240)


def jax_payload_keys():
    report = jharness.BenchReport(jharness.BenchConfig(), 8, "4*2",
                                  JBenchResult((1.0,), 0.0), 1.0, True)
    return set(report.payload()), set(report.payload()["config"])


def test_allreduce_cli_on_the_cpu_is_correct_with_the_jax_keys():
    out = cli("--device", "cpu", "--ranks", "8", "--topo", "4,2",
              "--size", "35")
    assert out.returncode == 0, out.stderr
    payload = json.loads(out.stdout.strip().splitlines()[-1])
    keys, config_keys = jax_payload_keys()
    assert keys <= set(payload) and config_keys <= set(payload["config"])
    assert payload["correct"] is True
    assert payload["num_devices"] == 8 and payload["topo"] == "4*2"
    assert payload["device"]["type"] == "cpu"
    assert len(payload["times_s"]) == 10


@pytest.mark.parametrize("topo", ("swing", "gen:4,2@2"))
def test_allreduce_cli_runs_an_ir_family_named_by_its_spec(topo):
    out = cli("--device", "cpu", "--ranks", "8", "--topo", topo,
              "--size", "1003", "--repeat", "3")
    assert out.returncode == 0, out.stderr
    payload = json.loads(out.stdout.strip().splitlines()[-1])
    assert payload["correct"] is True and payload["topo"] == topo


def test_reduce_cli_on_the_cpu_runs():
    out = cli("--bench", "reduce", "--device", "cpu", "--repeat", "3")
    assert out.returncode == 0, out.stderr
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert [r["W"] for r in doc["rows"]] == [2, 4, 8]
    assert all(r["bitwise_vs_plain"] and r["bound_ms"] is None
               for r in doc["rows"])


def test_cli_without_a_gpu_refuses_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CLI would run on it")
    out = cli("--size", "35")
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and '"correct"' not in out.stdout


@pytest.mark.parametrize("topo,n,dtype,op", [
    ("1", 7, "bfloat16", "sum"), ("3,2+1", 7, "float16", "prod"),
    ("2,2,2", 8, "int8", "sum"), ("4", 4, "uint32", "max"),
    (None, 5, "bool", "bxor"), ("2,4", 8, "float64", "min"),
])
def test_run_allreduce_bench_is_correct(topo, n, dtype, op, tmp_path):
    cfg = harness.BenchConfig(size=300, repeat=3, topo=topo, devices=n,
                              dtype=dtype, op=op, device="cpu",
                              to_file=True, out_dir=str(tmp_path))
    report = harness.run_allreduce_bench(cfg)
    assert report.correct and report.num_devices == n
    assert report.calls == 1 + harness.WARMUP + cfg.repeat + 1
    name = Path(report.result_path).name
    assert name.startswith(f"flextree.{n}.300.") and ".ar_test." in name
    assert json.loads(Path(report.result_path).read_text())["correct"]


def test_bench_rejects_what_it_cannot_run():
    with pytest.raises(ValueError):
        harness.run_allreduce_bench(harness.BenchConfig(comm_type="xla",
                                                        device="cpu"))
    with pytest.raises(TypeError):
        harness.run_allreduce_bench(harness.BenchConfig(
            dtype="float32", op="band", device="cpu"))


@pytest.mark.parametrize("n,nbytes,us", [(8, 1 << 20, 100.0), (2, 35, 3.5),
                                         (1, 10, 1.0), (4, 10, 0.0)])
def test_bus_bandwidth_is_the_jax_formula(n, nbytes, us):
    assert harness.bus_bandwidth_GBps(n, nbytes, us) == j_bus(n, nbytes, us)


def test_reduce_bench_rows_and_copy_plain():
    doc = harness.run_reduce_bench(harness.ReduceBenchConfig(
        shapes=((3, 100), (8, 33)), op="max", repeat=2, device="cpu"))
    assert [(r["W"], r["L"]) for r in doc["rows"]] == [(3, 100), (8, 33)]
    assert all(r["library_ms"] is not None for r in doc["rows"])
    x = torch.arange(10)
    assert torch.equal(harness.hbm_copy(x), x)
    assert harness.hbm_copy(x).data_ptr() != x.data_ptr()


def test_timing_loops_on_the_cpu():
    calls = []
    res = timing.time_fn(lambda t: calls.append(t), torch.ones(1), repeat=5,
                         warmup=2)
    assert len(res.times_s) == 5 and len(calls) == 1 + 2 + 5
    assert res.min_s <= res.median_s and res.min_s <= res.avg_s
    seen = []
    res = timing.time_fn_inplace(lambda t: (seen.append(int(t)), t + 1)[1],
                                 torch.zeros(()), repeat=3, warmup=1,
                                 before=lambda: seen.append(-1))
    assert seen == [0, 1, -1, 2, -1, 3, -1, 4]
    assert timing.BenchResult((3.0, 1.0, 2.0, 4.0), 0.0).median_s == 2.5


def test_seeded_rows_cover_the_dtypes():
    for name in ("float32", "bfloat16", "int8", "uint16", "uint32", "uint64",
                 "bool"):
        dt = harness.torch_dtype(name)
        a = harness.seeded_rows(3, 50, dt, seed=1)
        b = harness.seeded_row(2, 50, dt, seed=1)
        assert a.dtype == dt and a.shape == (3, 50)
        assert harness.digest(a[2]) == harness.digest(b)
        assert harness.digest(a[0]) != harness.digest(a[1])
