"""The port's serving A/B bench (``flextree_tpu_torch/tools/
bench_serving.py``) on the CPU: ``--device cpu --smoke`` at the tiny
width runs with its bitwise and degrade floors holding and the JAX
bench's report keys (its workload and ``prefill_ragged`` against JAX:
``test_torch_bench_serving_jax.py``)."""

from __future__ import annotations

import json
import os

import pytest
import torch

from flextree_tpu_torch.tools import bench_serving as tbs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke_report(tmp_path_factory):
    out = tmp_path_factory.mktemp("bench") / "report.json"
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the tiny model's ops: one thread is fastest
    try:
        rc = tbs.main(["--device", "cpu", "--smoke", "--width", "tiny",
                       "--out", str(out)])
    finally:
        torch.set_num_threads(threads)
    with open(out) as f:
        return rc, json.load(f)


def test_smoke_runs_with_its_floors(smoke_report):
    rc, doc = smoke_report
    assert rc == 0 and doc["ok"] is True
    floors = doc["floors"]
    assert floors["bitwise_ok"] and floors["paged_bitwise_violations"] == 0
    assert floors["bitwise_checked"] == 6
    assert floors["throughput_floor_enforced"] is False
    assert floors["throughput_ok"] is True
    assert floors["throughput_ratio"] > 0
    kill = floors["replica_kill"]
    assert kill["ok"] and kill["missing"] == [] and kill["degraded"]
    assert kill["completed"] == kill["submitted"] == 6
    assert kill["reroutes"] >= 1 and kill["oracle_violations"] == 0
    assert kill["kills"] == [{"rank": 1, "mode": "hang"}]
    assert doc["continuous"]["tokens"] == doc["static"]["tokens"] > 0
    assert doc["device"] == {"type": "cpu"}
    assert doc["config"]["width"] == "tiny"


def test_report_has_the_jax_bench_keys(smoke_report):
    """The JAX bench's committed report is the key reference; the port
    adds ``device`` (the card's nvidia-smi line) and ``config.width``, and
    its host names torch where the JAX one names jax."""
    _, doc = smoke_report
    with open(os.path.join(REPO, "BENCH_SERVING.json")) as f:
        ref = json.load(f)
    assert set(doc) == set(ref) | {"device"}
    assert set(doc["floors"]) == set(ref["floors"])
    assert set(doc["config"]) == set(ref["config"]) | {"width"}
    assert set(doc["config"]["workload"]) == set(ref["config"]["workload"])
    for side in ("continuous", "static"):
        assert set(doc[side]) == set(ref[side])
        assert set(doc[side]["ttft_ms"]) == set(ref[side]["ttft_ms"])
    assert set(doc["host"]) == set(ref["host"]) - {"jax"} | {"torch"}
    # the kill report is the pool's report plus the scenario's verdict;
    # the committed file predates three of the JAX pool's report keys
    # (test_torch_pool.py holds the port pool's keys to the JAX pool's)
    kill = set(doc["floors"]["replica_kill"])
    assert kill == set(ref["floors"]["replica_kill"]) | {
        "released", "metrics", "replica_metrics"}


def test_refusals(tmp_path, monkeypatch, capsys):
    with pytest.raises(SystemExit):
        tbs.main(["--device", "cpu", "--out",
                  str(tmp_path / "BENCH_SERVING.json")])
    assert "JAX bench's artifact" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbs.main(["--smoke", "--width", "tiny", "--out",
                  str(tmp_path / "r.json")])
