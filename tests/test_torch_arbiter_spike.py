"""``tools.arbiter_spike.run_spike`` on the CPU at a small size: the JAX
tool's one-process story (``tools/arbiter_spike.py``) with a tiny
trainer and serving model and short phases.  The burst breaches, the
arbiter preempts two chips, the ZeRO-1 trainer shrinks dp-3 → dp-1 and
expands back, each a bitwise resume, every request is served exactly
once, and the merged timeline is valid with the arbiter's events in
order on their lane.
"""

from __future__ import annotations

import json

import pytest
import torch

from flextree_tpu_torch.obs import flight_recorder
from flextree_tpu_torch.tools import arbiter_spike


def test_arbiter_spike_on_the_cpu(tmp_path, monkeypatch):
    torch.set_num_threads(1)
    # a short window and tick for short phases; the rates come from a
    # capacity pinned at 20 / 1.7 requests/s (a baseline of ~3, a burst
    # of 20), the SLO from the measured service time
    monkeypatch.setattr(arbiter_spike, "WINDOW_S", 2.0)
    monkeypatch.setattr(arbiter_spike, "TICK_S", 0.2)
    measure = arbiter_spike.measure_capacity
    monkeypatch.setattr(arbiter_spike, "measure_capacity",
                        lambda *a: {**measure(*a),
                                    "rps": 20.0 / arbiter_spike.SPIKE_FRAC})
    cfg = arbiter_spike.SpikeConfig(
        device="cpu", smoke=True, phases=(1.5, 2.5, 4.0), post_steps=2,
        deadline_s=60.0,
        train_model=dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2,
                         d_ff=64), train_seq=16,
        serve_model=dict(vocab_size=64, d_model=64, n_heads=4, n_layers=2,
                         d_ff=128))
    obs = str(tmp_path / "obs")
    with flight_recorder(obs, rank=0):
        doc = arbiter_spike.run_spike(cfg, str(tmp_path), log=lambda m: None)
    run = doc.pop("_run")
    arbiter_spike.check_timeline(doc, obs)
    assert doc["ok"] and not doc["violations"], doc["violations"]
    epochs = doc["training"]["lease_epochs"]
    assert [len(e["chips"]) for e in epochs] == [1, 3]
    assert all(e["bitwise_resume"] for e in epochs)
    assert doc["serving"]["completed"] == doc["serving"]["submitted"] == \
        len(run["requests"])
    assert doc["arbiter"]["final_train_chips"] == [0, 1, 2]
    order = doc["timeline"]["arbiter_order"]
    assert order[0] == "lease_grant" and "lease_return" in order
    assert doc["timeline"]["arbiter_lane"] >= 4
    assert len(doc["training"]["resize_s"]) == 2
    assert doc["capacity"]["rps"] > 0 and doc["deviation"]
    assert doc["phases"]["spike_rate_rps"] == pytest.approx(20.0)
    # each phase holds its mean count: the burst is 20 requests/s for 2.5 s
    lo, hi = cfg.phases[0], cfg.phases[0] + cfg.phases[1]
    assert sum(lo <= r.arrival_s < hi for r in run["requests"]) == 50
    assert doc["arbiter"]["window_s"] == 2.0
    assert json.loads(json.dumps(doc, default=str))["ok"]


def test_arbiter_spike_refuses_a_committed_result(tmp_path):
    with pytest.raises(SystemExit):
        arbiter_spike.main(["--out", "ARBITER_SPIKE.json", "--smoke",
                            "--device", "cpu"])
    with pytest.raises(SystemExit):
        arbiter_spike.main(["--out", "/elsewhere/spike.json"])
