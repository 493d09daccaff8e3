"""``tools.serve_elastic_chaos``'s ``drain_race`` on the CPU: a revoke
published while the revoked replica holds in-flight requests; the ack
before the drain raises ``ProtocolViolation`` and writes nothing, the
drain-then-ack completes, and every request finishes once on the
generate oracle's tokens (the JAX tool's floors, every one by name)."""

from __future__ import annotations

from test_torch_chaos_drivers import floors_by_function, no_open_sockets  # noqa: F401

import os

from flextree_tpu_torch.tools import rpc_chaos as rc
from flextree_tpu_torch.tools import serve_elastic_chaos as se

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_drain_race_refuses_the_early_ack(monkeypatch, no_open_sockets):  # noqa: F811
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    (res,) = se.run_matrix(["drain_race"], rc.Oracle("cpu"),
                           log=lambda m: None)
    assert res["ok"], res
    jax_floors = floors_by_function(os.path.join(ROOT, "tools",
                                                 "serve_elastic_chaos.py"))
    assert sorted(res["floors"]) == jax_floors["run_drain_race_scenario"]
    c = res["checks"]
    assert "still in flight" in c["violation"]
    assert c["acked_epoch_after_refusal"] == 1
    assert c["acked_epoch_after_drain"] == 2
