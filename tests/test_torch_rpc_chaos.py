"""``tools.rpc_chaos``'s ``torn`` on the CPU: a real replica process tears
every 3rd response frame; each tear is caught by the CRC, retried and
answered from the idempotency store, and every request completes once on
the generate oracle's tokens (the JAX tool's floors, every one by name)."""

from __future__ import annotations

from test_torch_chaos_drivers import floors_by_function, no_open_sockets  # noqa: F401

import os

from flextree_tpu_torch.tools import rpc_chaos as rc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_torn_frames_are_caught_and_replayed(monkeypatch, no_open_sockets):  # noqa: F811
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    oracle = rc.Oracle("cpu")
    (res,) = rc.run_matrix(["torn"], oracle, log=lambda m: None)
    assert res["ok"], res
    jax_floors = floors_by_function(os.path.join(ROOT, "tools",
                                                 "rpc_chaos.py"))
    assert sorted(res["floors"]) == jax_floors["run_torn_scenario"]
    c = res["checks"]
    assert c["tears_injected"] >= 1 and c["dedup_hits"] >= 1
    assert c["rcs"] == {0: 0}
    # the CPU replica's plain stream launches no kernel
    assert c["launches"]["paged_launches"] == 0
    assert c["launches"]["launches_the_codes"]
