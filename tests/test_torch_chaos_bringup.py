"""``tools.chaos_bringup``'s ``degrade`` on the CPU: 4 processes
configured, process 3 never joins, the launcher reports 3 survivors and
``init_distributed_or_degrade`` forms their world over gloo with the
replanned topology; each rank's tree and ring allreduce bitwise the same
allreduce of its host copies (the JAX tool's ``degrade`` floors)."""

from __future__ import annotations

from test_torch_chaos_drivers import no_open_sockets  # noqa: F401

from flextree_tpu.planner import replan_for_survivors as j_replan
from flextree_tpu_torch.tools import chaos_bringup as cb


def test_degrade_forms_the_survivors_world(monkeypatch, no_open_sockets):  # noqa: F811
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    (res,) = cb.run_matrix(("degrade",), "cpu", 4099, log=lambda m: None)
    assert res["ok"], res
    assert res["returncodes"] == [0, 0, 0]
    want = j_replan(cb.SURVIVORS, cb.PLAN_BYTES,
                    configured=cb.NUM_PROCESSES).to_ft_topo()
    assert res["replanned_topo"] == want
    for r in res["reports"]:
        assert r["degraded_to"] == r["world"] == 3 and r["attempts"] == 1
        assert r["topo"] == want
        assert any("DEGRADED WORLD: 3/4" in a for a in r["advisory"])
        assert [c["topo"] for c in r["checks"]] == [want, "1"]
        assert all(c["host_copies_bitwise"] and c["analytic"]
                   for c in r["checks"])
