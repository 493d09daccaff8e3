"""``tools.obs_chaos``'s kill scenario on the CPU: the recorder-on dp-2
trainer and a recorded peer, the peer SIGKILLed; the merged timeline
validates with the killed rank's track, the survivor's shrink and its
dump, and provenance-annotated bucket spans (the JAX tool's floors, every
one by name)."""

from __future__ import annotations

from test_torch_chaos_drivers import floors_by_function, no_open_sockets  # noqa: F401
from test_torch_supervision import no_gc_pauses  # noqa: F401

import os

from flextree_tpu_torch.obs.timeline import validate_trace
from flextree_tpu_torch.tools import obs_chaos as oc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_kill_scenario_leaves_a_valid_merged_timeline(monkeypatch, tmp_path,
                                                      no_open_sockets,  # noqa: F811
                                                      no_gc_pauses):  # noqa: F811
    # this process stamps the kill (the freshness floor's clock) and polls
    # the children: no full collection of its heap may stall it there
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res = oc.run_kill_scenario(str(tmp_path), "cpu")
    assert res["ok"], {k: v for k, v in res.items() if k != "timeline"}
    jax_floors = floors_by_function(os.path.join(ROOT, "tools",
                                                 "obs_chaos.py"))
    assert sorted(res["floors"]) == jax_floors["run_kill_scenario"]
    assert validate_trace(res["timeline"]) == []
    c = res["checks"]
    assert [e["alive"] for e in c["epochs"]] == [2, 1]
    assert c["bucket_events"] >= 1 and c["steps_run"] == oc.STEPS
