"""``tools.coord_chaos`` on the CPU: the coordinator killed at ack-wait
on three host processes (the successor commits the replan at its epoch,
the survivors bitwise the unfaulted twin, a dump with the handshake
phase), and the gloo world's three processes switching to the chunked
twin at one agreed step, each rank bitwise the twin run and its host
copies (the JAX tool's ``tools/coord_chaos.py`` floors).
"""

from __future__ import annotations

import json
import os

from flextree_tpu_torch.tools import coord_chaos


def test_coord_chaos_kill_and_gloo_on_the_cpu(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    results = coord_chaos.run_matrix(("kill_ackwait", "gloo"), "cpu", 4099,
                                     log=lambda m: None)
    for r in results:
        assert r["ok"], json.dumps(r, default=str)[:3000]
    kill, gloo = results
    # the successor completed the replan at its epoch (0), then the group
    # committed the dead coordinator's shrink (1), as the JAX run does
    trail = kill["checks"]["control_trails"][0]
    assert [e for e, _ in trail] == [0, 1]
    assert trail[0][1] == coord_chaos._replan_fingerprint()
    assert kill["checks"]["dump"]["coord_phase"] is not None
    assert gloo["floors"]["host_copies_bitwise"]
    applied = gloo["checks"]["applied"]
    assert len({a[0]["step"] for a in applied}) == 1
    assert coord_chaos.gloo_fold_launches(3, "3", 4099, 1) == 2
    assert coord_chaos.gloo_fold_launches(3, "3", 4098, 2) == 2
    assert not os.environ.get("FT_COORD_ROLE")
