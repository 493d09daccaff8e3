"""``python -m flextree_tpu_torch.tools.feedback_convergence --smoke
--device cpu``: the probe-based loop on 8 CPU ranks, end to end.

The skewed calibration's plan differs from the oracle's; the feedback run
replans from its probes, writes the refit with ``source="feedback"`` and
its sample count, drops the seeded plan-cache entry (the trail
measured, measured, cache), and its flight record pairs residuals into a
valid timeline; with no recorder the armed hook never ticks.  The smoke
waives only the timing floors, so the run must pass.
"""

from __future__ import annotations

import json

import torch

from flextree_tpu_torch.tools import feedback_convergence


def test_convergence_tool_smoke_on_the_cpu(tmp_path):
    torch.set_num_threads(1)
    out = tmp_path / "convergence.json"
    rc = feedback_convergence.main(["--device", "cpu", "--smoke", "--out",
                                    str(out)])
    doc = json.loads(out.read_text())
    assert rc == 0 and doc["ok"] and not doc["violations"], doc["violations"]
    assert doc["feedback_run"]["replans"] >= 1
    assert doc["refit_calibration"]["source"] == "feedback"
    assert doc["refit_calibration"]["samples"] > 0
    assert doc["plan_cache"]["sources"] == ["measured", "measured", "cache"]
    assert doc["plans"]["oracle"] != doc["plans"]["miscalibrated"]
    assert doc["residuals"]["samples"] > 0
    assert doc["timeline"]["comm_measured_spans"] > 0
    assert doc["overhead"]["hook_us_per_step"] > 0
    assert doc["device"]["type"] == "cpu" and doc["smoke"]
