"""``tools.chaos_runtime``'s ``sigterm`` on the CPU: a supervised training
process is SIGTERMed mid-run, checkpoints within one step and exits 0; a
relaunch resumes from exactly that step and completes (the JAX tool's
``sigterm`` floors)."""

from __future__ import annotations

from test_torch_chaos_drivers import no_open_sockets  # noqa: F401

from flextree_tpu_torch.tools import chaos_runtime as cr


def test_sigterm_checkpoints_within_a_step_and_resumes(monkeypatch,
                                                       no_open_sockets):  # noqa: F811
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    (res,) = cr.run_matrix(("sigterm",), "cpu", log=lambda m: None)
    assert res["recovered"], res
    c = res["checks"]
    assert c["ckpt_steps"] == [c["preempted_at"]]
    assert c["resumed_from"] == c["preempted_at"]
    assert c["resume_final_step"] == 50
    assert 0 <= c["preempted_at"] - c["term_at_trainer_step"] <= 4
