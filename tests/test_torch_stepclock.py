"""The port's per-step span clock (``flextree_tpu_torch.obs.stepclock``)
against the JAX package's (``tests/test_obs.py::TestStepSpanClock``).

``plan_from_capture`` gives the same ``StepPlan``, its signature
included, for the same provenance lists; ``StepSpanClock`` fed the same
plan and the same scripted step times gives the same samples, floors and
``step_measured``/``bucket_measured`` events (the fingerprint pinned on
both sides).  The port's one difference: every eager step hands its plan
in, and a plan of the same signature keeps counting; a plan captured
around a real bucketed sync has the same signature on every step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from flextree_tpu.obs import flight_recorder as j_recorder
from flextree_tpu.obs import stepclock as j_clock
from flextree_tpu_torch.obs import flight_recorder as t_recorder
from flextree_tpu_torch.obs import stepclock as t_clock


def _prov(spec, nbytes, pred_us, *, codec="f32", world=8, sharded=False,
          axis="dp", **extra):
    fixed = 0.3 * pred_us
    return {
        "axes": [axis], "topo": {axis: spec}, "world": {axis: world},
        "nbytes": nbytes, "codec": codec, "sharded": sharded,
        "predicted": {"latency_us": fixed * 0.6, "control_us": fixed * 0.4,
                      "bandwidth_us": 0.5 * pred_us,
                      "reduce_us": 0.15 * pred_us,
                      "codec_us": 0.05 * pred_us},
        "predicted_us": pred_us, **extra,
    }


CAPTURES = {
    "one": [("ft_bucket0_dp_1leaves_4096B", _prov("8", 4096, 40.0))],
    "many": [(f"ft_bucket{i}_dp_3leaves_{nb}B", _prov(s, nb, 10.0 + i))
             for i, (s, nb) in enumerate([("8", 1 << 16), ("4,2", 1 << 18),
                                          ("1", 1 << 10), ("ring", 512)])],
    "skips": [("bare", None), ("err", _prov("8", 64, 1.0,
                                            predicted_error=True)),
              ("no_pred", {"topo": {"dp": "8"}, "nbytes": 8}),
              ("psum", _prov("psum", 64, 1.0)),
              ("ok", _prov("2,2,2", 1 << 12, 7.5, codec="int8",
                           sharded=True, world=None))],
    "two_axes": [("ft_bucket0_dp_sp", {
        **_prov("4", 1 << 14, 20.0), "topo": {"sp": "2", "dp": "4"},
        "world": {"sp": 2, "dp": 4}})],
    "empty": [("bare", None)],
}


@pytest.mark.parametrize("name", sorted(CAPTURES))
def test_plan_from_capture_equals_jax(name):
    j = j_clock.plan_from_capture(CAPTURES[name])
    t = t_clock.plan_from_capture(CAPTURES[name])
    if j is None:
        assert t is None
        return
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.sig == j.sig and len(t.sig) == 12


def _events(rec):
    return [{k: v for k, v in e.items() if k not in ("ts", "seq", "src")}
            for e in rec.events if e["kind"] in ("step_measured",
                                                 "bucket_measured")]


@pytest.mark.parametrize("floor,every", [(None, 1), (2000.0, 1),
                                         (None, 3), (50.0, 2)])
def test_span_clock_equals_jax_under_a_scripted_clock(floor, every):
    rng = np.random.default_rng(7)
    durs = [float(d) for d in rng.uniform(1e-3, 5e-3, 12)]
    out = []
    for clock_mod, recorder in ((j_clock, j_recorder), (t_clock, t_recorder)):
        clock = clock_mod.StepSpanClock(compute_floor_us=floor,
                                        sample_every=every, fingerprint="fp",
                                        max_samples=8)
        with recorder(None, 0) as rec:
            assert clock.observe_step(0, 1.0) is None  # no plan yet
            clock.set_plan(CAPTURES["many"])
            got = [clock.observe_step(i + 1, d) for i, d in enumerate(durs)]
            assert clock.set_plan(CAPTURES["empty"]) is None
        out.append((got, list(clock.samples), clock.floor_us,
                    clock.dropped_first, _events(rec)))
    (jg, js, jf, jd, je), (tg, ts, tf, td, te) = out
    assert [None if s is None else dataclasses.asdict(s) for s in tg] == \
        [None if s is None else dataclasses.asdict(s) for s in jg]
    assert [dataclasses.asdict(s) for s in ts] == \
        [dataclasses.asdict(s) for s in js]
    assert (tf, td) == (jf, jd)
    assert te == je and te


def test_same_signature_keeps_counting():
    """Eager spans: every step's capture is handed in.  The same
    signature keeps the plan's count (one first step dropped, not one a
    step); a new signature starts a plan and drops its first step."""
    clock = t_clock.StepSpanClock(compute_floor_us=100.0)
    kept = []
    for step in range(1, 5):
        kept.append(clock.set_plan(CAPTURES["many"]))
        clock.observe_step(step, 2e-3)
    assert all(p is kept[0] for p in kept)
    assert clock.dropped_first == 1 and len(clock.samples) == 3
    clock.set_plan(CAPTURES["one"])
    assert clock.observe_step(5, 2e-3) is None and clock.dropped_first == 2
    assert clock.observe_step(6, 2e-3).plan_sig == clock.plan.sig


def test_a_real_sync_captures_one_signature_a_step():
    """The bucketed DP sync on 2 CPU ranks under a recorder: each step's
    capture holds every bucket once, in the plan's order, so the
    signature is the same on every step and the clock samples all but
    the first."""
    from flextree_tpu_torch.models import transformer as tt
    from flextree_tpu_torch.parallel import train as ttrain
    from flextree_tpu_torch.parallel.mesh import flat_mesh
    from flextree_tpu_torch.utils.profiling import plan_capture

    cfg = tt.TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                               n_layers=2, d_ff=64)
    tc = ttrain.TrainConfig(bucket_bytes=8192)
    state = ttrain.init_train_state(cfg, torch.Generator().manual_seed(0),
                                    tc, device="cpu")
    step = ttrain.make_train_step(cfg, tc, device="cpu",
                                  comm=flat_mesh(2, "cpu", "dp"))
    rng = np.random.default_rng(0)
    clock = t_clock.StepSpanClock(compute_floor_us=10.0)
    sigs = []
    with t_recorder(None, 0):
        for i in range(3):
            toks = rng.integers(0, 64, (2, 8)).astype(np.int32)
            with plan_capture() as cap:
                state, _ = step(state, toks, toks)
            plan = clock.set_plan(cap)
            sigs.append(plan.sig)
            clock.observe_step(i, 1e-3)
    assert len(set(sigs)) == 1 and len(plan.buckets) > 1
    assert len(cap) == len(plan.buckets)
    assert clock.dropped_first == 1 and len(clock.samples) == 2
