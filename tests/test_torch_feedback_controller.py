"""The port's ``FeedbackController`` against the JAX package's.

Both controllers get the same scripted probe timer and clock, the same
starting constants and the same configuration; ticked on the same steps
they must give the same sequence of outcomes (none, rotation, refit,
refusal), the same refit constants, the same replanned topology, the
same number of invalidated plan-cache entries and the same calibration
file and flight-record events, apart from the fingerprint (each
package's own: JAX's ``cpu|cpu|n8|jax...``, the port's
``cpu|cpu|n1|mesh|r?|torch...``).  Probe mode and probe-free mode.  One
case times the port's default probe timer on a 4-rank CPU mesh.
"""

from __future__ import annotations

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from flextree_tpu.obs import flight_recorder as j_recorder
from flextree_tpu.planner import autotune as j_at
from flextree_tpu.planner import calibrate as j_cal
from flextree_tpu.planner import cost_model as j_cost
from flextree_tpu.planner import feedback as j_fb
from flextree_tpu_torch.obs import flight_recorder as t_recorder
from flextree_tpu_torch.planner import calibrate as t_cal
from flextree_tpu_torch.planner import feedback as t_fb

TRUE = dict(ici_bandwidth_GBps=2.0, ici_latency_us=50.0,
            dcn_bandwidth_GBps=2.0, dcn_latency_us=50.0, reduce_bw_GBps=8.0,
            control_us_per_width=0.0, launch_us=400.0)
SLOW = dict(TRUE, launch_us=4000.0, ici_latency_us=500.0,
            dcn_latency_us=500.0)
SKEW = dict(ici_bandwidth_GBps=100.0, ici_latency_us=0.001,
            dcn_bandwidth_GBps=100.0, dcn_latency_us=0.001,
            reduce_bw_GBps=1000.0, control_us_per_width=0.0, launch_us=0.001)

# the JAX fingerprint names an initialized backend (None before one is):
# initialize it, so both controllers carry a fingerprint from the start
jax.devices()

SIDES = {
    "jax": (j_fb, j_cal, j_recorder),
    "port": (t_fb, t_cal, t_recorder),
}


def params(side, d):
    """``d`` over the JAX dataclass defaults, in ``side``'s package."""
    base = j_cal._params_to_dict(j_cost.TpuCostParams())
    return SIDES[side][1]._params_from_dict({**base, **d})


def as_dict(p):
    return {k: float(v) for k, v in t_cal._params_to_dict(p).items()}


def make(side, tmp, cfg_kw, *, timer, n=8, nbytes=1 << 20):
    fb = SIDES[side][0]
    calls = iter(np.arange(0.0, 1000.0, 0.25))
    kw = dict(params=params(side, SKEW), timer=timer,
              clock=lambda: float(next(calls)))
    if side == "port":
        kw["device"] = "cpu"
    cfg = fb.FeedbackConfig(calibration_path=str(tmp / "CAL.json"),
                            plan_cache_path=str(tmp / "cache.json"),
                            backend="cpu", run_id="parity", **cfg_kw)
    ctl = fb.FeedbackController(n, nbytes, cfg, **kw)
    return ctl


def seed_cache(side, tmp, fingerprint):
    """Two entries of this backend (worlds 8 and 4) and one of another."""
    if side == "port":
        fps = [t_cal.backend_fingerprint("cpu", ranks=r) for r in (8, 4)]
    else:
        fps = [fingerprint, fingerprint]
    entries = {f"{fp}|n{w}|1048576B|float32|f32|serial|replicated":
               {"fingerprint": fp, "widths": [8]}
               for fp, w in zip(fps, (8, 4))}
    entries["other|n8|x"] = {"fingerprint": "other", "widths": [8]}
    doc = {"schema": j_at.PLAN_CACHE_SCHEMA, "entries": entries}
    (tmp / "cache.json").write_text(json.dumps(doc))


def scripted_timer(regimes, side):
    """A probe timer answering with the model's times under the
    constants of ``regimes[tick]`` (the last one thereafter)."""
    fb = SIDES[side][0]
    state = {"tick": 0}

    def timer(probes, n):
        d = regimes[min(state["tick"], len(regimes) - 1)]
        state["tick"] += 1
        return [fb.predict_spec_us(p.spec, n, p.nbytes, params(side, d),
                                   codec=p.codec) * 1e-6 for p in probes]

    return timer


def outcome(dec):
    if dec is None:
        return None
    if dec.rotation:
        return ("rotation", dec.fit_meta["rotation_bucket_bytes"],
                dec.rebuilt)
    return ("refit", dec.plan.to_ft_topo(), dec.invalidated,
            sorted(as_dict(dec.params).items()), dec.rebuilt)


def strip_fp(obj, fps):
    """``obj`` with every fingerprint string replaced by ``FP``."""
    if isinstance(obj, dict):
        return {strip_fp(k, fps): strip_fp(v, fps) for k, v in obj.items()}
    if isinstance(obj, list):
        return [strip_fp(v, fps) for v in obj]
    if isinstance(obj, str):
        for fp in fps:
            obj = obj.replace(fp, "FP")
    return obj


def events(rec, fp):
    drop = ("ts", "seq", "src", "rank")
    return [strip_fp({k: v for k, v in e.items() if k not in drop}, [fp])
            for e in rec.events]


def cal_doc(tmp, fp):
    path = tmp / "CAL.json"
    if not path.exists():
        return None
    doc = json.loads(path.read_text())
    for sec in doc.values():
        assert sec.pop("fingerprint") == fp
    return strip_fp(doc, [fp])


def run_probe_mode(side, tmp, cfg_kw, regimes, steps):
    tmp.mkdir()
    recorder = SIDES[side][2]
    ctl = make(side, tmp, cfg_kw, timer=scripted_timer(regimes, side))
    ctl.cfg.on_replan = lambda plan, p: ("rebuilt", plan.to_ft_topo())
    seed_cache(side, tmp, ctl._fingerprint)
    got = []
    with recorder(None, 0) as rec:
        for step in steps:
            got.append(outcome(ctl.maybe_tick(step)))
    fp = ctl._fingerprint
    left = json.loads((tmp / "cache.json").read_text())["entries"]
    return dict(outcomes=got, ticks=ctl.ticks, refits=ctl.refits,
                refusals=ctl.refusals, params=as_dict(ctl.params),
                samples=len(ctl.samples), cal=cal_doc(tmp, fp),
                events=events(rec, fp), cache_left=sorted(
                    e["fingerprint"] == "other" for e in left.values()))


PROBE_CASES = {
    # tick 1 starved (6 points), tick 2 refits, then quiet
    "refit": (dict(every_k=2, band=0.5, min_window=4, min_samples=8),
              [TRUE], range(1, 13)),
    # a second regime after the first refit: a second refit
    "two_regimes": (dict(every_k=1, band=0.5, min_window=4, min_samples=8),
                    [TRUE, TRUE, TRUE, SLOW], range(1, 10)),
    # the refit budget: one refit, then the hook goes quiet
    "budget": (dict(every_k=1, band=0.5, min_window=4, min_samples=8,
                    max_refits=1), [TRUE, TRUE, SLOW], range(1, 8)),
    # one spec at one size: degenerate, refused every breach
    "degenerate": (dict(every_k=1, band=0.5, min_window=2, min_samples=4,
                        probes=None), [TRUE], range(1, 6)),
    # a healthy host: the skew is the truth, no breach
    "healthy": (dict(every_k=1, band=0.5, min_window=2), [SKEW],
                range(1, 6)),
}


@pytest.mark.parametrize("case", sorted(PROBE_CASES))
def test_probe_mode_equals_jax(case, tmp_path):
    cfg_kw, regimes, steps = PROBE_CASES[case]
    out = {}
    for side in SIDES:
        kw = dict(cfg_kw)
        if "probes" in kw:
            fb = SIDES[side][0]
            kw["probes"] = (fb.ProbePoint("8", 1 << 16),) * 4
        out[side] = run_probe_mode(side, tmp_path / side, kw, regimes, steps)
    j, t = out["jax"], out["port"]
    assert _approx_tree(t["outcomes"], j["outcomes"])
    for key in ("ticks", "refits", "refusals", "samples", "cache_left"):
        assert t[key] == j[key], key
    for k, v in j["params"].items():
        assert t["params"][k] == pytest.approx(v, rel=1e-9), k
    assert _approx_tree(t["cal"], j["cal"])
    assert _approx_tree(t["events"], j["events"])
    if case in ("refit", "two_regimes", "budget"):
        assert t["refits"] >= 1 and t["cal"]["cpu"]["source"] == "feedback"
        first = next(o for o in t["outcomes"] if o)
        assert first[2] == 2  # both entries of this backend dropped
    if case == "degenerate":
        assert t["refusals"] >= 1 and t["refits"] == 0


def _approx_tree(a, b) -> bool:
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (a, b)
        return all(_approx_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (a, b)
        return all(_approx_tree(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, (int, float)):
        assert a == pytest.approx(b, rel=1e-9, abs=1e-9), (a, b)
        return True
    assert a == b, (a, b)
    return True


def _capture(side, nb, k, d):
    fb = SIDES[side][0]
    cost = fb.predict_spec_cost("8", 8, nb, params(side, d))
    b = {key: round(v, 6) for key, v in dataclasses.asdict(cost).items()}
    prov = {"axes": ["dp"], "topo": {"dp": "8"}, "world": {"dp": 8},
            "nbytes": nb, "codec": "f32", "sharded": False, "predicted": b,
            "predicted_us": sum(b.values())}
    return [(f"ft_bucket{i}_dp_{nb}B", dict(prov)) for i in range(k)]


def run_probe_free(side, tmp, *, with_rotate=True, steps=60):
    tmp.mkdir()
    fb, _, recorder = SIDES[side]
    floor, total = 50_000.0, 1 << 20
    rotations = []

    def forbidden(probes, n):
        raise AssertionError("probe timer ran in probe-free mode")

    cfg_kw = dict(every_k=3, band=0.5, window=8, min_window=2,
                  probe_free=True, compute_floor_us=floor,
                  rotation_cycles=1, min_steps_per_plan=2)
    ctl = make(side, tmp, cfg_kw, timer=forbidden, nbytes=total)
    if with_rotate:
        def on_rotate(bb):
            rotations.append(int(bb))
            return ("rotated", int(bb))

        ctl.cfg.on_rotate = on_rotate
    ctl.cfg.on_replan = lambda plan, p: ("replanned", plan.to_ft_topo())
    seed_cache(side, tmp, ctl._fingerprint)
    nb, k = 1 << 14, 64
    got = []
    with recorder(None, 0) as rec:
        ctl.set_step_plan(_capture(side, nb, k, SKEW))
        for step in range(1, steps):
            true_us = floor + k * fb.predict_spec_us("8", 8, nb,
                                                     params(side, TRUE))
            ctl.observe_step(step, true_us * 1e-6)
            dec = ctl.maybe_tick(step)
            got.append(outcome(dec))
            if dec is not None and dec.rotation:
                nb = rotations[-1]
                k = max(1, total // nb)
                ctl.set_step_plan(_capture(side, nb, k, SKEW))
            elif dec is not None:
                break
    fp = ctl._fingerprint
    return dict(outcomes=got, ticks=ctl.ticks, refits=ctl.refits,
                refusals=ctl.refusals, rotations=ctl.rotations,
                params=as_dict(ctl.params), cal=cal_doc(tmp, fp),
                events=events(rec, fp),
                floor=ctl.step_clock.compute_floor_us)


@pytest.mark.parametrize("with_rotate", [True, False],
                         ids=["rotate", "no_hook"])
def test_probe_free_mode_equals_jax(with_rotate, tmp_path):
    out = {side: run_probe_free(side, tmp_path / side,
                                with_rotate=with_rotate) for side in SIDES}
    j, t = out["jax"], out["port"]
    for key in ("ticks", "refits", "refusals", "rotations"):
        assert t[key] == j[key], key
    assert _approx_tree(t["outcomes"], j["outcomes"])
    assert _approx_tree(t["params"], j["params"])
    assert _approx_tree(t["cal"], j["cal"])
    assert _approx_tree(t["events"], j["events"])
    assert t["floor"] == pytest.approx(j["floor"], rel=1e-9)
    if with_rotate:
        assert t["refits"] == 1 and t["rotations"] >= 3
        fit = t["cal"]["cpu"]["meta"]["fit"]
        assert fit["mode"] == "probe-free" and fit["phase_scales"]["fixed"]
        assert not any(e.get("axis") == "ftfb" for e in t["events"])
    else:
        assert t["refusals"] == 1 and t["refits"] == 0


def test_recorder_off_and_refused_coordination(tmp_path):
    """Recorder off: the armed hooks never tick or time.  A controller
    given a coordination handle registers its detector's summary as the
    handle's ack payload, and ``apply_committed`` applies a committed
    replan as the JAX controller does (the coordinated path end to end is
    test_torch_fit_lease.py's)."""
    def exploding(probes, n):
        raise AssertionError("probe timer ran with the recorder off")

    for probe_free in (False, True):
        ctl = t_fb.FeedbackController(
            8, 1 << 20, t_fb.FeedbackConfig(every_k=1, probe_free=probe_free,
                                            compute_floor_us=1.0),
            params=params("port", SKEW), timer=exploding, device="cpu")
        assert not ctl.wants_step_spans()
        ctl.observe_step(1, 0.01)
        assert all(ctl.maybe_tick(s) is None for s in range(1, 30))
        assert ctl.ticks == 0
    from flextree_tpu_torch.runtime import CoordinationHandle

    handle = CoordinationHandle(str(tmp_path), 1, membership=None)
    coord = t_fb.FeedbackController(8, 1, coordination=handle, device="cpu")
    assert coord.coordination is handle
    assert handle.drift_provider() == coord._detector.summary()
    payload = {"params": t_cal._params_to_dict(params("port", SKEW)),
               "topo": "ring", "drift": {"k": 2.0}}
    got = ctl.apply_committed(payload, step=4)
    want = j_fb.FeedbackController(
        8, 1 << 20, j_fb.FeedbackConfig(), params=params("jax", SKEW)
    ).apply_committed(
        {**payload, "params": j_cal._params_to_dict(params("jax", SKEW))},
        step=4)
    assert got.plan.to_ft_topo() == want.plan.to_ft_topo() == "1"
    assert got.drift == want.drift == {"k": 2.0}
    assert ctl.params == params("port", SKEW) and got.rebuilt is None


def test_default_timer_on_a_cpu_mesh(tmp_path):
    """The port's own probe timer: each probe's allreduce on a 4-rank
    CPU mesh, built once and kept across ticks, one input per (n, size)
    shared by the specs probing it; positive times aligned with the
    probes, and the kept probe computes the allreduce."""
    ctl = t_fb.FeedbackController(
        4, 1 << 14, t_fb.FeedbackConfig(repeat=2), device="cpu",
        params=params("port", TRUE))
    probes = ctl.probes
    assert [p.spec for p in probes] == ["4", "4", "2,2", "2,2", "ring",
                                        "ring"]
    secs = ctl._default_timer(probes, 4)
    assert len(secs) == 6 and all(s > 0 for s in secs)
    assert len(ctl._fns) == 6 and len(ctl._inputs) == 2
    fn = ctl._fns[probes[0]]
    assert ctl._default_timer(probes, 4) and ctl._fns[probes[0]] is fn
    rows = ctl._inputs[(4, probes[0].nbytes // 4)]
    want = torch.stack(rows).sum(0)
    for got in fn():
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-5)
