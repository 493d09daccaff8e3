"""The port's feedback fitters (``flextree_tpu_torch.planner.feedback``)
against the JAX package's on the same seeded numpy inputs.

Each fit takes the same residual samples (the port's and JAX's
``ResidualSample`` built from one dict) and the same constants (one
``TpuCostParams`` dict on both sides) and must give the same constants to
rtol 1e-9 and the same meta; each ``FeedbackRefused`` fires on the same
starved or degenerate set.  The drift detector gives the same breaches
and summaries, the cache predicate the same matches on the JAX package's
fingerprints (and the port's ``r?`` rule on its own), the probe points
and the spec pricing the same values.  All float64 numpy on the host.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest

from flextree_tpu.obs import stepclock as j_clock
from flextree_tpu.obs import timeline as j_tl
from flextree_tpu.planner import calibrate as j_cal
from flextree_tpu.planner import cost_model as j_cost
from flextree_tpu.planner import feedback as j_fb
from flextree_tpu_torch.obs import stepclock as t_clock
from flextree_tpu_torch.obs import timeline as t_tl
from flextree_tpu_torch.planner import calibrate as t_cal
from flextree_tpu_torch.planner import feedback as t_fb

RTOL = 1e-9
TRUE = dict(ici_bandwidth_GBps=2.0, ici_latency_us=50.0,
            dcn_bandwidth_GBps=2.0, dcn_latency_us=50.0, reduce_bw_GBps=8.0,
            control_us_per_width=0.0, launch_us=400.0)
SKEW = dict(ici_bandwidth_GBps=100.0, ici_latency_us=0.001,
            dcn_bandwidth_GBps=100.0, dcn_latency_us=0.001,
            reduce_bw_GBps=1000.0, control_us_per_width=0.0, launch_us=0.001)
SPECS = ("8", "4,2", "2,2,2", "ring")
SIZES = (1 << 14, 1 << 16, 1 << 18, 1 << 20, 1 << 22)


def params(side, d: dict):
    """The ``TpuCostParams`` of ``d`` in ``side``'s package (``d`` holds
    the schema's keys; the rest take the dataclass defaults of JAX's)."""
    base = j_cal._params_to_dict(j_cost.TpuCostParams())
    cal = j_cal if side == "jax" else t_cal
    return cal._params_from_dict({**base, **d})


def as_dict(p) -> dict:
    return {k: float(v) for k, v in t_cal._params_to_dict(p).items()}


def assert_params_equal(a, b):
    da, db = as_dict(a), as_dict(b)
    assert da.keys() == db.keys()
    for k in da:
        assert da[k] == pytest.approx(db[k], rel=RTOL, abs=0.0), k


def assert_meta_equal(a, b):
    """Equal meta; floats to RTOL."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (a, b)
        for k in a:
            assert_meta_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_meta_equal(x, y)
    elif isinstance(a, float) and not isinstance(b, str):
        assert a == pytest.approx(b, rel=RTOL, abs=1e-12)
    else:
        assert a == b


def breakdown(spec, nbytes, d, n=8, codec=None):
    cost = j_fb.predict_spec_cost(spec, n, nbytes, params("jax", d),
                                  codec=codec)
    return {k: round(v, 6) for k, v in dataclasses.asdict(cost).items()}


def sample_dicts(kind: str, seed: int = 0) -> list[dict]:
    """Seeded residual samples of one scenario, as constructor kwargs."""
    rng = np.random.default_rng(seed)
    out = []

    def add(spec, nb, base, true, *, n=8, codec="f32", source="self",
            noise=0.0, sharded=False, world=8, fingerprint="fp"):
        meas = j_fb.predict_spec_us(spec, n, nb, params("jax", true),
                                    codec=None if codec == "f32" else codec)
        pred = j_fb.predict_spec_us(spec, n, nb, params("jax", base),
                                    codec=None if codec == "f32" else codec)
        if noise:
            meas *= float(rng.uniform(1 - noise, 1 + noise))
        out.append(dict(
            topo=spec, world=world, codec=codec, sharded=sharded, nbytes=nb,
            predicted_us=pred, measured_us=meas, fingerprint=fingerprint,
            source=source,
            predicted_breakdown=breakdown(
                spec, nb, base, n, None if codec == "f32" else codec)))

    if kind in ("clean", "noisy"):
        for spec in SPECS:
            for nb in (1 << 16, 1 << 20):
                for _ in range(2):
                    add(spec, nb, SKEW, TRUE,
                        noise=0.1 if kind == "noisy" else 0.0)
    elif kind == "codec":
        for spec in SPECS:
            for nb in (1 << 16, 1 << 20):
                add(spec, nb, SKEW, TRUE)
        slow = dict(TRUE)
        for spec in ("8", "4,2", "ring"):
            for nb in (1 << 16, 1 << 18, 1 << 20):
                add(spec, nb, SKEW, slow, codec="int8", noise=0.05)
    elif kind == "mixed":
        # every filter of samples_to_points: sharded, lossy, unknown
        # world, lonely, psum, apportioned per-step
        for spec in SPECS:
            for nb in SIZES[:3]:
                add(spec, nb, SKEW, TRUE, noise=0.02)
        add("8", 1 << 16, SKEW, TRUE, sharded=True)
        add("8", 1 << 16, SKEW, TRUE, source="step")
        add("4,2", 1 << 18, SKEW, TRUE, source="step")
        out.append(dict(out[0], world=None))
        out.append(dict(out[0], topo="psum", predicted_breakdown=None))
        out.append(dict(out[0], topo="7+1"))
    elif kind == "one_shape":
        for nb in SIZES + (1 << 12,):
            add("8", nb, TRUE, TRUE)
    elif kind == "starved":
        for spec in ("8", "4,2"):
            add(spec, 1 << 16, SKEW, TRUE)
    elif kind == "one_point":
        for _ in range(10):
            add("8", 1 << 16, SKEW, TRUE, noise=0.05)
    elif kind == "slow_wire":
        slow = dict(TRUE, ici_bandwidth_GBps=0.5, dcn_bandwidth_GBps=0.5,
                    reduce_bw_GBps=2.0)
        for spec in ("8", "4,2"):
            for nb in (1 << 14, 1 << 18, 1 << 22):
                add(spec, nb, TRUE, slow)
    elif kind == "slow_launch":
        for spec in ("8", "4,2"):
            for nb in (1 << 14, 1 << 18, 1 << 22):
                add(spec, nb, TRUE, dict(TRUE, launch_us=2000.0))
    else:
        raise ValueError(kind)
    return out


def samples(side, kind, seed=0):
    cls = j_tl.ResidualSample if side == "jax" else t_tl.ResidualSample
    return [cls(**d) for d in sample_dicts(kind, seed)]


def both(fn_name, *args, **kw):
    """``(jax result or exception, port result or exception)`` of one fit
    called on each side's samples/params (args given as ``side ->
    value`` callables)."""
    got = []
    for side, mod in (("jax", j_fb), ("port", t_fb)):
        a = [x(side) if callable(x) else x for x in args]
        k = {key: (v(side) if callable(v) else v) for key, v in kw.items()}
        try:
            got.append(getattr(mod, fn_name)(*a, **k))
        except (j_fb.FeedbackRefused, t_fb.FeedbackRefused) as e:
            got.append(e)
    return got


def assert_same_outcome(j, t):
    if isinstance(j, Exception):
        assert isinstance(t, t_fb.FeedbackRefused), t
        assert str(t) == str(j)
        return
    assert not isinstance(t, Exception), t
    jp, jm = j
    tp, tm = t
    assert_params_equal(tp, jp)
    assert_meta_equal(tm, jm)


@pytest.mark.parametrize("kind", ["clean", "noisy", "codec", "mixed",
                                  "one_shape", "starved", "one_point"])
def test_fit_from_samples_equals_jax(kind):
    j, t = both("fit_from_samples", lambda s: samples(s, kind),
                base_params=lambda s: params(s, SKEW), min_samples=6,
                compute_samples=[(2e9, 0.010), (2e9, 0.012), (2e9, 0.011)])
    assert_same_outcome(j, t)
    if kind in ("clean", "noisy", "codec"):
        assert not isinstance(t, Exception)


@pytest.mark.parametrize("kind", ["codec", "clean", "one_point"])
def test_refit_codec_equals_jax(kind):
    got = []
    for side, fb in (("jax", j_fb), ("port", t_fb)):
        s = samples(side, kind)
        pts = fb.samples_to_points(s)
        got.append(fb._refit_codec(s, params(side, TRUE), pts))
    assert_same_outcome(*got)


@pytest.mark.parametrize("rates", [[], [(1e9, 0.01)],
                                   [(1e9, 0.01), (3e9, 0.02), (0, 1.0)]])
def test_fit_bwd_gflops_equals_jax(rates):
    assert t_fb.fit_bwd_gflops(rates) == j_fb.fit_bwd_gflops(rates)


def _phase_rows(seed):
    rng = np.random.default_rng(seed)
    rows = []
    for nb in (1 << 12, 1 << 16, 1 << 20, 1 << 22):
        b = breakdown("8", nb, TRUE)
        f = b["latency_us"] + b["control_us"]
        by = b["bandwidth_us"] + b["reduce_us"]
        rows.append((f, by, 0.3 * by, 2.0 * f + 0.5 * by
                     + float(rng.uniform(0, 5)), float(rng.integers(1, 4))))
    return rows


@pytest.mark.parametrize("case", ["varied", "codec_free", "unresolved",
                                  "floor", "one_row", "empty"])
def test_fit_phase_scales_equals_jax(case):
    rows = _phase_rows(1)
    kw = {}
    if case == "codec_free":
        rows = [(f, b, 0.0, m) for f, b, _c, m, _w in rows]
    elif case == "unresolved":
        rows = [(100.0, 1e-9, 0.0, 250.0 + e) for e in (0.0, 1.0, -1.0)]
    elif case == "floor":
        kw = dict(floor_us=3.0)
    elif case == "one_row":
        rows = rows[:1]
    elif case == "empty":
        rows = [(1.0, 1.0, 0.0, 0.0)]
    got = []
    for fb in (j_fb, t_fb):
        try:
            got.append(fb.fit_phase_scales(rows, **kw))
        except (j_fb.FeedbackRefused, t_fb.FeedbackRefused) as e:
            got.append(e)
    j, t = got
    if isinstance(j, Exception):
        assert isinstance(t, t_fb.FeedbackRefused) and str(t) == str(j)
    else:
        assert_meta_equal(t, j)


@pytest.mark.parametrize("scales", [
    {"fixed": 3.0, "bytes": 0.25, "codec": None},
    {"fixed": None, "bytes": 2.0, "codec": 4.0},
    {"fixed": 0.5, "bytes": None, "codec": None}, {}])
def test_scale_params_and_drifted_phase_equal_jax(scales):
    assert_params_equal(t_fb.scale_params(params("port", TRUE), scales),
                        j_fb.scale_params(params("jax", TRUE), scales))
    assert t_fb.drifted_phase(scales) == j_fb.drifted_phase(scales)


@pytest.mark.parametrize("kind", ["slow_wire", "slow_launch", "starved"])
def test_fit_phase_scales_from_residuals_equals_jax(kind):
    j, t = both("fit_phase_scales_from_residuals",
                lambda s: samples(s, kind),
                base_params=lambda s: params(s, TRUE))
    assert_same_outcome(j, t)


def _step_samples(side, floor, plans, noise=0.0):
    """Per-step samples of plans ``{sig: (bucket bytes, buckets)}``
    priced under SKEW and measured as TRUE, ``noise`` seeded jitter."""
    cls = j_clock.StepSample if side == "jax" else t_clock.StepSample
    rng = np.random.default_rng(3)
    out = []
    for sig, (nb, k) in plans.items():
        b, t = breakdown("8", nb, SKEW), breakdown("8", nb, TRUE)
        fixed = (b["latency_us"] + b["control_us"]) * k
        byts = (b["bandwidth_us"] + b["reduce_us"]) * k
        comm = sum(t.values()) * k
        for step in range(3):
            jit = 1.0 + (float(rng.uniform(-noise, noise)) if noise else 0.0)
            out.append(cls(step=step, step_us=(floor + comm) * jit,
                           plan_sig=sig, fixed_us=fixed, bytes_us=byts,
                           codec_us=0.0, predicted_us=fixed + byts))
    return out


PLANS3 = {"A": (1 << 14, 64), "B": (1 << 17, 8), "C": (1 << 20, 1)}


@pytest.mark.parametrize("case", ["intercept", "noisy", "high_floor",
                                  "direct", "single_plan", "no_floor",
                                  "flat_fixed"])
def test_fit_probe_free_equals_jax(case):
    floor, plans, noise, kw = 30_000.0, PLANS3, 0.0, {}
    if case == "noisy":
        noise = 0.02
    elif case == "high_floor":
        kw = dict(compute_floor_us=floor * 1.4)
    elif case == "direct":
        # the byte column varies: plans of different total bytes
        plans = {"A": (1 << 14, 64), "B": (1 << 17, 2), "C": (1 << 20, 4)}
    elif case == "single_plan":
        plans = {"A": (1 << 14, 64)}
    elif case == "no_floor":
        kw = dict(compute_floor_us=None)
    elif case == "flat_fixed":
        plans = {"A": (1 << 17, 8), "B": (1 << 17, 8)}
    kw.setdefault("compute_floor_us", floor)
    j, t = both("fit_probe_free",
                lambda s: _step_samples(s, floor, plans, noise),
                base_params=lambda s: params(s, SKEW), **kw)
    assert_same_outcome(j, t)
    if case in ("intercept", "noisy", "high_floor", "direct"):
        assert not isinstance(t, Exception)


@pytest.mark.parametrize("kind", ["clean", "one_shape", "mixed", "starved"])
def test_fit_residuals_auto_equals_jax(kind):
    j, t = both("fit_residuals_auto", lambda s: samples(s, kind),
                base_params=lambda s: params(s, SKEW))
    assert_same_outcome(j, t)


@pytest.mark.parametrize("kind", ["clean", "slow_wire", "one_shape",
                                  "mixed"])
def test_attribute_groups_equals_jax(kind):
    assert t_fb.attribute_groups(samples("port", kind)) == \
        j_fb.attribute_groups(samples("jax", kind))


def test_samples_to_points_and_families_equal_jax():
    for kind in ("mixed", "codec"):
        j = j_fb.samples_to_points(samples("jax", kind))
        t = t_fb.samples_to_points(samples("port", kind))
        assert [(p.widths, p.num_nodes, p.nbytes, p.measured_us)
                for p in t] == [(p.widths, p.num_nodes, p.nbytes,
                                 p.measured_us) for p in j]
        assert [t_fb.sample_family(s) for s in samples("port", kind)] == \
            [j_fb.sample_family(s) for s in samples("jax", kind)]
    for spec in ("8", "4,2", "2*2*2", "ring", "1", "psum", "", "4,1",
                 "4,2+1"):
        assert t_fb._parse_spec(spec) == j_fb._parse_spec(spec)


@pytest.mark.parametrize("codec", [None, "int8", "bf16"])
def test_predict_spec_cost_equals_jax(codec):
    for spec in ("8", "4,2", "2,2,2", "ring", "7+1", "psum"):
        for nb in (1 << 14, 1 << 20):
            j = j_fb.predict_spec_cost(spec, 8, nb, params("jax", TRUE),
                                       codec=codec)
            t = t_fb.predict_spec_cost(spec, 8, nb, params("port", TRUE),
                                       codec=codec)
            if j is None:
                assert t is None
                continue
            for k, v in dataclasses.asdict(j).items():
                assert getattr(t, k) == pytest.approx(v, rel=RTOL), k


@pytest.mark.parametrize("n,nbytes", [(8, 67_127_296), (8, 1 << 16),
                                      (7, 1 << 20), (2, 1 << 10), (1, 0)])
def test_default_probe_points_equal_jax(n, nbytes):
    assert [dataclasses.astuple(p) for p in
            t_fb.default_probe_points(n, nbytes)] == \
        [dataclasses.astuple(p) for p in
         j_fb.default_probe_points(n, nbytes)]


def test_flagship_probe_points():
    """The flagship's gradient at dp=8: the flat tree, (2,2,2) and the
    ring, each at 4 MiB and 512 KiB."""
    pts = t_fb.default_probe_points(8, 67_127_296)
    assert [(p.spec, p.nbytes) for p in pts] == [
        (s, nb) for s in ("8", "2,2,2", "ring")
        for nb in (4 << 20, 512 << 10)]


def _detector_runs(mod, rels, **kw):
    det = mod.DriftDetector(**kw)
    cls = j_tl.ResidualSample if mod is j_fb else t_tl.ResidualSample
    for i, (rel, topo, codec) in enumerate(rels):
        det.observe(cls(topo=topo, world=8, codec=codec, sharded=False,
                        nbytes=1 << 16, predicted_us=100.0 * (1 + rel),
                        measured_us=100.0, fingerprint="fp"))
    return det


@pytest.mark.parametrize("band,window,min_window", [(0.5, 16, 4),
                                                    (0.2, 4, 2),
                                                    (1.0, 3, 3)])
def test_drift_detector_equals_jax(band, window, min_window):
    rng = np.random.default_rng(int(band * 10))
    rels = [(float(rng.uniform(0, 2)), str(rng.choice(["8", "4,2", "ring",
                                                        "7+1"])),
             str(rng.choice(["f32", "int8"]))) for _ in range(40)]
    kw = dict(band=band, window=window, min_window=min_window)
    j, t = _detector_runs(j_fb, rels, **kw), _detector_runs(t_fb, rels, **kw)
    assert t.breaches() == j.breaches()
    assert t.drifted == j.drifted
    assert t.summary() == j.summary()
    peers = {1: {"fp|8|tree|f32|False": {"median": 2.0, "count": 9}},
             2: {"fp|8|ring|f32|False": {"median": 0.01, "count": 30},
                 "bad": {"median": "x"}}, 3: "not a dict"}
    assert t.pooled_breaches(peers) == j.pooled_breaches(peers)
    assert t.pooled_breaches() == j.pooled_breaches()
    t.reset()
    j.reset()
    assert t.breaches() == j.breaches() == {}
    for bad in (dict(band=0), dict(window=2, min_window=3),
                dict(min_window=0)):
        with pytest.raises(ValueError):
            t_fb.DriftDetector(**bad)
        with pytest.raises(ValueError):
            j_fb.DriftDetector(**bad)


def test_cache_invalidation_predicate_equals_jax():
    """On the JAX package's fingerprint format the port's predicate is
    the JAX one; on the port's, a ``r?`` fingerprint (the process's own)
    matches its backend at every rank count and a known count only
    itself."""
    jfp = "cpu|cpu|n8|jax0.4"
    entries = {
        f"{jfp}|n8|1048576B|float32|f32": {"fingerprint": jfp},
        f"{jfp}|n4|1048576B|float32|f32": {"fingerprint": jfp},
        "other|n8|x": {"fingerprint": "other"},
        "~|n8|x": {"fingerprint": None},
    }
    for fp in (jfp, "other", None):
        for world in (None, 8, 4):
            want = j_fb.cache_invalidation_predicate(fp, world)
            got = t_fb.cache_invalidation_predicate(fp, world)
            assert [got(k, e) for k, e in entries.items()] == \
                [want(k, e) for k, e in entries.items()]
    own = t_cal.backend_fingerprint("cpu")
    r8, r4 = (t_cal.backend_fingerprint("cpu", ranks=r) for r in (8, 4))
    other = own.replace("cpu|cpu", "cuda|card")
    ports = {f"{r8}|n8|x": {"fingerprint": r8},
             f"{r4}|n4|x": {"fingerprint": r4},
             f"{other}|n8|x": {"fingerprint": other}}
    pred = t_fb.cache_invalidation_predicate(own, None)
    assert [pred(k, e) for k, e in ports.items()] == [True, True, False]
    pred = t_fb.cache_invalidation_predicate(own, 8)
    assert [pred(k, e) for k, e in ports.items()] == [True, False, False]
    pred = t_fb.cache_invalidation_predicate(r8, None)
    assert [pred(k, e) for k, e in ports.items()] == [True, False, False]


def test_refusals_are_loud_and_named():
    """Each refusal names what starved it, the same words as JAX's."""
    for kind, match in (("starved", "starved residual set"),
                        ("one_point", "distinct")):
        with pytest.raises(t_fb.FeedbackRefused, match=match):
            t_fb.fit_from_samples(samples("port", kind))
    with pytest.raises(t_fb.FeedbackRefused, match="compute_floor_us"):
        t_fb.fit_probe_free([], compute_floor_us=None)
    assert math.isfinite(t_fb.fit_from_samples(
        samples("port", "clean"), base_params=params("port", SKEW))[0]
        .launch_us)
