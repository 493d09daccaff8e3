"""The port's calibration (``flextree_tpu_torch.planner.calibrate`` and
``python -m flextree_tpu_torch.tools.calibrate_host``) against the JAX
package's: the fit on one synthetic point set gives JAX's constants
within rtol 1e-12 (and refuses the same degenerate set); a file written
by either package's ``save_calibration`` is read by the other's
``load_calibration`` under the matching fingerprint and is a miss, logged,
under another; ``measure_points`` and the tool run on a 4-rank CPU mesh."""

import dataclasses
import json
import logging

import numpy as np
import pytest
import torch

from flextree_tpu.planner import calibrate as j_cal
from flextree_tpu.planner import cost_model as j_cost
from flextree_tpu_torch.planner import calibrate as cal
from flextree_tpu_torch.planner import cost_model
from flextree_tpu_torch.tools import calibrate_host

WIDTHS = ((8,), (4, 2), (2, 4), (2, 2, 2), (1,))
SIZES = (1 << 16, 1 << 18, 1 << 20)


def synthetic(mod, seed=0):
    """Points priced by one set of constants, with 5% seeded noise."""
    rng = np.random.default_rng(seed)
    true = cost_model.TpuCostParams(
        ici=cost_model.LinkParams(2.0, 50.0),
        dcn=cost_model.LinkParams(2.0, 50.0), reduce_bw_GBps=8.0,
        control_us_per_width=0.0, launch_us=120.0)
    points = []
    for nbytes in SIZES:
        for widths in WIDTHS:
            us = cal.predict_us(true, widths, 8, nbytes)
            sample = tuple(us * (1 + 0.05 * rng.standard_normal(6)))
            points.append(mod.MeasuredPoint(widths, 8, nbytes,
                                            float(np.median(sample)), sample))
    return points


def as_dict(params):
    return {k: float(v) for k, v in cal._params_to_dict(params).items()}


@pytest.mark.parametrize("relative", (True, False))
def test_fit_equals_jax(relative):
    ours = cal.fit_cost_params(synthetic(cal), relative=relative)
    theirs = j_cal.fit_cost_params(synthetic(j_cal), relative=relative)
    a, b = as_dict(ours), as_dict(theirs)
    for key in ("ici_bandwidth_GBps", "ici_latency_us", "reduce_bw_GBps",
                "launch_us", "control_us_per_width"):
        assert a[key] == pytest.approx(b[key], rel=1e-12, abs=0.0), key
    points = synthetic(cal)
    assert [p.noise_us for p in points] == [p.noise_us
                                            for p in synthetic(j_cal)]
    for p in points[:5]:
        assert np.array_equal(cal.feature_vector(p.widths, 8, p.nbytes),
                              j_cal.feature_vector(p.widths, 8, p.nbytes))
    measured = [p.measured_us for p in points]
    predicted = [cal.predict_us(ours, p.widths, 8, p.nbytes) for p in points]
    assert cal.spearman(predicted, measured) == \
        j_cal.spearman(predicted, measured)


def test_too_few_points_and_a_degenerate_fit_are_refused():
    for mod in (cal, j_cal):
        with pytest.raises(ValueError):
            mod.fit_cost_params(synthetic(mod)[:3])
    # a broken timer's negative times: every coefficient negative
    for mod in (cal, j_cal):
        pts = [mod.MeasuredPoint(w, 8, nb, -5.0) for nb in (1 << 10, 1 << 20)
               for w in ((8,), (4, 2), (1,))]
        with pytest.raises(RuntimeError, match="degenerate"):
            mod.fit_cost_params(pts, relative=False)


def port_params():
    return cost_model.TpuCostParams(
        ici=cost_model.LinkParams(176.0, 9.0),
        dcn=cost_model.LinkParams(12.0, 30.0), reduce_bw_GBps=350.0,
        control_us_per_width=0.1, launch_us=2.5, codec_bw_GBps=300.0,
        bwd_GFLOPs=1e5, rs_bw_scale=0.9, ag_bw_scale=1.1)


def test_files_cross_read_under_a_matching_fingerprint(tmp_path):
    path = tmp_path / "cal.json"
    fp = "cuda|NVIDIA H100 80GB HBM3|n1|mesh|r8|torch2.11.0+cu128"
    ours = port_params()
    cal.save_calibration(path, ours, backend="cuda", fingerprint=fp,
                         meta={"note": "port"})
    theirs = j_cal.load_calibration(path, backend="cuda", fingerprint=fp)
    assert dataclasses.asdict(theirs) == dataclasses.asdict(ours)
    jfp = "cpu|cpu|n8|jax0.9.0"
    j_cal.save_calibration(path, j_cost.TpuCostParams(), backend="cpu",
                           fingerprint=jfp)
    back = cal.load_calibration(path, backend="cpu", fingerprint=jfp)
    assert dataclasses.asdict(back) == dataclasses.asdict(
        j_cost.TpuCostParams())
    doc = json.loads(path.read_text())
    assert set(doc) == {"cuda", "cpu"}
    assert doc["cuda"]["schema"] == cal.CALIBRATION_SCHEMA == \
        j_cal.CALIBRATION_SCHEMA
    # a mismatched fingerprint is a miss both ways, and it is logged
    records = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = records.append
    logger = logging.getLogger("flextree.planner")
    logger.addHandler(handler)
    try:
        assert cal.load_calibration(path, backend="cpu") is None
        assert cal.load_calibration(path, backend="cuda",
                                    fingerprint=fp.replace("r8", "r4")) is None
    finally:
        logger.removeHandler(handler)
    assert sum("ignoring it" in r.getMessage() for r in records) == 2
    assert j_cal.load_calibration(path, backend="cuda",
                                  fingerprint=jfp) is None


def test_the_fingerprint_names_the_backend_and_defaults_load_only_on_it(
        tmp_path, monkeypatch):
    fp = cal.backend_fingerprint("cpu", ranks=8)
    assert fp == f"cpu|cpu|n1|mesh|r8|torch{torch.__version__}"
    if not torch.cuda.is_available():
        assert not torch.cuda.is_initialized()
    assert cal.backend_fingerprint().startswith("cpu|cpu|n1|mesh|r?|")
    path = tmp_path / "cal.json"
    monkeypatch.delenv("FLEXTREE_CALIBRATION", raising=False)
    monkeypatch.delenv("FLEXTREE_CALIBRATION_BACKEND", raising=False)
    assert cal.default_params() == cost_model.TpuCostParams()
    cal.save_calibration(path, port_params(), backend="cpu",
                         fingerprint=cal.backend_fingerprint())
    monkeypatch.setenv("FLEXTREE_CALIBRATION", str(path))
    assert cal.default_params() == cost_model.TpuCostParams()  # no backend
    monkeypatch.setenv("FLEXTREE_CALIBRATION_BACKEND", "cpu")
    assert cal.default_params() == port_params()
    cal.save_calibration(path, port_params(), backend="cpu", fingerprint=fp)
    assert cal.default_params() == cost_model.TpuCostParams()  # r8 != r?


def test_measure_points_on_a_cpu_mesh():
    points = cal.measure_points(["4", "2,2", "1"], [64, 256], repeat=3,
                                devices=4, device="cpu")
    assert [(p.widths, p.num_nodes, p.nbytes) for p in points] == [
        (w, 4, 4 * s) for s in (64, 256) for w in ((4,), (2, 2), (1,))]
    assert all(len(p.times_us) == 3 and p.measured_us > 0 for p in points)
    with pytest.raises(ValueError):
        cal.measure_points(["4"], [64], devices=4, device="cpu", stat="mean")


def test_the_calibration_tool_writes_a_section_the_planner_reads(
        tmp_path, monkeypatch):
    path = tmp_path / "cal.json"
    res = calibrate_host.calibrate(str(path), device="cpu", ranks=4,
                                   topos=("4", "2,2", "1"),
                                   sizes=(64, 256, 1024), repeat=3)
    json.dumps(res)
    assert res["backend"] == "cpu" and not res["device_time"]
    assert len(res["points"]) == 9 and -1 <= res["spearman"] <= 1
    fp = cal.backend_fingerprint("cpu", ranks=4)
    assert res["fingerprint"] == fp
    params = cal.load_calibration(path, backend="cpu", fingerprint=fp)
    assert as_dict(params) == {k: float(v) for k, v in res["params"].items()}
    monkeypatch.delenv("FLEXTREE_CALIBRATION", raising=False)
    with pytest.raises(SystemExit):  # names no file to write
        calibrate_host.main(["--device", "cpu"])
