"""``python -m flextree_tpu_torch.obs fleet`` against ``python -m
flextree_tpu.obs fleet``, the residuals table's drift column, and the
probe-free tool's smoke run on the CPU.

- Obs dirs written from the same events (thin probe records of one
  topology at a few sizes, which alone refuse the α-β fit, and a
  per-step record): both CLIs' ``fleet --json`` give the same runs and
  pools, to rtol 1e-9, and the same text; ``--fit-out`` writes the same
  calibration section (the pooled constants, ``source="feedback"`` and
  ``meta.fleet.samples``); a ``--fingerprint`` that keeps nothing exits 1
  on both.
- ``python -m flextree_tpu_torch.tools.probe_free_feedback --smoke
  --device cpu`` (and the convergence tool, in
  ``test_torch_feedback_tools.py``) refuse the JAX package's committed
  results as ``--out`` or ``--baseline``, and write under ``tmp/``.
"""

from __future__ import annotations

import importlib
import json

import numpy as np
import pytest
import torch

from flextree_tpu.planner import calibrate as j_cal
from flextree_tpu.planner import cost_model as j_cost
from flextree_tpu.planner import feedback as j_fb
from flextree_tpu_torch.obs import __main__ as tcli
from flextree_tpu_torch.tools import probe_free_feedback

jcli = importlib.import_module("flextree_tpu.obs.__main__")

TRUE = dict(ici_bandwidth_GBps=2.0, ici_latency_us=50.0,
            dcn_bandwidth_GBps=2.0, dcn_latency_us=50.0, reduce_bw_GBps=8.0,
            control_us_per_width=0.0, launch_us=400.0)
SKEW = dict(TRUE, launch_us=40.0, ici_latency_us=5.0, dcn_latency_us=5.0)


def _params(d):
    return j_cal._params_from_dict(
        {**j_cal._params_to_dict(j_cost.TpuCostParams()), **d})


def _probe_events(spec, sizes, fp, seed):
    """One thin probe record: ``spec`` at ``sizes``, measured as TRUE with
    seeded noise, predicted as SKEW, each with its breakdown."""
    import dataclasses

    rng = np.random.default_rng(seed)
    out = []
    for i, nb in enumerate(sizes):
        cost = j_fb.predict_spec_cost(spec, 8, nb, _params(SKEW))
        meas = j_fb.predict_spec_us(spec, 8, nb, _params(TRUE)) * \
            float(rng.uniform(0.95, 1.05))
        out.append({
            "ts": 1.0 + i, "rank": 0, "seq": i, "src": "train",
            "kind": "bucket_measured",
            "name": f"ftfb_probe_{spec.replace(',', 'x')}_{nb}B",
            "axis": "ftfb", "topo": {"ftfb": spec}, "world": {"ftfb": 8},
            "nbytes": nb, "codec": "f32", "sharded": False,
            "measured_us": round(meas, 3),
            "predicted_us": round(cost.total_us, 3),
            "predicted": {k: round(v, 3) for k, v in
                          dataclasses.asdict(cost).items()},
            "fingerprint": fp, "step": 1})
    return out


def _dirs(tmp_path):
    """Three thin probe runs of one fingerprint, a fourth of another, and
    a per-step record."""
    specs = [("8", "fp-a"), ("4,2", "fp-a"), ("ring", "fp-a"),
             ("2,2,2", "fp-b")]
    dirs = []
    for i, (spec, fp) in enumerate(specs):
        d = tmp_path / f"run{i}"
        d.mkdir()
        evs = _probe_events(spec, (1 << 14, 1 << 17, 1 << 20), fp, i)
        (d / "flight_00000.jsonl").write_text(
            "\n".join(json.dumps(e) for e in evs) + "\n")
        dirs.append(str(d))
    return dirs


@pytest.fixture()
def same_defaults(tmp_path, monkeypatch):
    """Both packages' ``default_params`` (the fits' base constants) set
    to SKEW through each one's calibration file: the two packages'
    built-in defaults differ (the port's were fitted on an H100)."""
    from flextree_tpu_torch.planner import calibrate as t_cal

    import jax

    jax.devices()
    paths = {}
    for name, cal, fp in (("jax", j_cal, j_cal.backend_fingerprint()),
                          ("port", t_cal, t_cal.backend_fingerprint("cpu"))):
        paths[name] = str(tmp_path / f"{name}_defaults.json")
        cal.save_calibration(paths[name], cal._params_from_dict(
            j_cal._params_to_dict(_params(SKEW))), backend="cpu",
            fingerprint=fp)
    monkeypatch.setenv("FLEXTREE_CALIBRATION_BACKEND", "cpu")

    def use(name):
        monkeypatch.setenv("FLEXTREE_CALIBRATION", paths[name])

    return use


def _run(main, argv, capsys, use=None):
    if use is not None:
        use("port" if main is tcli.main else "jax")
    rc = main(argv)
    return rc, capsys.readouterr().out


def _approx(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (a, b)
        for k in a:
            _approx(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _approx(x, y)
    elif isinstance(a, float):
        assert a == pytest.approx(b, rel=1e-9), (a, b)
    else:
        assert a == b, (a, b)


@pytest.mark.parametrize("extra", [[], ["--fingerprint", "fp-a"],
                                   ["--fingerprint", "fp-none"]],
                         ids=["all", "one_fp", "no_match"])
def test_fleet_json_equals_jax(tmp_path, capsys, extra, same_defaults):
    dirs = _dirs(tmp_path)
    t_rc, t_out = _run(tcli.main, ["--device", "cpu", "fleet", *dirs,
                                   "--json", *extra], capsys, same_defaults)
    j_rc, j_out = _run(jcli.main, ["fleet", *dirs, "--json", *extra],
                       capsys, same_defaults)
    assert t_rc == j_rc
    t, j = json.loads(t_out), json.loads(j_out)
    _approx(t, j)
    if not extra:
        pooled = t["pooled"]["fp-a"]
        assert t_rc == 0 and pooled["runs"] == 3 and pooled["samples"] == 9
        assert all(r["refused"] for r in t["runs"])
        assert pooled["mode"] == "alpha-beta" and pooled["condition"]
    if extra == ["--fingerprint", "fp-none"]:
        assert t_rc == 1 and t["pooled"] == {}


def test_fleet_text_and_fit_out_equal_jax(tmp_path, capsys, same_defaults):
    dirs = _dirs(tmp_path)
    outs = {}
    for name, main, pre in (("port", tcli.main, ["--device", "cpu"]),
                            ("jax", jcli.main, [])):
        path = str(tmp_path / f"{name}_cal.json")
        rc, text = _run(main, [*pre, "fleet", *dirs, "--fit-out", path],
                        capsys, same_defaults)
        assert rc == 0
        with open(path) as f:
            outs[name] = (text.replace(path, "OUT"), json.load(f))
    assert outs["port"][0] == outs["jax"][0]
    (tsec,), (jsec,) = outs["port"][1].values(), outs["jax"][1].values()
    assert list(outs["port"][1]) == list(outs["jax"][1]) == ["cpu"]
    _approx(tsec, jsec)
    assert tsec["source"] == "feedback" and tsec["fingerprint"] == "fp-a"
    assert tsec["meta"]["fleet"]["samples"] == 9
    assert tsec["meta"]["fleet"]["dirs"] == dirs


def test_residuals_table_has_the_drift_column(tmp_path, capsys,
                                              same_defaults):
    dirs = _dirs(tmp_path)
    t = _run(tcli.main, ["--device", "cpu", "residuals", dirs[0]], capsys,
             same_defaults)
    j = _run(jcli.main, ["residuals", dirs[0]], capsys, same_defaults)
    assert t == j and "drift" in t[1].splitlines()[0]


@pytest.mark.parametrize("argv", [
    ["--out", "FEEDBACK.json"], ["--out", "tmp/OBS_ATTRIBUTION.json"],
    ["--out", "BENCH_OVERLAP.json"], ["--out", "results.json"],
    ["--baseline", "FEEDBACK.json"]])
def test_tools_refuse_committed_results(argv, tmp_path, capsys):
    """Both tools refuse the committed JSONs and any path outside
    ``tmp/``, before they touch a device."""
    from flextree_tpu_torch.tools import feedback_convergence

    for mod in (probe_free_feedback, feedback_convergence):
        if argv[0] == "--baseline" and mod is feedback_convergence:
            continue
        with pytest.raises(SystemExit) as e:
            mod.main(["--device", "cpu", "--smoke", *argv])
        assert e.value.code == 2
        assert "--" in capsys.readouterr().err


def test_probe_free_tool_smoke_on_the_cpu(tmp_path, capsys):
    """``--smoke --device cpu``: no probe runs (no ftfb event, no probing
    tick, no feedback error), the per-step spans pair into the timeline,
    the sync-free twin enters no span, and the fleet pools three refusing
    runs into a fit.  Whether the probe-free refit fires within the
    smoke's steps depends on the host's noise (its rotation plans differ
    by a few milliseconds on the CPU); when it does not, its refusals are
    the fitter's and the only violations are the three that follow from
    no refit."""
    torch.set_num_threads(1)
    out = tmp_path / "probe_free.json"
    rc = probe_free_feedback.main(["--device", "cpu", "--smoke", "--out",
                                   str(out)])
    doc = json.loads(out.read_text())
    audit = doc["probe_audit"]
    assert (audit["probe_events"], audit["probing_ticks"],
            audit["feedback_errors"], audit["fold_launches"]) == (0, 0, 0, 0)
    assert audit["per_step_bucket_measured"] and audit["step_measured"]
    assert doc["compute_floor"]["nosync_comm_spans"] == 0
    assert doc["timeline"]["paired_phase_spans"] > 0
    assert not doc["timeline"]["schema_violations"]
    assert doc["fleet"]["pooled_condition"] > 0
    assert doc["fleet"]["single_conditions"] == ["refused"] * 3
    assert doc["feedback_run"]["rotations"] >= 3
    if rc == 0:
        assert doc["refit_calibration"]["mode"] == "probe-free"
        assert doc["refit_calibration"]["phase_scales"]["fixed"] > 0
    else:
        assert doc["feedback_run"]["refits"] == 0 and audit["refusals"]
        assert len(doc["violations"]) == 3
        assert doc["violations"][0].startswith("no probe-free replan")
