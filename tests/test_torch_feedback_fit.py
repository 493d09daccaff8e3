"""``fit(supervision=Supervision(feedback=...))`` and ``trainer
--feedback-*`` of the port, on the CPU, against the JAX package's.

- The dense step at dp=2 from one converted state, the JAX ``fit`` and
  the port's each armed with a controller whose scripted probe timer
  answers with another host's times: both refit and replan once at the
  first tick, their rebuilt steps run the rest, and the final states
  agree within the DP tests' tolerances
  (``test_torch_train_dp.py::test_three_dp_train_steps_match_jax``).
- The step after the replan syncs under the refit plan: the buckets
  ``plan_capture`` reads from it are the ones a step built fresh under
  the refit calibration syncs, and not the skewed plan's (with
  ``--overlap`` the step keeps its readiness plan in its cache, so a
  replan that left the old step running would keep the old buckets).
- A raising tick records ``feedback_error`` and the run goes on; with
  the recorder off the probe timer is never called.
- ``trainer.main --feedback-every`` on a skewed calibration leaves
  ``FLEXTREE_CALIBRATION``, ``FLEXTREE_CALIBRATION_BACKEND`` and the
  host's file as they were; a (2, 2, 1) mesh run arms and ticks.
"""

from __future__ import annotations

import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flextree_tpu.obs import flight_recorder as j_recorder
from flextree_tpu.parallel import loop as jloop
from flextree_tpu.planner import calibrate as j_cal
from flextree_tpu.planner import cost_model as j_cost
from flextree_tpu.planner import feedback as j_fb
from flextree_tpu_torch import trainer
from flextree_tpu_torch.convert import (
    train_state_from_numpy,
    train_state_to_numpy,
)
from flextree_tpu_torch.models import transformer as tt
from flextree_tpu_torch.obs import flight_recorder as t_recorder
from flextree_tpu_torch.parallel import loop as tloop
from flextree_tpu_torch.parallel import train as ttrain
from flextree_tpu_torch.parallel.mesh import flat_mesh
from flextree_tpu_torch.planner import calibrate as t_cal
from flextree_tpu_torch.planner import feedback as t_fb
from flextree_tpu_torch.planner.choose import choose_topology
from flextree_tpu_torch.utils.profiling import plan_capture

jt = importlib.import_module("flextree_tpu.models.transformer")
jtrain = importlib.import_module("flextree_tpu.parallel.train")

DIMS = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
LR = 1e-3
STEPS = 4
TRUE = dict(ici_bandwidth_GBps=2.0, ici_latency_us=50.0,
            dcn_bandwidth_GBps=2.0, dcn_latency_us=50.0, reduce_bw_GBps=8.0,
            control_us_per_width=0.0, launch_us=400.0)
# near-free fixed costs and a starved wire: the planner's bucket argmin
# runs to tiny buckets
SKEW = dict(ici_bandwidth_GBps=0.01, ici_latency_us=0.001,
            dcn_bandwidth_GBps=0.01, dcn_latency_us=0.001,
            reduce_bw_GBps=0.05, control_us_per_width=0.0, launch_us=0.001)


def params(cal, d):
    return cal._params_from_dict(
        {**j_cal._params_to_dict(j_cost.TpuCostParams()), **d})


class _Batches:
    def batch_at(self, step):
        rng = np.random.default_rng(100 + step)
        toks = rng.integers(0, DIMS["vocab_size"], (4, 16)).astype(np.int32)
        tgts = rng.integers(0, DIMS["vocab_size"], (4, 16)).astype(np.int32)
        return toks, tgts


def _true_timer(fb, cal):
    def timer(probes, n):
        return [fb.predict_spec_us(p.spec, n, p.nbytes, params(cal, TRUE),
                                   codec=p.codec) * 1e-6 for p in probes]
    return timer


def _skewed(path, cal, fingerprint):
    cal.save_calibration(path, params(cal, SKEW), backend="cpu",
                         fingerprint=fingerprint, source="measured")


def _fb_config(fb, tmp, on_replan):
    return fb.FeedbackConfig(every_k=2, band=0.5, min_window=4,
                             min_samples=6, backend="cpu",
                             calibration_path=str(tmp),
                             plan_cache_path=str(tmp) + ".plans",
                             on_replan=on_replan, run_id="fit-parity")


@pytest.fixture()
def cal_env(monkeypatch):
    monkeypatch.setenv("FLEXTREE_CALIBRATION_BACKEND", "cpu")

    def point(path):
        monkeypatch.setenv("FLEXTREE_CALIBRATION", str(path))

    return point


def test_dp2_fit_replans_like_jax(tmp_path, cal_env):
    """One refit and one replan at the first tick on both sides, the
    rebuilt steps' buckets the refit plan's, the final states within the
    DP tests' tolerances."""
    jax.devices()
    data = _Batches()
    jstate0 = jax.tree.map(np.array, jtrain.init_train_state(
        jax.random.PRNGKey(0), jt.TransformerConfig(**DIMS)))
    kw = dict(lr=LR)
    # -- JAX
    jpath = tmp_path / "jax_cal.json"
    _skewed(jpath, j_cal, j_cal.backend_fingerprint())
    cal_env(jpath)
    mesh = jtrain.make_mesh_3d(2, (2, 1, 1))
    jcfg = jt.TransformerConfig(**DIMS)
    specs = jtrain.state_specs(jcfg, "tp", jtrain.TrainConfig(**kw),
                               mesh=mesh, axis_names=("dp", "sp", "tp"))

    def j_replan(plan, p):
        return (jtrain.make_train_step(mesh, jcfg, jtrain.TrainConfig(**kw)),
                mesh, specs)

    jctl = j_fb.FeedbackController(
        8, 1 << 20, _fb_config(j_fb, jpath, j_replan),
        params=params(j_cal, SKEW), timer=_true_timer(j_fb, j_cal))
    with j_recorder(None, 0):
        jres = jloop.fit(
            jax.tree.map(jnp.asarray, jstate0),
            jtrain.make_train_step(mesh, jcfg, jtrain.TrainConfig(**kw)),
            data, jloop.FitConfig(num_steps=STEPS, log_every=1, prefetch=0),
            mesh=mesh, state_specs=specs,
            supervision=jloop.Supervision(feedback=jctl))
    # -- the port
    tpath = tmp_path / "port_cal.json"
    _skewed(tpath, t_cal, t_cal.backend_fingerprint("cpu"))
    cal_env(tpath)
    tcfg = tt.TransformerConfig(**DIMS)
    comm = flat_mesh(2, "cpu", "dp")
    rebuilt = []

    def t_replan(plan, p):
        step = ttrain.make_train_step(tcfg, ttrain.TrainConfig(**kw),
                                      device="cpu", comm=comm)

        def captured(state, tokens, targets):
            with plan_capture() as cap:
                out = step(state, tokens, targets)
            rebuilt.append([prov["nbytes"] for _, prov in cap])
            return out

        return captured, comm, None

    tctl = t_fb.FeedbackController(
        8, 1 << 20, _fb_config(t_fb, tpath, t_replan),
        params=params(t_cal, SKEW), timer=_true_timer(t_fb, t_cal),
        device="cpu")
    with t_recorder(None, 0) as rec:
        tres = tloop.fit(
            train_state_from_numpy(jstate0, device="cpu"),
            ttrain.make_train_step(tcfg, ttrain.TrainConfig(**kw),
                                   device="cpu", comm=comm),
            data, tloop.FitConfig(num_steps=STEPS, log_every=1, prefetch=0),
            supervision=tloop.Supervision(feedback=tctl))
    jrep, trep = jres.report, tres.report
    assert (trep.feedback_refits, trep.feedback_replans,
            trep.feedback_refusals) == (jrep.feedback_refits,
                                        jrep.feedback_replans,
                                        jrep.feedback_refusals) == (1, 1, 0)
    assert tres.report.metrics["counters"]["train.feedback_replans"] == 1
    (ev,) = [e for e in rec.events if e["kind"] == "feedback_replan"]
    assert ev["swapped"] and ev["step"] == 2
    assert choose_topology(8, 1 << 20, params=tctl.params).to_ft_topo() \
        == ev["topo"]
    for k, v in j_cal._params_to_dict(jctl.params).items():
        assert t_cal._params_to_dict(tctl.params)[k] == \
            pytest.approx(v, rel=1e-9), k
    # the two rebuilt steps synced the refit plan's buckets
    refit = t_cal.load_calibration(tpath, backend="cpu")
    assert refit == tctl.params
    want = _bucket_bytes(tcfg, comm, refit)
    assert rebuilt == [want, want] and want != _bucket_bytes(
        tcfg, comm, params(t_cal, SKEW))
    # losses and parameters as the DP tests hold them
    for (js, jl), (ts, tl) in zip(jres.losses, tres.losses):
        assert js == ts and tl == pytest.approx(jl, rel=1e-5)
    want_state = jax.tree.map(np.array, jres.state)
    got = train_state_to_numpy(tres.state)
    assert int(got["step"]) == int(want_state["step"]) == STEPS
    g1 = _jax_grads(jstate0["params"], *data.batch_at(0))
    for a, b, g in zip(jax.tree.leaves(want_state["params"]),
                       jax.tree.leaves(got["params"]),
                       jax.tree.leaves(g1)):
        tiny = np.abs(g) < 1e-7
        np.testing.assert_allclose(b[~tiny], a[~tiny], atol=1e-5)
        np.testing.assert_allclose(b[tiny], a[tiny], atol=2 * LR * STEPS)


def _jax_grads(params_np, tokens, targets):
    cfg = jt.TransformerConfig(**DIMS)

    def loss(p):
        total, _ = jt.cross_entropy_loss(jt.forward(p, tokens, cfg), targets)
        return total / tokens.size

    return jax.tree.map(np.array,
                        jax.grad(loss)(jax.tree.map(jnp.asarray, params_np)))


def _bucket_bytes(cfg, comm, cost_params):
    """The bytes of each bucket the dp=2 sync plans under
    ``cost_params``."""
    from flextree_tpu_torch.parallel import bucketing as bk

    p = tt.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    leaves = ttrain.tree_leaves(p)
    specs = bk.spec_leaves(p, tt.param_specs(cfg))
    topos = ttrain.resolve_axis_topos(comm, ttrain.AXIS_NAMES, None)
    return [b.nbytes for b in bk.plan_buckets(
        leaves, specs, ttrain.AXIS_NAMES, topos=topos,
        axis_sizes=bk.comm_axis_sizes(comm, ttrain.AXIS_NAMES),
        params=cost_params)]


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["serial", "overlap"])
def test_the_step_after_a_replan_syncs_the_refit_plan(tmp_path, cal_env,
                                                      overlap):
    """Steps before the replan sync the skewed plan's buckets, every step
    after it the refit plan's: those of a step built fresh under the
    refit calibration on the same batch.  With ``overlap`` the step
    keeps its readiness plan in its cache, so this fails if the replan
    leaves the old step (and its cache) running."""
    path = tmp_path / "cal.json"
    _skewed(path, t_cal, t_cal.backend_fingerprint("cpu"))
    cal_env(path)
    cfg = tt.TransformerConfig(**DIMS)
    comm = flat_mesh(2, "cpu", "dp")
    tc = ttrain.TrainConfig(lr=LR, overlap=overlap)
    state = ttrain.init_train_state(cfg, torch.Generator().manual_seed(0),
                                    tc, device="cpu")
    seen = []

    def build():
        step = ttrain.make_train_step(cfg, tc, device="cpu", comm=comm)

        def captured(st, tokens, targets):
            with plan_capture() as cap:
                out = step(st, tokens, targets)
            seen.append([(prov["nbytes"], prov["fired"])
                         for _, prov in cap])
            return out

        return captured

    ctl = t_fb.FeedbackController(
        8, 1 << 20,
        _fb_config(t_fb, path, lambda plan, p: (build(), comm, None)),
        params=params(t_cal, SKEW), timer=_true_timer(t_fb, t_cal),
        device="cpu")
    with t_recorder(None, 0):
        res = tloop.fit(state, build(), _Batches(),
                        tloop.FitConfig(num_steps=STEPS, log_every=0,
                                        prefetch=0),
                        supervision=tloop.Supervision(feedback=ctl))
        assert res.report.feedback_replans == 1
        fresh = build()
        fresh(state, *_Batches().batch_at(0))
    refit_plan = seen.pop()
    assert seen[0] == seen[1] != refit_plan
    assert seen[2] == seen[3] == refit_plan


class _Toy:
    def batch_at(self, step):
        t = np.full((2, 4), float(step + 1))
        return t, t


def _toy_step(state, tokens, targets):
    s = int(state["step"])
    return ({"step": torch.tensor(s + 1), "w": state["w"] - 0.01},
            {"loss": torch.tensor(0.5)})


def _toy_state():
    return {"step": torch.tensor(0), "w": torch.zeros(2)}


def test_a_raising_tick_disarms_feedback_and_the_run_goes_on(tmp_path):
    """As the JAX ``test_fit_survives_raising_tick``: one
    ``feedback_error`` at the first tick, no later tick, every step
    run."""
    def exploding(probes, n):
        raise OSError("probe wire fell off")

    ctl = t_fb.FeedbackController(
        8, 1 << 20, t_fb.FeedbackConfig(
            every_k=2, plan_cache_path=str(tmp_path / "plans.json")),
        params=params(t_cal, SKEW), timer=exploding, device="cpu")
    with t_recorder(None, 0) as rec:
        res = tloop.fit(_toy_state(), _toy_step, _Toy(),
                        tloop.FitConfig(num_steps=8, log_every=0,
                                        prefetch=0),
                        supervision=tloop.Supervision(feedback=ctl))
    assert int(res.state["step"]) == 8 and res.report.feedback_refits == 0
    errors = [e for e in rec.events if e["kind"] == "feedback_error"]
    assert len(errors) == 1 and errors[0]["step"] == 2
    assert "probe wire fell off" in errors[0]["reason"]
    assert ctl.ticks == 1


def test_a_raising_span_clock_disarms_feedback(tmp_path):
    """The probe-free hooks: a span clock that raises records
    ``feedback_error`` once and the run goes on."""
    ctl = t_fb.FeedbackController(
        8, 1 << 20, t_fb.FeedbackConfig(every_k=2, probe_free=True,
                                        compute_floor_us=1.0),
        params=params(t_cal, SKEW), device="cpu")

    def broken(step, dur):
        raise ValueError("clock broke")

    ctl.observe_step = broken
    with t_recorder(None, 0) as rec:
        res = tloop.fit(_toy_state(), _toy_step, _Toy(),
                        tloop.FitConfig(num_steps=5, log_every=0,
                                        prefetch=0),
                        supervision=tloop.Supervision(feedback=ctl))
    assert int(res.state["step"]) == 5
    errors = [e for e in rec.events if e["kind"] == "feedback_error"]
    assert len(errors) == 1 and errors[0]["step"] == 0
    assert ctl.ticks == 0


@pytest.mark.parametrize("probe_free", [False, True])
def test_recorder_off_never_calls_the_timer(probe_free):
    """No recorder: the armed hooks tick nothing and time nothing; the
    run equals the unarmed one."""
    def exploding(probes, n):
        raise AssertionError("probe timer ran with the recorder off")

    ctl = t_fb.FeedbackController(
        8, 1 << 20, t_fb.FeedbackConfig(every_k=1, probe_free=probe_free,
                                        compute_floor_us=1.0),
        params=params(t_cal, SKEW), timer=exploding, device="cpu")
    cfg = tloop.FitConfig(num_steps=6, log_every=0, prefetch=0)
    res = tloop.fit(_toy_state(), _toy_step, _Toy(), cfg,
                    supervision=tloop.Supervision(feedback=ctl))
    plain = tloop.fit(_toy_state(), _toy_step, _Toy(), cfg)
    assert ctl.ticks == 0 and torch.equal(res.state["w"], plain.state["w"])
    assert (res.report.feedback_refits, res.report.feedback_replans) == (0, 0)
    assert probe_free is False or len(ctl.step_clock.samples) == 0


_SMALL = ["--cpu", "--vocab", "64", "--d-model", "32", "--n-heads", "4",
          "--n-layers", "2", "--d-ff", "64", "--batch", "4", "--seq-len",
          "16", "--corpus-tokens", "4000", "--log-every", "0"]


def test_trainer_feedback_leaves_the_host_calibration(tmp_path,
                                                      monkeypatch):
    """``--feedback-every 2`` from a skewed host calibration, with and
    without ``--obs-dir``: the run ticks, refits go to the run-local copy,
    and the host's file and both variables are as they were."""
    host = tmp_path / "CALIBRATION.json"
    _skewed(host, t_cal, t_cal.backend_fingerprint("cpu"))
    before = host.read_bytes()
    monkeypatch.setenv("FLEXTREE_CALIBRATION", str(host))
    monkeypatch.delenv("FLEXTREE_CALIBRATION_BACKEND", raising=False)
    monkeypatch.setenv("FLEXTREE_PLAN_CACHE", str(tmp_path / "plans.json"))
    obs = tmp_path / "obs"
    out: dict = {}
    assert trainer.main(_SMALL + ["--mesh", "2,1,1", "--steps", "5",
                                  "--feedback-every", "2", "--obs-dir",
                                  str(obs)], out=out) == 0
    assert host.read_bytes() == before
    assert os.environ["FLEXTREE_CALIBRATION"] == str(host)
    assert "FLEXTREE_CALIBRATION_BACKEND" not in os.environ
    local = obs / "CALIBRATION.feedback.json"
    doc = json.loads(local.read_text())
    assert doc["cpu"]["source"] in ("measured", "feedback")
    events = [json.loads(ln) for ln in
              (obs / "flight_00000.jsonl").read_text().splitlines()]
    assert sum(e["kind"] == "feedback_tick" for e in events) == 2
    assert out["result"].report.metrics["counters"][
        "train.feedback_refusals"] == out["result"].report.feedback_refusals
    # no obs dir: the recorder is off, the hook a None check, and the
    # run-local copy goes to a private temporary directory
    assert trainer.main(_SMALL + ["--mesh", "2,1,1", "--steps", "2",
                                  "--feedback-every", "1",
                                  "--feedback-band", "0.3"]) == 0
    assert host.read_bytes() == before
    assert os.environ["FLEXTREE_CALIBRATION"] == str(host)


def test_trainer_feedback_replan_repoints_the_calibration(tmp_path,
                                                          monkeypatch):
    """A replan during ``trainer.main``: the rebuild points the variables
    at the run-local refit (the step's sync reads it on every call) and
    the run's end restores them."""
    host = tmp_path / "CALIBRATION.json"
    _skewed(host, t_cal, t_cal.backend_fingerprint("cpu"))
    before = host.read_bytes()
    monkeypatch.setenv("FLEXTREE_CALIBRATION", str(host))
    monkeypatch.setenv("FLEXTREE_CALIBRATION_BACKEND", "cpu")
    monkeypatch.setenv("FLEXTREE_PLAN_CACHE", str(tmp_path / "plans.json"))
    seen = {}
    real = t_fb.FeedbackController.__init__

    def scripted(self, n, nbytes, cfg=None, **kw):
        cfg.min_samples, cfg.min_window = 6, 2
        kw["timer"] = _true_timer(t_fb, t_cal)
        real(self, 8, nbytes, cfg, **kw)
        hook = cfg.on_replan

        def on_replan(plan, p):
            out = hook(plan, p)
            seen["env"] = os.environ["FLEXTREE_CALIBRATION"]
            seen["default"] = t_cal.default_params()
            return out

        cfg.on_replan = on_replan

    monkeypatch.setattr(t_fb.FeedbackController, "__init__", scripted)
    cal = tmp_path / "refits.json"
    out: dict = {}
    assert trainer.main(_SMALL + ["--mesh", "2,1,1", "--steps", "4",
                                  "--feedback-every", "2", "--obs-dir",
                                  str(tmp_path / "obs"),
                                  "--feedback-calibration", str(cal)],
                        out=out) == 0
    rep = out["result"].report
    assert (rep.feedback_refits, rep.feedback_replans) == (1, 1)
    assert seen["env"] == str(cal)
    assert seen["default"] == t_cal.load_calibration(cal, backend="cpu")
    assert json.loads(cal.read_text())["cpu"]["source"] == "feedback"
    assert host.read_bytes() == before
    assert os.environ["FLEXTREE_CALIBRATION"] == str(host)


@pytest.mark.parametrize("flags", [["--mesh", "2,2,1"],
                                   ["--model", "pipeline", "--mesh",
                                    "1,2,1,1"]], ids=["dense", "pipeline"])
def test_wide_mesh_arms_and_ticks(flags, tmp_path, monkeypatch):
    """A (2, 2, 1) dense mesh and a (1, 2, 1, 1) pipeline: the probes run
    over the largest axis (2 ranks) and the controller ticks."""
    monkeypatch.setenv("FLEXTREE_PLAN_CACHE", str(tmp_path / "plans.json"))
    obs = tmp_path / "obs"
    assert trainer.main(_SMALL + flags + ["--steps", "3", "--feedback-every",
                                          "1", "--obs-dir", str(obs)]) == 0
    events = [json.loads(ln) for ln in
              (obs / "flight_00000.jsonl").read_text().splitlines()]
    ticks = [e for e in events if e["kind"] == "feedback_tick"]
    assert len(ticks) == 2 and all(e["probes"] == 4 for e in ticks)
    probes = [e for e in events if e["kind"] == "bucket_measured"]
    assert probes and all(e["world"] == {"ftfb": 2} for e in probes)
