"""``fit(arbiter=)``, ``Supervision(coordination=)`` and the coordinated
feedback replan of the port against the JAX package's, on the CPU.

- ``fit(arbiter=TrainLeaseClient)`` on the toy step (the JAX suite's
  ``tests/test_arbiter.py::TestFitLeaseResize``): one scripted grant
  change a poll on both sides, the same ``lease_epochs`` each with a
  bitwise resume, no step lost, the final state bitwise the JAX one and
  an undisturbed run's; without a checkpoint dir the live state carries
  through; a zero-chip grant raises.
- The ZeRO-1 dp-3 → 1 → 3 in-process mesh of the port under the same
  script as the JAX ``fit`` on 3 of its 8 virtual devices: two bitwise
  resumes a side, and the final consolidated states within the DP
  tests' tolerances.
- The committed shrink (``tests/test_coordination.py::
  TestFitCoordination``): a confirmed death becomes a proposal and the
  shrink applies the committed payload, the same epochs and payload on
  both sides.
- The coordinated feedback (``tests/test_coordination.py::
  TestCoordinatedFeedback`` and ``TestFollowerDrift``): a follower never
  probes, the coordinator's drift proposes a group replan whose commit
  every rank applies through ``apply_committed``, which follows the
  broadcast topology; the controller ships its detector's summary.
"""

from __future__ import annotations

import dataclasses
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flextree_tpu_torch.convert import (
    train_state_from_numpy,
    train_state_to_numpy,
)
from flextree_tpu_torch.parallel import loop as tloop
from flextree_tpu_torch.runtime import coordination as tco
from flextree_tpu_torch.runtime import leases as tle

jloop = importlib.import_module("flextree_tpu.parallel.loop")
jco = importlib.import_module("flextree_tpu.runtime.coordination")
jle = importlib.import_module("flextree_tpu.runtime.leases")


# ------------------------------------------------------- the toy step


class _ToyData:
    def batch_at(self, step):
        tok = np.full((2, 4), float(step + 1))
        return tok, tok


def _toy_step_jax(state, tokens, targets):
    s = int(np.asarray(state["step"]))
    return ({"step": np.int64(s + 1),
             "w": np.asarray(state["w"]) - 0.01 * float(tokens.mean())},
            {"loss": float(tokens.mean())})


def _toy_step_port(state, tokens, targets):
    g = float(tokens.mean())
    return ({"step": state["step"] + 1, "w": state["w"] - 0.01 * g},
            {"loss": torch.tensor(g)})


def _w0_jax():
    return {"step": np.int64(0), "w": np.zeros(4, dtype=np.float64)}


def _w0_port():
    return {"step": torch.tensor(0), "w": torch.zeros(4, dtype=torch.float64)}


def _scripted_client(le, led, script, **kw):
    """A lease client whose ledger the script rewrites at the polling
    step: the in-process stand-in for the arbiter."""
    client = le.TrainLeaseClient(led, poll_interval_s=0.0, **kw)
    orig = client.poll
    script = dict(script)

    def poll(step):
        for at, (epoch, grants) in list(script.items()):
            if step >= at:
                led.publish(epoch, grants)
                del script[at]
        return orig(step)

    client.poll = poll
    return client


CYCLE = {4: (1, {"train": (0,), "arbiter": (1, 2), "serve": (3,)}),
         8: (2, {"train": (0, 1, 2), "serve": (3,)})}


def _toy_lease_run(side, tmp, ckpt=True):
    le, loop = (tle, tloop) if side == "port" else (jle, jloop)
    led = le.LeaseLedger(str(tmp / "hb"))
    led.publish(0, {"train": (0, 1, 2), "serve": (3,)})
    seen = []
    client = _scripted_client(le, led, CYCLE)
    client.on_resize = lambda chips, plan: seen.append(
        (tuple(chips), plan.to_ft_topo())) or None
    step, w0 = ((_toy_step_port, _w0_port()) if side == "port"
                else (_toy_step_jax, _w0_jax()))
    res = loop.fit(w0, step, _ToyData(),
                   loop.FitConfig(num_steps=12,
                                  ckpt_dir=str(tmp / "ck") if ckpt else None,
                                  ckpt_every=100, log_every=0, prefetch=0),
                   arbiter=client)
    return res, seen, led


@pytest.mark.parametrize("ckpt", [True, False])
def test_toy_lease_cycle_matches_jax(ckpt, tmp_path):
    tres, tseen, tled = _toy_lease_run("port", tmp_path / "p", ckpt)
    jres, jseen, jled = _toy_lease_run("jax", tmp_path / "j", ckpt)
    assert tres.steps_run == jres.steps_run == 12  # no step lost
    assert tres.report.lease_epochs == jres.report.lease_epochs
    assert [e["epoch"] for e in tres.report.lease_epochs] == [1, 2]
    assert [len(e["chips"]) for e in tres.report.lease_epochs] == [1, 3]
    assert all(e["bitwise_resume"] for e in tres.report.lease_epochs)
    assert tseen == jseen == [((0,), tres.report.lease_epochs[0]["topo"]),
                              ((0, 1, 2), tres.report.lease_epochs[1]["topo"])]
    assert tled.acked_epoch("train") == jled.acked_epoch("train") == 2
    assert tres.report.metrics["counters"]["train.lease_resizes"] == 2
    want = np.asarray(jres.state["w"])
    assert tres.state["w"].numpy().tobytes() == want.tobytes()
    oracle = tloop.fit(_w0_port(), _toy_step_port, _ToyData(),
                       tloop.FitConfig(num_steps=12, log_every=0,
                                       prefetch=0))
    assert torch.equal(oracle.state["w"], tres.state["w"])
    if ckpt:
        persisted = json.loads(
            (tmp_path / "p" / "ck" / "run_report.json").read_text())
        assert persisted["lease_epochs"] == tres.report.lease_epochs


def test_zero_chip_grant_raises(tmp_path):
    for le, loop, step, w0 in ((tle, tloop, _toy_step_port, _w0_port()),
                               (jle, jloop, _toy_step_jax, _w0_jax())):
        d = tmp_path / le.__name__
        led = le.LeaseLedger(str(d))
        led.publish(0, {"train": (0,)})
        client = _scripted_client(le, led, {2: (1, {"arbiter": (0,)})})
        with pytest.raises(ValueError, match="zero chips"):
            loop.fit(w0, step, _ToyData(),
                     loop.FitConfig(num_steps=6, log_every=0, prefetch=0),
                     arbiter=client)


# ------------------------------------------- ZeRO-1 dp-3 -> 1 -> 3


DIMS = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
ZSTEPS = 6
ZCYCLE = {2: (1, {"train": (0,), "arbiter": (1, 2), "serve": (3,)}),
          4: (2, {"train": (0, 1, 2), "serve": (3,)})}


class _LMData:
    def batch_at(self, step):
        rng = np.random.default_rng(100 + step)
        toks = rng.integers(0, DIMS["vocab_size"], (6, 16)).astype(np.int32)
        tgts = rng.integers(0, DIMS["vocab_size"], (6, 16)).astype(np.int32)
        return toks, tgts


def _jax_worlds():
    jt = importlib.import_module("flextree_tpu.models.transformer")
    jtrain = importlib.import_module("flextree_tpu.parallel.train")
    jzero = importlib.import_module("flextree_tpu.parallel.zero")
    cfg = jt.TransformerConfig(**DIMS)
    tc = jtrain.TrainConfig(shard_optimizer=True)
    cache = {}

    def build(n, grad_topo=None):
        if (n, grad_topo) not in cache:
            t = dataclasses.replace(tc, grad_topo=grad_topo)
            mesh = jtrain.make_mesh_nd(n, (n, 1, 1), ("dp", "sp", "tp"))
            pspecs = jt.param_specs(cfg, "tp")
            shapes = jax.eval_shape(lambda k: jt.init_params(k, cfg),
                                    jax.random.PRNGKey(0))
            layout = jtrain.zero_layout_for(mesh, shapes, pspecs,
                                            ("dp", "sp", "tp"))
            cache[(n, grad_topo)] = (
                jtrain.make_train_step(mesh, cfg, t), mesh,
                jtrain.make_state_specs(pspecs, dataclasses.replace(
                    t, shard_optimizer=False)),
                jzero.make_consolidate_fn(mesh, pspecs, layout, grad_topo,
                                          False),
                jzero.make_reshard_fn(mesh, pspecs, layout, grad_topo, False))
        return cache[(n, grad_topo)]

    replicated = jax.tree.map(np.array, jtrain.init_train_state(
        jax.random.PRNGKey(0), cfg))
    return build, replicated


def _port_worlds():
    from flextree_tpu_torch.models import transformer as tt
    from flextree_tpu_torch.parallel import train as ttrain
    from flextree_tpu_torch.parallel import zero as tzero
    from flextree_tpu_torch.parallel.mesh import flat_mesh

    cfg = tt.TransformerConfig(**DIMS)
    tc = ttrain.TrainConfig(shard_optimizer=True)
    shapes = tt.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    pspecs = tt.param_specs(cfg)
    cache = {}

    def build(n, grad_topo=None):
        if (n, grad_topo) not in cache:
            mesh = flat_mesh(n, "cpu", "dp")
            layout = ttrain.zero_layout_for(mesh, shapes, pspecs)
            cache[(n, grad_topo)] = (
                ttrain.make_train_step(
                    cfg, dataclasses.replace(tc, grad_topo=grad_topo),
                    device="cpu", comm=mesh), mesh, None,
                tzero.make_consolidate_fn(mesh, pspecs, layout, grad_topo,
                                          False),
                tzero.make_reshard_fn(mesh, pspecs, layout, grad_topo, False))
        return cache[(n, grad_topo)]

    return build


def test_zero1_dp3_to_1_to_3_matches_jax(tmp_path):
    jax.devices()
    jbuild, replicated = _jax_worlds()
    # -- JAX: fit on 3 of the 8 virtual devices
    jled = jle.LeaseLedger(str(tmp_path / "jhb"))
    jled.publish(0, {"train": (0, 1, 2), "serve": (3,)})
    jclient = _scripted_client(jle, jled, ZCYCLE, initial_chips=(0, 1, 2),
                               configured=3, nbytes_hint=1 << 20)
    jclient.on_resize = lambda chips, plan: jbuild(len(chips),
                                                   plan.to_ft_topo())
    jstep, jmesh, jspecs, jpack, junpack = jbuild(3)
    jres = jloop.fit(
        junpack(jax.tree.map(jnp.asarray, replicated)), jstep, _LMData(),
        jloop.FitConfig(num_steps=ZSTEPS, ckpt_dir=str(tmp_path / "jck"),
                        ckpt_every=100, log_every=1, prefetch=0),
        mesh=jmesh, state_specs=jspecs, arbiter=jclient,
        state_pack=jpack, state_unpack=junpack)
    # -- the port: the in-process mesh on the CPU
    tbuild = _port_worlds()
    tled = tle.LeaseLedger(str(tmp_path / "thb"))
    tled.publish(0, {"train": (0, 1, 2), "serve": (3,)})
    tclient = _scripted_client(tle, tled, ZCYCLE, initial_chips=(0, 1, 2),
                               configured=3, nbytes_hint=1 << 20)
    tclient.on_resize = lambda chips, plan: tbuild(len(chips),
                                                   plan.to_ft_topo())
    tstep, _, _, tpack, tunpack = tbuild(3)
    tres = tloop.fit(
        tunpack(train_state_from_numpy(replicated, device="cpu")), tstep,
        _LMData(), tloop.FitConfig(num_steps=ZSTEPS,
                                   ckpt_dir=str(tmp_path / "tck"),
                                   ckpt_every=100, log_every=1, prefetch=0),
        arbiter=tclient, state_pack=tpack, state_unpack=tunpack)
    te, je = tres.report.lease_epochs, jres.report.lease_epochs
    assert te == je
    assert [(e["step"], len(e["chips"])) for e in te] == [(2, 1), (4, 3)]
    assert all(e["bitwise_resume"] for e in te)
    assert tres.steps_run == jres.steps_run == ZSTEPS
    assert not tres.report.skipped_steps
    for (js, jl), (ts, tl) in zip(jres.losses, tres.losses):
        assert js == ts and tl == pytest.approx(jl, rel=1e-5)
    want = jax.tree.map(np.array, jpack(jres.state))
    got = train_state_to_numpy(tpack(tres.state))
    assert int(got["step"]) == int(want["step"]) == ZSTEPS
    for key in ("params", "mu", "nu"):
        for a, b in zip(jax.tree.leaves(want[key]),
                        jax.tree.leaves(got[key])):
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=2e-5)


# ------------------------------------------------ the committed shrink


def _shrink_run(side, tmp):
    co, loop = (tco, tloop) if side == "port" else (jco, jloop)
    step, w0 = ((_toy_step_port, _w0_port()) if side == "port"
                else (_toy_step_jax, _w0_jax()))
    calls = {"n": 0}

    def membership():
        calls["n"] += 1
        st = {r: "healthy" for r in range(4)}
        if calls["n"] > 6:
            st[3] = "dead"
        return st

    # a zero ack budget: the fictional peers 1-3 never ack, the first
    # drive tick excludes them, and the decision is proposed again for
    # rank 0 alone
    handle = co.CoordinationHandle(str(tmp / "hb"), 0, membership=membership,
                                   cfg=co.CoordinationConfig(
                                       ack_timeout_s=0.0))
    rebuilt = []
    res = loop.fit(w0, step, _ToyData(),
                   loop.FitConfig(num_steps=10, ckpt_dir=str(tmp / "ck"),
                                  ckpt_every=2, log_every=0, prefetch=0),
                   supervision=loop.Supervision(
                       membership=membership, configured_world=4,
                       on_shrink=lambda n, plan: rebuilt.append(
                           (n, plan.to_ft_topo())),
                       nbytes_hint=1 << 20, coordination=handle))
    return res, handle.ledger.read_commit(), rebuilt


def test_committed_shrink_applies_the_broadcast_plan_like_jax(tmp_path):
    tres, tcommit, trebuilt = _shrink_run("port", tmp_path / "p")
    jres, jcommit, jrebuilt = _shrink_run("jax", tmp_path / "j")
    assert tres.steps_run == jres.steps_run == 10
    epochs = tres.report.membership_epochs
    assert epochs == jres.report.membership_epochs
    assert len(epochs) == 2 and epochs[1]["alive"] == 3
    assert epochs[1]["dead"] == [3]
    assert tres.report.control_epochs == jres.report.control_epochs
    (entry,) = tres.report.control_epochs
    assert entry["kind"] == "shrink" and entry["epoch"] == 1
    assert tcommit.payload == jcommit.payload
    assert tcommit.payload["alive"] == 3
    assert tcommit.payload["topo"] == epochs[1]["topo"]
    assert trebuilt == jrebuilt == [(3, epochs[1]["topo"])]
    assert tres.report.metrics["counters"]["train.control_applies"] == 1
    assert tres.state["w"].numpy().tobytes() == \
        np.asarray(jres.state["w"]).tobytes()
    for payload in ({"alive": 4, "configured": 8, "topo": "ring",
                     "dead": [4]},
                    {"alive": 4, "configured": 8, "topo": "2,2",
                     "dead": [4]}):
        assert tco.committed_shrink_plan(payload, 1 << 20).to_ft_topo() == \
            jco.committed_shrink_plan(payload, 1 << 20).to_ft_topo()
    assert tco.committed_shrink_plan({"alive": 4, "topo": "ring"},
                                     1 << 20).to_ft_topo() == "1"


def test_a_committed_decision_this_rank_cannot_apply_raises(tmp_path):
    """A committed replan with no feedback controller, or a resize with
    no lease client, is the split brain the protocol exists to stop."""
    for kind, payload in (("replan", {"topo": "1"}),
                          ("resize", {"lease_epoch": 1, "chips": [0]})):
        d = str(tmp_path / kind)
        h = tco.CoordinationHandle(d, 0, membership=None)
        h.propose(kind, payload)
        with pytest.raises(tco.ProtocolViolation, match="this rank has no"):
            tloop.fit(_w0_port(), _toy_step_port, _ToyData(),
                      tloop.FitConfig(num_steps=4, log_every=0, prefetch=0),
                      supervision=tloop.Supervision(coordination=h))


# ------------------------------------------- the coordinated feedback


def _controller(side, handle, timer):
    if side == "port":
        from flextree_tpu_torch.planner import calibrate as cal
        from flextree_tpu_torch.planner import feedback as fb

        kw = dict(device="cpu")
    else:
        cal = importlib.import_module("flextree_tpu.planner.calibrate")
        fb = importlib.import_module("flextree_tpu.planner.feedback")
        kw = {}
    # deliberately wrong constants over the JAX defaults, the same on both
    # sides: one probe round breaches the band
    jcal = importlib.import_module("flextree_tpu.planner.calibrate")
    jcm = importlib.import_module("flextree_tpu.planner.cost_model")
    skewed = cal._params_from_dict({
        **jcal._params_to_dict(jcm.TpuCostParams()),
        "ici_bandwidth_GBps": 1e-3, "ici_latency_us": 5000.0,
        "launch_us": 5000.0})
    return fb.FeedbackController(
        4, 1 << 20, fb.FeedbackConfig(every_k=1, band=0.5, min_window=2,
                                      min_samples=4, window=8),
        params=skewed, coordination=handle, timer=timer, **kw)


def _recorder(side):
    if side == "port":
        from flextree_tpu_torch.obs import flight_recorder
    else:
        flight_recorder = importlib.import_module(
            "flextree_tpu.obs").flight_recorder
    return flight_recorder


def _coordinated_feedback(side, tmp):
    co = tco if side == "port" else jco
    rec = _recorder(side)
    out = {}
    # a follower never probes
    members = {0: "healthy", 1: "healthy"}
    follower = co.CoordinationHandle(str(tmp / "f"), 1,
                                     membership=lambda: dict(members))

    def exploding(probes, n):
        raise AssertionError("follower probed")

    ctl = _controller(side, follower, exploding)
    assert follower.drift_provider is not None
    assert follower.drift_provider() == ctl._detector.summary()
    with rec(str(tmp / "obs_f"), rank=1):
        out["follower_tick"] = ctl.maybe_tick(10)
    out["follower_ticks"] = ctl.ticks
    # the coordinator's drift proposes; the commit applies on every rank
    handle = co.CoordinationHandle(str(tmp / "c"), 0, membership=None)
    ctl = _controller(side, handle, lambda probes, n: [1e-4] * len(probes))
    with rec(str(tmp / "obs_c"), rank=0):
        for step in range(1, 6):
            out["tick"] = ctl.tick(step)
            if handle.ledger.read_proposal() is not None:
                break
        prop, _ = handle.ledger.read_proposal()
        out["proposal"] = (prop.kind, prop.apply_step, sorted(prop.payload))
        out["refits"] = ctl.refits
        assert handle.gate(step=10) is None
        dec = handle.gate(step=10)
        applied = ctl.apply_committed(dec.payload, step=10)
    out["topo"] = (dec.payload["topo"], applied.plan.to_ft_topo())
    out["params"] = dec.payload["params"]
    return out


def test_coordinated_feedback_matches_jax(tmp_path):
    port = _coordinated_feedback("port", tmp_path / "p")
    jax_ = _coordinated_feedback("jax", tmp_path / "j")
    assert port["follower_tick"] is None and port["follower_ticks"] == 0
    assert port["tick"] is None  # propose-only: nothing applied locally
    assert port["proposal"] == jax_["proposal"]
    assert port["proposal"][0] == "replan"
    assert {"params", "topo"} <= set(port["proposal"][2])
    assert port["refits"] == jax_["refits"] == 1
    assert port["topo"] == jax_["topo"]
    assert port["topo"][0] == port["topo"][1]
    assert port["params"].keys() == jax_["params"].keys()
    for k, v in jax_["params"].items():
        assert port["params"][k] == pytest.approx(v, rel=1e-9), k
    for k in ("follower_tick", "follower_ticks", "tick"):
        assert port[k] == jax_[k]


def test_apply_committed_follows_the_broadcast_spec():
    """A rank whose own chooser disagrees with the broadcast winner
    follows the group, as the JAX controller does."""
    from flextree_tpu_torch.planner import calibrate as tcal
    from flextree_tpu_torch.planner import cost_model as tcm
    from flextree_tpu_torch.planner import feedback as tfb

    jfb = importlib.import_module("flextree_tpu.planner.feedback")
    jcal = importlib.import_module("flextree_tpu.planner.calibrate")
    jcm = importlib.import_module("flextree_tpu.planner.cost_model")
    tout = tfb.FeedbackController(4, 1 << 20, tfb.FeedbackConfig(),
                                  device="cpu").apply_committed(
        {"params": tcal._params_to_dict(tcm.TpuCostParams()),
         "topo": "ring"}, step=3)
    jout = jfb.FeedbackController(4, 1 << 20, jfb.FeedbackConfig()) \
        .apply_committed({"params": jcal._params_to_dict(jcm.TpuCostParams()),
                          "topo": "ring"}, step=3)
    assert tout.plan.to_ft_topo() == jout.plan.to_ft_topo() == "1"
    assert tout.rebuilt is None and tout.drift == jout.drift == {}
