"""``fit(supervision=)`` of the port against the JAX package's ``fit``.

Each scenario of the JAX ``TestFitSupervision`` (``tests/test_runtime.py``)
runs through both loops with the same scripted membership, the same
stalls and the same preemption point: a toy step (``w -= 0.01 *
mean(batch)``), numpy on the JAX side and float64 tensors on the port's.
The ``RunReport`` payloads must be equal outside ``metrics`` and the final
``w`` equal, bitwise; each scenario also pins what the JAX test pins.
"""

from __future__ import annotations

import gc
import json
import os
import time

import numpy as np
import pytest
import torch

from flextree_tpu.parallel import loop as jloop
from flextree_tpu.runtime import BackgroundSaver as JSaver
from flextree_tpu.runtime import PreemptionGuard as JGuard
from flextree_tpu.runtime import StepTimeout as JTimeout
from flextree_tpu_torch.parallel import loop as tloop
from flextree_tpu_torch.runtime import BackgroundSaver as TSaver
from flextree_tpu_torch.runtime import PreemptionGuard as TGuard
from flextree_tpu_torch.runtime import StepTimeout as TTimeout
from flextree_tpu_torch.utils import checkpoint as tckpt

STALL_S = 0.6


@pytest.fixture
def no_gc_pauses():
    """Automatic collections off while the test runs: in a worker that
    has run many test files, a generation-2 collection of its heap takes
    0.24-0.42 s (measured), longer than the 0.2 s step deadline, and one
    landing inside a step, on either side, times it out beside the
    scripted stall.  (No collection is forced here either: one would
    finalize whatever an earlier file on the worker left behind inside
    this test.)"""
    gc.disable()
    yield
    gc.enable()


class _ToyData:
    def batch_at(self, step):
        tok = np.full((2, 4), float(step + 1))
        return tok, tok


def _toy_step(port: bool, stall_once=(), on_step=None):
    """w -= 0.01 * mean(batch); stalls once (``STALL_S``) at the given
    steps."""
    stall_once = set(stall_once)

    def step_fn(state, tokens, targets):
        s = int(np.asarray(state["step"]))
        if on_step is not None:
            on_step(s)
        if s in stall_once:
            stall_once.discard(s)
            time.sleep(STALL_S)
        g = float(tokens.mean())
        if port:
            return ({"step": torch.tensor(s + 1, dtype=torch.int64),
                     "w": state["w"] - 0.01 * g}, {"loss": torch.tensor(g)})
        return ({"step": np.int64(s + 1),
                 "w": np.asarray(state["w"]) - 0.01 * g}, {"loss": g})

    return step_fn


def _w0(port: bool):
    if port:
        return {"step": torch.tensor(0, dtype=torch.int64),
                "w": torch.zeros(4, dtype=torch.float64)}
    return {"step": np.int64(0), "w": np.zeros(4, dtype=np.float64)}


def _expected_w(steps):
    return -0.01 * sum(s + 1 for s in steps) * np.ones(4)


def _scripted(dead_after, world, dead_rank, straggler=None):
    """A membership callable: every rank healthy until call
    ``dead_after`` (then ``dead_rank`` dead); ``straggler`` always so."""
    calls = {"n": 0}

    def membership():
        calls["n"] += 1
        st = {r: "healthy" for r in range(world)}
        if straggler is not None:
            st[straggler] = "straggler"
        if dead_after is not None and calls["n"] > dead_after:
            st[dead_rank] = "dead"
        return st

    return membership


def _scenario(name, port, tmp):
    """``(step_fn, FitConfig kwargs, Supervision kwargs, extra)``
    of one scenario for one package; ``extra`` holds what the scenario's
    own checks read."""
    ck = os.path.join(tmp, "ck")
    extra: dict = {}
    if name == "timeout_retried":
        return (_toy_step(port, stall_once={3}),
                dict(num_steps=6, ckpt_dir=ck, log_every=0),
                dict(step_timeout_s=0.2, max_step_retries=1), extra)
    if name == "shrink":
        rebuilt = extra["rebuilt"] = []

        def on_shrink(n_alive, plan):
            rebuilt.append((n_alive, plan.to_ft_topo()))
            return None

        return (_toy_step(port, on_step=extra.setdefault("calls", []).append),
                dict(num_steps=10, ckpt_dir=ck, ckpt_every=2, log_every=0),
                dict(membership=_scripted(6, 4, 3), configured_world=4,
                     on_shrink=on_shrink, nbytes_hint=1 << 20), extra)
    if name == "shrink_swaps_step":
        ran = extra["ran_after"] = []

        def on_shrink(n_alive, plan):
            return _toy_step(port, on_step=ran.append), None, None

        return (_toy_step(port),
                dict(num_steps=8, ckpt_dir=ck, ckpt_every=2, log_every=0),
                dict(membership=_scripted(4, 2, 1), configured_world=2,
                     on_shrink=on_shrink), extra)
    if name == "straggler":
        return (_toy_step(port), dict(num_steps=6, log_every=0),
                dict(membership=_scripted(None, 2, 1, straggler=1),
                     configured_world=2), extra)
    if name == "preempt":
        guard = extra["guard"] = (TGuard if port else JGuard)()

        def trigger_at_4(s):
            if s == 4:
                guard.trigger()

        return (_toy_step(port, on_step=trigger_at_4),
                dict(num_steps=20, ckpt_dir=ck, ckpt_every=100, log_every=0),
                dict(preemption=guard), extra)
    if name == "background_saver":
        bs = extra["saver"] = (TSaver if port else JSaver)(ck)
        return (_toy_step(port),
                dict(num_steps=9, ckpt_dir=ck, ckpt_every=2, log_every=0),
                dict(background_saver=bs), extra)
    if name == "timeout_and_shrink":
        # a stall times out while a peer is confirmed dead: the timeout
        # path's membership poll shrinks instead of retrying
        return (_toy_step(port, stall_once={4}),
                dict(num_steps=8, ckpt_dir=ck, ckpt_every=2, log_every=0),
                dict(membership=_scripted(6, 3, 2), configured_world=3,
                     step_timeout_s=0.2, max_step_retries=0), extra)
    assert name == "empty"
    return (_toy_step(port), dict(num_steps=4, log_every=0), {}, extra)


SCENARIOS = ("empty", "timeout_retried", "shrink", "shrink_swaps_step",
             "straggler", "preempt", "background_saver",
             "timeout_and_shrink")


def _run_both(name, tmp_path):
    out = {}
    for port in (False, True):
        lp = tloop if port else jloop
        tmp = str(tmp_path / ("port" if port else "jax"))
        step_fn, fcfg, skw, extra = _scenario(name, port, tmp)
        res = lp.fit(_w0(port), step_fn, _ToyData(), lp.FitConfig(**fcfg),
                     supervision=lp.Supervision(**skw))
        if "saver" in extra:
            extra["saver"].close()
        out[port] = (res, extra, tmp)
    return out


@pytest.mark.parametrize("name", SCENARIOS)
def test_supervised_fit_matches_jax(name, tmp_path, no_gc_pauses):
    out = _run_both(name, tmp_path)
    (jres, jextra, _), (tres, textra, tmp) = out[False], out[True]
    jp, tp = jres.report.to_payload(), tres.report.to_payload()
    jp.pop("metrics")
    tp.pop("metrics")
    if name == "background_saver":
        # how many submits coalesce depends on the writer's speed
        assert jp.pop("background_saves") >= 1
        assert tp.pop("background_saves") >= 1
    assert tp == jp
    assert np.asarray(jres.state["w"]).tobytes() == \
        tres.state["w"].numpy().tobytes()
    assert tres.steps_run == jres.steps_run
    rep = tres.report
    if name == "empty":
        assert rep.step_timeouts == 0 and rep.membership_epochs == []
    elif name == "timeout_retried":
        assert (rep.step_timeouts, rep.step_retries) == (1, 1)
        np.testing.assert_allclose(tres.state["w"].numpy(),
                                      _expected_w(range(6)))
    elif name == "shrink":
        ep = rep.membership_epochs
        assert [e["alive"] for e in ep] == [4, 3] and ep[1]["dead"] == [3]
        assert textra["rebuilt"] == jextra["rebuilt"] == [(3, ep[1]["topo"])]
        # rank 3 is seen dead before step 5: the survivors restore step
        # 4's checkpoint and replay step 4
        assert ep[1]["step"] == 5
        assert textra["calls"] == jextra["calls"] == [*range(5), *range(4, 10)]
        # the restore and the replay of the batches since: exact
        np.testing.assert_allclose(tres.state["w"].numpy(),
                                      _expected_w(range(10)))
    elif name == "shrink_swaps_step":
        assert textra["ran_after"] and \
            textra["ran_after"] == jextra["ran_after"]
    elif name == "straggler":
        assert rep.stragglers == [{"rank": 1, "step": 0}]
        assert len(rep.membership_epochs) == 1  # a stall is not a death
    elif name == "preempt":
        assert rep.preempted_at == 5 and tres.steps_run == 5
        assert tckpt.latest_checkpoint(os.path.join(tmp, "ck")).endswith(
            "ckpt_00000005.npz")
        resumed = tloop.fit(_w0(True), _toy_step(True), _ToyData(),
                            tloop.FitConfig(num_steps=20,
                                            ckpt_dir=os.path.join(tmp, "ck"),
                                            ckpt_every=100, log_every=0))
        assert resumed.resumed_from == 5
        np.testing.assert_allclose(resumed.state["w"].numpy(),
                                      _expected_w(range(20)))
    elif name == "background_saver":
        steps = [s for s, _ in tckpt.list_checkpoints(
            os.path.join(tmp, "ck"))]
        assert steps[-1] == 9  # the final synchronous save, after a drain
    elif name == "timeout_and_shrink":
        assert rep.step_timeouts == 1 and rep.step_retries == 0
        assert [e["alive"] for e in rep.membership_epochs] == [3, 2]
        np.testing.assert_allclose(tres.state["w"].numpy(),
                                      _expected_w(range(8)))


@pytest.mark.parametrize("port", [False, True])
def test_step_timeout_exhausted_raises_typed(port):
    lp = tloop if port else jloop

    def hang(state, tokens, targets):
        time.sleep(30)

    with pytest.raises(TTimeout if port else JTimeout,
                       match="FT_STEP_TIMEOUT"):
        lp.fit(_w0(port), hang, _ToyData(),
               lp.FitConfig(num_steps=4, log_every=0),
               supervision=lp.Supervision(step_timeout_s=0.1,
                                          max_step_retries=1))


def test_step_timeout_env_knob(monkeypatch):
    monkeypatch.setenv("FT_STEP_TIMEOUT", "0.1")
    with pytest.raises(TTimeout):
        tloop.fit(_w0(True), lambda *a: time.sleep(30), _ToyData(),
                  tloop.FitConfig(num_steps=2, log_every=0),
                  supervision=tloop.Supervision(max_step_retries=0))


@pytest.mark.parametrize("port", [False, True])
def test_shrink_budget_exhaustion_is_typed(port):
    lp = tloop if port else jloop
    with pytest.raises(lp.ShrinkExhausted, match="max_shrinks"):
        lp.fit(_w0(port), _toy_step(port), _ToyData(),
               lp.FitConfig(num_steps=8, log_every=0),
               supervision=lp.Supervision(
                   membership=lambda: {0: "healthy", 1: "dead"},
                   configured_world=2, max_shrinks=0))


def test_run_report_json_machine_readable(tmp_path):
    ck = str(tmp_path / "ck")
    tloop.fit(_w0(True), _toy_step(True, stall_once={2}), _ToyData(),
              tloop.FitConfig(num_steps=5, ckpt_dir=ck, log_every=0),
              supervision=tloop.Supervision(step_timeout_s=0.2))
    with open(os.path.join(ck, "run_report.json")) as f:
        persisted = json.load(f)
    for key in ("init_retries", "step_timeouts", "step_retries",
                "stragglers", "membership_epochs", "preempted_at",
                "background_saves", "lease_epochs", "control_epochs"):
        assert key in persisted
    assert persisted["step_timeouts"] == 1
    assert persisted["metrics"]["counters"]["train.step_timeouts"] == 1
    assert persisted["lease_epochs"] == persisted["control_epochs"] == []
    assert json.loads(tloop.RunReport(**persisted).to_json()) == persisted
    # the JAX report's keys, each one
    assert set(persisted) == set(jloop.RunReport().to_payload())
