"""The port's step watchdog (``flextree_tpu_torch/runtime/watchdog.py``)
against the JAX package's on the same scenarios: a step inside its
deadline returns, an overrun raises ``StepTimeout`` with the same fields
and abandons its worker (the next run gets a fresh one), a raised error
passes through, ``timeout_s=None`` runs inline, and the env knob."""

from __future__ import annotations

import importlib
import threading

import pytest

from flextree_tpu_torch import runtime as truntime
from flextree_tpu_torch.obs import flight_recorder as t_flight_recorder
from flextree_tpu_torch.runtime import watchdog as twd

jwd = importlib.import_module("flextree_tpu.runtime.watchdog")

BOTH = pytest.mark.parametrize("wd", [jwd, twd], ids=["jax", "torch"])


def _overrun(wd, gate):
    """One run held past a 0.05 s deadline by ``gate``; returns the
    watchdog, the raised error and the stuck worker's thread."""
    dog = wd.StepWatchdog()
    stuck = {}

    def hang():
        stuck["thread"] = threading.current_thread()
        gate.wait(30.0)

    with pytest.raises(wd.StepTimeout) as err:
        dog.run(hang, timeout_s=0.05, step=7)
    return dog, err.value, stuck["thread"]


@BOTH
def test_step_within_deadline_returns(wd):
    with wd.StepWatchdog() as dog:
        assert dog.run(lambda a, b=0: a + b, 2, b=3, timeout_s=5.0) == 5
        main = threading.current_thread()
        ran = dog.run(threading.current_thread, timeout_s=5.0)
        assert ran is not main and ran.daemon
        assert ran.name == "ft-step-watchdog"
        # the worker persists across runs
        assert dog.run(threading.current_thread, timeout_s=5.0) is ran
        assert dog.abandoned == 0


@BOTH
def test_inline_when_off_and_errors_pass_through(wd):
    dog = wd.StepWatchdog()
    assert dog.run(threading.current_thread, timeout_s=None) is \
        threading.current_thread()

    def boom():
        raise KeyError("inner")

    for timeout in (None, 5.0):
        with pytest.raises(KeyError, match="inner"):
            dog.run(boom, timeout_s=timeout)
    dog.close()


def test_overrun_fields_and_fresh_worker_match_jax():
    """Both packages, the same overrun: the same error text and fields,
    the same ``abandoned`` count, and a next run on a fresh worker."""
    seen = {}
    for name, wd in (("jax", jwd), ("torch", twd)):
        gate = threading.Event()
        dog, err, stuck = _overrun(wd, gate)
        fresh = dog.run(threading.current_thread, timeout_s=5.0)
        assert fresh is not stuck and fresh.daemon
        assert stuck.is_alive()  # abandoned, not interrupted
        gate.set()
        stuck.join(5.0)
        dog.close()
        seen[name] = (str(err), err.step, err.timeout_s, err.code,
                      dog.abandoned)
    assert seen["torch"] == seen["jax"]
    assert seen["torch"] == (
        "FT_STEP_TIMEOUT: step 7 exceeded its 0.05s deadline", 7, 0.05,
        "FT_STEP_TIMEOUT", 1)
    assert str(twd.StepTimeout(None, 2.0, "note")) == \
        str(jwd.StepTimeout(None, 2.0, "note"))


def test_overrun_records_watchdog_timeout_event():
    gate = threading.Event()
    with t_flight_recorder(None) as rec:
        dog, _, stuck = _overrun(twd, gate)
    gate.set()
    stuck.join(5.0)
    dog.close()
    ev = [e for e in rec.events if e["kind"] == "watchdog_timeout"]
    assert len(ev) == 1
    assert (ev[0]["step"], ev[0]["timeout_s"], ev[0]["abandoned"]) == \
        (7, 0.05, 1)


@pytest.mark.parametrize("raw, want", [(None, None), ("", None),
                                       ("2.5", 2.5), ("30", 30.0)])
def test_step_timeout_from_env(monkeypatch, raw, want):
    assert twd.FT_STEP_TIMEOUT_ENV == jwd.FT_STEP_TIMEOUT_ENV == \
        "FT_STEP_TIMEOUT"
    if raw is None:
        monkeypatch.delenv("FT_STEP_TIMEOUT", raising=False)
    else:
        monkeypatch.setenv("FT_STEP_TIMEOUT", raw)
    assert twd.step_timeout_from_env() == jwd.step_timeout_from_env() == want


def test_runtime_exports_the_watchdog():
    assert truntime.StepWatchdog is twd.StepWatchdog
    assert truntime.StepTimeout is twd.StepTimeout
    assert truntime.step_timeout_from_env is twd.step_timeout_from_env
