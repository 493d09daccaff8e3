"""``runtime.PreemptionGuard`` and ``runtime.BackgroundSaver`` of the
port, the JAX package's cases (``tests/test_runtime.py``) on the port's
classes, and the port's background checkpoints read back by the JAX
package, bitwise."""

from __future__ import annotations

import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from flextree_tpu.utils import checkpoint as jckpt
from flextree_tpu_torch.parallel import loop as tloop
from flextree_tpu_torch.runtime import BackgroundSaver, PreemptionGuard
from flextree_tpu_torch.utils import checkpoint as tckpt


class TestPreemptionGuard:
    def test_sigterm_latches_flag_and_restores_handler(self):
        before = signal.getsignal(signal.SIGTERM)
        with PreemptionGuard() as g:
            assert not g.preempted
            os.kill(os.getpid(), signal.SIGTERM)
            deadline = time.time() + 2.0
            while not g.preempted and time.time() < deadline:
                time.sleep(0.01)
            assert g.preempted
            assert g.triggered_at is not None
        assert signal.getsignal(signal.SIGTERM) is before

    def test_trigger_is_idempotent(self):
        g = PreemptionGuard()
        g.trigger()
        first = g.triggered_at
        g.trigger()
        assert g.triggered_at == first


def _state(step):
    return {"step": torch.tensor(step, dtype=torch.int64),
            "w": torch.ones(4, dtype=torch.float64) * step}


class TestBackgroundSaver:
    def test_saves_land_and_coalesce(self, tmp_path):
        with BackgroundSaver(tmp_path, max_to_keep=5) as bs:
            for s in (2, 4, 6, 8):
                bs.submit(_state(s))
            assert bs.drain(timeout=10)
        steps = [s for s, _ in tckpt.list_checkpoints(tmp_path)]
        # latest wins: the newest submit always lands; earlier ones may
        # coalesce away but never reorder past it
        assert steps and steps[-1] == 8
        assert bs.saves + bs.dropped == 4
        assert bs.errors == []

    def test_save_error_recorded_not_raised(self, tmp_path):
        bs = BackgroundSaver(tmp_path / "dir")
        bs.submit({"no_step_key": torch.ones(2)})  # the save raises
        bs.close()
        assert bs.saves == 0 and len(bs.errors) == 1

    def test_background_checkpoint_is_bitwise_and_jax_reads_it(self,
                                                               tmp_path):
        """The saved file is the submitted state, bitwise, even when the
        caller drops its reference and makes new states meanwhile; the
        JAX package restores it to the same bits."""
        rng = np.random.default_rng(0)
        live = {"step": torch.tensor(3, dtype=torch.int32),
                "params": {"w": torch.as_tensor(
                    rng.standard_normal((64, 32)).astype(np.float32)),
                    "b": torch.as_tensor(rng.standard_normal(32).astype(
                        np.float32)).to(torch.bfloat16)}}
        want = {k: v.clone() for k, v in live["params"].items()}
        with BackgroundSaver(tmp_path) as bs:
            bs.submit(live)
            del live
            for _ in range(3):  # later "steps" allocate meanwhile
                torch.randn(64, 32)
            assert bs.drain(timeout=10)
        got = tckpt.restore_train_state(tmp_path, "cpu")
        for k, v in want.items():
            assert torch.equal(got["params"][k].view(torch.uint8),
                               v.view(torch.uint8))
        jgot = jckpt.restore_train_state(str(tmp_path))
        assert np.asarray(jgot["params"]["w"]).tobytes() == \
            want["w"].numpy().tobytes()
        assert int(np.asarray(jgot["step"])) == 3

    def test_second_preempt_before_first_save_lands_keeps_newest(
            self, tmp_path, monkeypatch):
        """A submit that arrives while the first save is still writing
        never loses the newer state: the middle one coalesces away, the
        newest lands, and ``drain`` reports busy until the slot empties."""
        real = tckpt.save_train_state
        gate, started = threading.Event(), threading.Event()
        landed = []

        def gated_save(dir, state, **kw):
            started.set()
            assert gate.wait(10), "test gate never opened"
            landed.append(int(state["step"]))
            return real(dir, state, **kw)

        monkeypatch.setattr(tckpt, "save_train_state", gated_save)
        bs = BackgroundSaver(tmp_path, max_to_keep=5)
        bs.submit(_state(5))
        assert started.wait(10)
        bs.submit(_state(6))
        bs.submit(_state(7))
        assert not bs.drain(timeout=0.2)  # the slot is busy
        gate.set()
        assert bs.drain(timeout=10)
        bs.close()
        steps = [s for s, _ in tckpt.list_checkpoints(tmp_path)]
        assert steps[-1] == 7, steps
        assert landed == [5, 7]
        assert bs.saves == 2 and bs.dropped == 1

    def test_preempt_drain_ordering_no_writer_overlap(self, tmp_path,
                                                      monkeypatch):
        """``fit``'s checkpoint-now save never starts while a background
        save is in flight (two writers racing the rotation)."""
        real = tckpt.save_train_state
        order = []

        def tracked_save(dir, state, **kw):
            me = threading.current_thread().name
            order.append(("start", me))
            if me == "ft-bg-ckpt":
                time.sleep(0.25)  # a slow background write
            out = real(dir, state, **kw)
            order.append(("end", me))
            return out

        monkeypatch.setattr(tckpt, "save_train_state", tracked_save)
        monkeypatch.setattr(tloop, "save_train_state", tracked_save)
        ck = str(tmp_path / "ck")
        bs = BackgroundSaver(ck)
        guard = PreemptionGuard()

        def step_fn(state, tokens, targets):
            s = int(state["step"])
            if s == 3:  # "SIGTERM" while step 2's background save is slow
                guard.trigger()
            return ({"step": torch.tensor(s + 1), "w": state["w"] - 0.01},
                    {"loss": torch.tensor(1.0)})

        class Data:
            def batch_at(self, step):
                return np.zeros((1, 1)), np.zeros((1, 1))

        res = tloop.fit(
            {"step": torch.tensor(0), "w": torch.zeros(4)}, step_fn, Data(),
            tloop.FitConfig(num_steps=20, ckpt_dir=ck, ckpt_every=2,
                            log_every=0),
            supervision=tloop.Supervision(preemption=guard,
                                          background_saver=bs),
        )
        bs.close()
        assert res.report.preempted_at == 4
        bg_open = 0
        for kind, name in order:
            if name == "ft-bg-ckpt":
                bg_open += 1 if kind == "start" else -1
            elif kind == "start":
                assert bg_open == 0, order
        assert tckpt.latest_checkpoint(ck).endswith("ckpt_00000004.npz")

