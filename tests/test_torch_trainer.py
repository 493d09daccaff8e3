"""The port's training driver — data pipeline, checkpoints, ``fit`` and the
trainer CLI — against the JAX package's, on the CPU.

Bitwise wherever the reference's contract is bitwise: the token corpus
and batch addressing (pure NumPy in both packages), the checkpoint file
format (either package restores the other's files exactly), and resume
(k straight steps equal j steps, a save, a restore and k - j more).
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flextree_tpu import data as jdata
from flextree_tpu.models import transformer as jt
from flextree_tpu.parallel import train as jtrain
from flextree_tpu.utils import checkpoint as jckpt
from flextree_tpu_torch import data as tdata
from flextree_tpu_torch import trainer
from flextree_tpu_torch.convert import train_state_to_numpy
from flextree_tpu_torch.models.transformer import TransformerConfig
from flextree_tpu_torch.parallel import loop
from flextree_tpu_torch.parallel import train as ttrain
from flextree_tpu_torch.utils import checkpoint as tckpt

DIMS = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)


# ------------------------------------------------------------------- data


def test_synthetic_tokens_bitwise_equal_to_jax():
    for n, vocab, seed in ((1000, 64, 0), (5000, 8192, 3)):
        a = tdata.synthetic_tokens(n, vocab, seed=seed)
        b = jdata.synthetic_tokens(n, vocab, seed=seed)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_batch_at_bitwise_equal_to_jax_across_epochs():
    toks = jdata.synthetic_tokens(3000, 64, seed=1)
    mine = tdata.LMDataset(toks, batch=4, seq_len=32, seed=5)
    ref = jdata.LMDataset(toks, batch=4, seq_len=32, seed=5)
    assert mine.batches_per_epoch == ref.batches_per_epoch
    for step in (0, 1, ref.batches_per_epoch - 1, ref.batches_per_epoch,
                 3 * ref.batches_per_epoch + 2):
        for a, b in zip(mine.batch_at(step), ref.batch_at(step)):
            assert a.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="windows"):
        tdata.LMDataset(toks[:100], batch=8, seq_len=32)


def test_prefetch_preserves_order_and_raises():
    assert list(tdata.prefetch(iter(range(20)), size=3)) == list(range(20))

    def broken():
        yield 1
        yield 2
        raise KeyError("source failed")

    got = []
    with pytest.raises(KeyError, match="source failed"):
        for x in tdata.prefetch(broken(), size=2):
            got.append(x)
    assert got == [1, 2]


# ------------------------------------------------------------ checkpoints


@pytest.fixture(scope="module")
def jax_state():
    state = jtrain.init_train_state(jax.random.PRNGKey(0),
                                    jt.TransformerConfig(**DIMS))
    state["step"] = jnp.int32(7)
    return state


def _leaves(tree):
    return jax.tree.leaves(jax.tree.map(np.asarray, tree))


def test_jax_checkpoint_restores_bitwise_in_the_port(tmp_path, jax_state):
    jckpt.save_train_state(tmp_path, jax_state)
    got = tckpt.restore_train_state(tmp_path, device="cpu")
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 7
    for a, b in zip(_leaves(jax_state), _leaves(train_state_to_numpy(got))):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    # without a device the port returns NumPy, like the JAX package
    as_np = tckpt.restore_checkpoint(tckpt.latest_checkpoint(tmp_path))
    assert isinstance(as_np["params"]["embed"], np.ndarray)


def test_port_checkpoint_restores_bitwise_in_jax(tmp_path):
    state = ttrain.init_train_state(TransformerConfig(**DIMS),
                                    torch.Generator().manual_seed(3),
                                    device="cpu")
    state["step"] = torch.tensor(12, dtype=torch.int32)
    path = tckpt.save_train_state(tmp_path, state)
    assert os.path.basename(path) == "ckpt_00000012.npz"
    got = jckpt.restore_train_state(tmp_path)
    want = train_state_to_numpy(state)
    for a, b in zip(_leaves(want), _leaves(got)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert jckpt.verify_checkpoint(path) and tckpt.verify_checkpoint(path)


def test_bfloat16_leaves_cross_read_bitwise(tmp_path):
    x = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    t = torch.from_numpy(x).to(torch.bfloat16)
    tckpt.save_checkpoint(tmp_path / "a.npz", {"w": t, "n": [t[0]]})
    got = jckpt.restore_checkpoint(tmp_path / "a.npz")
    assert str(got["w"].dtype) == "bfloat16"
    np.testing.assert_array_equal(np.asarray(got["w"], np.float32),
                                  t.float().numpy())
    jckpt.save_checkpoint(tmp_path / "b.npz",
                          {"w": jnp.asarray(x, jnp.bfloat16)})
    back = tckpt.restore_checkpoint(tmp_path / "b.npz", device="cpu")
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"], t)


def test_rotation_and_corrupt_newest_falls_back(tmp_path):
    state = ttrain.init_train_state(TransformerConfig(**DIMS),
                                    torch.Generator().manual_seed(0),
                                    device="cpu")
    for step in (2, 4, 6, 8):
        state["step"] = torch.tensor(step, dtype=torch.int32)
        tckpt.save_train_state(tmp_path, state, max_to_keep=3)
    assert [s for s, _ in tckpt.list_checkpoints(tmp_path)] == [4, 6, 8]
    newest = tckpt.latest_checkpoint(tmp_path)
    with open(newest, "r+b") as f:  # truncate: the newest is corrupt
        f.truncate(os.path.getsize(newest) // 2)
    assert not tckpt.verify_checkpoint(newest)
    bad = []
    got = tckpt.restore_train_state(tmp_path, device="cpu",
                                    on_fallback=lambda p, e: bad.append(p))
    assert int(got["step"]) == 6 and bad == [newest]
    with pytest.raises(tckpt.CheckpointCorrupt):
        tckpt.restore_train_state(newest)
    with pytest.raises(FileNotFoundError):
        tckpt.restore_train_state(tmp_path / "empty")


def test_non_string_keys_fail_fast(tmp_path):
    with pytest.raises(TypeError, match="strings"):
        tckpt.save_checkpoint(tmp_path / "x.npz", {1: torch.zeros(2)})


# ---------------------------------------------------------------- the loop


def _setup(attn_impl="flash", seq_len=16):
    cfg = TransformerConfig(**DIMS, attn_impl=attn_impl)
    tc = ttrain.TrainConfig(lr=3e-3, grad_clip_norm=1.0)
    dataset = tdata.LMDataset(tdata.synthetic_tokens(4000, 64, seed=0),
                              batch=2, seq_len=seq_len, seed=0)
    state = ttrain.init_train_state(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    return state, ttrain.make_train_step(cfg, tc, device="cpu"), dataset


def _params(state):
    return [p.numpy() for p in ttrain.tree_leaves(state["params"])]


def test_fit_resume_is_bitwise(tmp_path):
    """k steps straight == j steps, save, restore, k - j steps."""
    state, step, data = _setup()
    straight = loop.fit(state, step, data, loop.FitConfig(num_steps=5,
                                                          log_every=1))
    assert straight.steps_run == 5 and len(straight.losses) == 5
    ckpt = str(tmp_path / "ck")
    first = loop.fit(state, step, data,
                     loop.FitConfig(num_steps=3, ckpt_dir=ckpt, ckpt_every=3))
    assert first.steps_run == 3
    resumed = loop.fit(state, step, data,
                       loop.FitConfig(num_steps=5, ckpt_dir=ckpt))
    assert resumed.resumed_from == 3 and resumed.steps_run == 2
    for a, b in zip(_params(straight.state), _params(resumed.state)):
        assert a.tobytes() == b.tobytes()
    report = json.loads((tmp_path / "ck" / "run_report.json").read_text())
    assert report["resumed_from"] == 3
    assert report["metrics"]["histograms"]["train.step_ms"]["count"] == 2
    again = loop.fit(state, step, data, loop.FitConfig(num_steps=5,
                                                       ckpt_dir=ckpt))
    assert again.steps_run == 0  # a finished run resumes to a no-op


def test_nan_guard_skips_then_diverges():
    state, step, data = _setup(attn_impl="reference")
    poisoned = {1}

    def flaky(st, tokens, targets):
        new, metrics = step(st, tokens, targets)
        if int(st["step"]) in poisoned:
            metrics = dict(metrics, loss=torch.tensor(float("nan")))
        return new, metrics

    res = loop.fit(state, flaky, data, loop.FitConfig(num_steps=4,
                                                      log_every=1))
    assert res.report.skipped_steps == [1] and res.report.anomalies == 1
    assert int(res.state["step"]) == 4 and res.steps_run == 4
    assert [s for s, _ in res.losses] == [1, 3, 4]
    poisoned.update({2, 3})
    with pytest.raises(loop.TrainingDiverged, match="no checkpoint"):
        loop.fit(state, flaky, data, loop.FitConfig(num_steps=6))


def test_nan_guard_rewinds_to_the_checkpoint_then_gives_up(tmp_path):
    state, step, data = _setup(attn_impl="reference")

    def broken_after_two(st, tokens, targets):
        new, metrics = step(st, tokens, targets)
        if int(st["step"]) >= 2:
            metrics = dict(metrics, loss=torch.tensor(float("inf")))
        return new, metrics

    ckpt = str(tmp_path / "ck")
    cfg = loop.FitConfig(num_steps=10, ckpt_dir=ckpt, ckpt_every=2,
                         max_bad_steps=2, max_rewinds=1)
    with pytest.raises(loop.TrainingDiverged, match="after 1 rewinds"):
        loop.fit(state, broken_after_two, data, cfg)
    report = json.loads((tmp_path / "ck" / "run_report.json").read_text())
    assert report["rewinds"] == 1 and report["anomalies"] == 4
    assert report["skipped_steps"] == [2, 3, 2, 3]


def test_fit_refuses_supervision_and_arbiter(tmp_path):
    """Supervision runs now (test_torch_supervision.py): an empty
    ``Supervision()`` leaves the run as it is without it, bitwise, with the
    same report; so does an armed feedback controller with no recorder
    (test_torch_feedback_fit.py), whose hook is one None check and whose
    probe timer never runs; and so do an arbiter lease whose grant never
    moves and a coordination handle with nothing to decide
    (test_torch_fit_lease.py runs both through real decisions)."""
    state, step, data = _setup()
    plain = loop.fit(state, step, data, loop.FitConfig(num_steps=2))
    sup = loop.fit(state, step, data, loop.FitConfig(num_steps=2),
                   supervision=loop.Supervision())
    assert all(torch.equal(a, b) for a, b in zip(
        ttrain.tree_leaves(plain.state), ttrain.tree_leaves(sup.state)))
    a, b = plain.report.to_payload(), sup.report.to_payload()
    assert a.pop("metrics")["counters"] == b.pop("metrics")["counters"]
    assert a == b
    from flextree_tpu_torch.planner.feedback import (
        FeedbackConfig,
        FeedbackController,
    )
    from flextree_tpu_torch.runtime import (
        CoordinationHandle,
        LeaseLedger,
        TrainLeaseClient,
    )

    def never(probes, n):
        raise AssertionError("probe timer ran with the recorder off")

    ctl = FeedbackController(8, 1 << 20, FeedbackConfig(every_k=1),
                             timer=never, device="cpu")
    armed = loop.fit(state, step, data, loop.FitConfig(num_steps=2),
                     supervision=loop.Supervision(feedback=ctl))
    assert all(torch.equal(a, b) for a, b in zip(
        ttrain.tree_leaves(plain.state), ttrain.tree_leaves(armed.state)))
    assert ctl.ticks == 0 and armed.report.feedback_refits == 0
    ledger = LeaseLedger(str(tmp_path / "hb"))
    ledger.publish(0, {"train": (0,), "serve": (1,)})
    handle = CoordinationHandle(str(tmp_path / "hb"), 0, membership=None)
    for kw in (dict(arbiter=TrainLeaseClient(ledger, initial_chips=(0,),
                                             poll_interval_s=0.0)),
               dict(supervision=loop.Supervision(coordination=handle))):
        quiet = loop.fit(state, step, data, loop.FitConfig(num_steps=2),
                         **kw)
        assert all(torch.equal(a, b) for a, b in zip(
            ttrain.tree_leaves(plain.state), ttrain.tree_leaves(quiet.state)))
        assert quiet.report.lease_epochs == quiet.report.control_epochs == []
    assert ledger.acked_epoch("train") == 0
    assert handle.applied == [] and handle.ledger.read_proposal() is None


# ------------------------------------------------------------- the CLI


_SMALL = ["--cpu", "--vocab", "64", "--d-model", "32", "--n-heads", "4",
          "--n-layers", "2", "--d-ff", "64", "--seq-len", "16", "--batch",
          "2", "--corpus-tokens", "4000"]


def test_trainer_cli_flash_on_cpu(tmp_path, capsys):
    out = {}
    ckpt = str(tmp_path / "ck")
    assert trainer.main(_SMALL + ["--attn-impl", "flash", "--steps", "3",
                                  "--log-every", "1", "--ckpt-dir", ckpt,
                                  "--schedule", "warmup_cosine",
                                  "--warmup-steps", "1", "--grad-clip", "1"],
                        out=out) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("dense: 3 steps on mesh {'dp': 1, 'sp': 1, "
                           "'tp': 1}; loss ")
    res = out["result"]
    assert res.steps_run == 3 and out["model_cfg"].attn_impl == "flash"
    assert out["train_cfg"].total_steps == 3
    assert tckpt.latest_checkpoint(ckpt).endswith("ckpt_00000003.npz")
    assert trainer.main(_SMALL + ["--attn-impl", "flash", "--steps", "4",
                                  "--ckpt-dir", ckpt]) == 0
    assert "(resumed from 3)" in capsys.readouterr().out


#: the supervision flags, lifted with the supervised training run
_LIFTED = ("--autotune", "--heartbeat-dir", "--step-timeout", "--obs-dir",
           "--feedback-every")


def _lifted_flag_runs(flags, tmp_path, capsys):
    """Two steps on 2 ranks with the flag: ``--autotune`` takes the dp
    axis' plan from the plan cache (measured on the first run), ``--heartbeat-dir``
    beats this rank and records the starting world, ``--step-timeout``
    runs each step on the watchdog, ``--obs-dir`` writes the flight
    record with a ``step_end`` event a step; the run is the plain run,
    bitwise, and its checkpoint resumes; ``--feedback-every 1`` with the
    flight recorder ticks the controller after step 1 (its probes on the
    2-rank dp axis, and its run-local calibration in the obs dir) and
    the run is the plain run, bitwise.  Each run leaves the caller's
    SIGTERM handler as it found it: the guard of ``--ckpt-dir``, and the
    flight record's chained dump without it."""
    import signal

    handler = signal.getsignal(signal.SIGTERM)
    flag = flags[0]
    value = {"--autotune": [], "--heartbeat-dir": [str(tmp_path / "hb")],
             "--step-timeout": ["60"],
             "--obs-dir": [str(tmp_path / "obs")],
             "--feedback-every": ["1", "--obs-dir",
                                  str(tmp_path / "obs")]}[flag]
    base = _SMALL + ["--mesh", "2,1,1", "--steps", "2", "--log-every", "1"]
    prev = os.environ.get("FLEXTREE_PLAN_CACHE")
    os.environ["FLEXTREE_PLAN_CACHE"] = str(tmp_path / "plans.json")
    try:
        plain: dict = {}
        assert trainer.main(base, out=plain) == 0
        out: dict = {}
        ckpt = str(tmp_path / "ck")
        assert trainer.main(base + [flag] + value + ["--ckpt-dir", ckpt],
                            out=out) == 0
        assert signal.getsignal(signal.SIGTERM) is handler
        if flag == "--obs-dir":  # no guard: the dump is chained on SIGTERM
            assert trainer.main(base + [flag, str(tmp_path / "obs2")]) == 0
            assert signal.getsignal(signal.SIGTERM) is handler
    finally:
        if prev is None:
            del os.environ["FLEXTREE_PLAN_CACHE"]
        else:
            os.environ["FLEXTREE_PLAN_CACHE"] = prev
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("dense: 2 steps on mesh {'dp': 2, 'sp': 1, "
                           "'tp': 1}; loss ")
    res = out["result"]
    if flag == "--autotune":
        tc = out["train_cfg"]
        assert not tc.autotune and set(tc.grad_topo) == {"dp"}
        doc = json.loads((tmp_path / "plans.json").read_text())
        (entry,) = doc["entries"].values()
        spec = ",".join(map(str, entry["widths"]))
        assert tc.grad_topo["dp"] == spec + (f"+{entry['lonely']}"
                                             if entry["lonely"] else "")
    elif flag == "--heartbeat-dir":
        assert os.path.exists(tmp_path / "hb" / "hb_00000.json")
        assert res.report.membership_epochs == [
            {"step": 0, "alive": 1, "configured": 1, "topo": None,
             "dead": []}]
    elif flag == "--obs-dir":
        events = [json.loads(ln) for ln in
                  (tmp_path / "obs" / "flight_00000.jsonl").read_text()
                  .splitlines()]
        assert sum(e["kind"] == "step_end" for e in events) == 2
        assert (tmp_path / "obs" / "metrics_00000.json").exists()
    elif flag == "--feedback-every":
        events = [json.loads(ln) for ln in
                  (tmp_path / "obs" / "flight_00000.jsonl").read_text()
                  .splitlines()]
        (tick,) = [e for e in events if e["kind"] == "feedback_tick"]
        assert tick["step"] == 1 and tick["probes"] == 4
        assert res.report.feedback_replans == 0
    assert all(torch.equal(a, b) for a, b in zip(
        ttrain.tree_leaves(plain["result"].state),
        ttrain.tree_leaves(res.state)))
    saved = tckpt.restore_train_state(ckpt, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        ttrain.tree_leaves(res.state), ttrain.tree_leaves(saved)))


@pytest.mark.parametrize("flags", [
    ["--model", "moe"], ["--model", "pipeline"], ["--codec", "int8"],
    ["--codec", "bf16"], ["--overlap"], ["--shard-optimizer"],
    ["--autotune"], ["--feedback-every", "2"], ["--heartbeat-dir", "hb"],
    ["--step-timeout", "5"], ["--obs-dir", "obs"], ["--mesh", "1,2,1"],
    ["--devices", "4"], ["--mesh", "2,1,2"],
])
def test_trainer_cli_refuses_unported_flags(flags, tmp_path, capsys):
    """The supervision flags and ``--feedback-every`` run now
    (:func:`_lifted_flag_runs`; the feedback flags in
    test_torch_feedback_fit.py); the
    pipeline and MoE models train now; a mesh
    with sp or tp above 1 trains now; the lossy codecs run now: 2 ranks train with error feedback, and the
    checkpoint holds the first rank's residual, which resumes; and so does
    ``--overlap``: 2 ranks train with readiness-ordered overlap, and the
    checkpoint, the live state bitwise, resumes; and so does
    ``--shard-optimizer``: 2 ranks train ZeRO-1, the checkpoint is the
    live state consolidated (the replicated layout), and it resumes."""
    if flags == ["--shard-optimizer"]:
        from flextree_tpu_torch.parallel.mesh import flat_mesh

        ckpt = str(tmp_path / "ck")
        out: dict = {}
        assert trainer.main(_SMALL + flags + ["--mesh", "2,1,1", "--steps",
                                              "3", "--log-every", "1",
                                              "--ckpt-dir", ckpt],
                            out=out) == 0
        res = out["result"]
        assert out["train_cfg"].shard_optimizer and res.steps_run == 3
        assert all(math.isfinite(loss) for _, loss in res.losses)
        assert res.state["mu_shard"]["embed"].numel() == \
            res.state["params"]["embed"].numel()  # both ranks' blocks
        saved = tckpt.restore_train_state(ckpt, "cpu")
        assert set(saved) == {"params", "mu", "nu", "step"}
        pack, _ = trainer.sharded_hooks(
            flat_mesh(2, "cpu", "dp"), out["model_cfg"],
            res.state["params"], out["train_cfg"])
        assert all(torch.equal(a, b) for a, b in zip(
            ttrain.tree_leaves(pack(res.state)),
            ttrain.tree_leaves(saved)))
        assert trainer.main(_SMALL + flags + ["--mesh", "2,1,1", "--steps",
                                              "4", "--ckpt-dir", ckpt]) == 0
        assert "(resumed from 3)" in capsys.readouterr().out
        return
    if flags == ["--overlap"]:
        ckpt = str(tmp_path / "ck")
        out: dict = {}
        assert trainer.main(_SMALL + flags + ["--mesh", "2,1,1", "--steps",
                                              "3", "--log-every", "1",
                                              "--ckpt-dir", ckpt],
                            out=out) == 0
        res = out["result"]
        assert out["train_cfg"].overlap and res.steps_run == 3
        assert all(math.isfinite(loss) for _, loss in res.losses)
        saved = tckpt.restore_train_state(ckpt, "cpu")
        assert all(torch.equal(a, b) for a, b in zip(
            ttrain.tree_leaves(res.state), ttrain.tree_leaves(saved)))
        assert trainer.main(_SMALL + flags + ["--mesh", "2,1,1", "--steps",
                                              "4", "--ckpt-dir", ckpt]) == 0
        assert "(resumed from 3)" in capsys.readouterr().out
        return
    if flags[0] == "--model":
        # the pipeline and MoE models train now
        # (test_torch_trainer_models.py): two steps on one rank, and the
        # last line names the model and its mesh; and so do their lossy
        # codecs (test_torch_wide*.py)
        out: dict = {}
        assert trainer.main(_SMALL + flags + ["--steps", "2"], out=out) == 0
        second = {"moe": "ep", "pipeline": "pp"}[flags[1]]
        mesh = dict(zip(("dp", second, "sp", "tp"), (1, 1, 1, 1)))
        last = capsys.readouterr().out.strip().splitlines()[-1]
        assert last.startswith(f"{flags[1]}: 2 steps on mesh {mesh}; loss ")
        assert all(math.isfinite(loss) for _, loss in out["result"].losses)
        out = {}
        assert trainer.main(_SMALL + flags + ["--codec", "int8", "--steps",
                                              "1"], out=out) == 0
        assert len(out["result"].state["ef"]) == 1
        return
    if flags[0] in ("--mesh", "--devices"):
        # sp or tp above 1 runs now (test_torch_trainer_mesh.py): two
        # steps, and the last line names the mesh
        out: dict = {}
        assert trainer.main(_SMALL + flags + ["--steps", "2"], out=out) == 0
        shape = {"1,2,1": (1, 2, 1), "4": (2, 2, 1), "2,1,2": (2, 1, 2)}[
            flags[1]]
        mesh = dict(zip(("dp", "sp", "tp"), shape))
        last = capsys.readouterr().out.strip().splitlines()[-1]
        assert last.startswith(f"dense: 2 steps on mesh {mesh}; loss ")
        assert all(math.isfinite(loss) for _, loss in out["result"].losses)
        return
    if flags[0] in _LIFTED:
        _lifted_flag_runs(flags, tmp_path, capsys)
        return
    assert flags[0] == "--codec"
    ckpt = str(tmp_path / "ck")
    out: dict = {}
    assert trainer.main(_SMALL + flags + ["--mesh", "2,1,1", "--steps", "3",
                                          "--log-every", "1", "--ckpt-dir",
                                          ckpt], out=out) == 0
    res = out["result"]
    assert out["train_cfg"].codec == flags[1] and res.steps_run == 3
    assert all(math.isfinite(loss) for _, loss in res.losses)
    ef = res.state["ef"]
    assert len(ef) == 2 and any(e.any() for e in ttrain.tree_leaves(ef[0]))
    saved = tckpt.restore_train_state(ckpt, "cpu")
    for a, b in zip(ttrain.tree_leaves(saved["ef"]),
                    ttrain.tree_leaves(ef[0])):
        assert torch.equal(a, b)
    assert trainer.main(_SMALL + flags + ["--mesh", "2,1,1", "--steps", "4",
                                          "--ckpt-dir", ckpt]) == 0
    assert "(resumed from 3)" in capsys.readouterr().out


def test_trainer_cli_data_parallel_on_cpu(tmp_path, capsys):
    """``--mesh 2,1,1`` trains on 2 in-process ranks (``--devices 2`` is the
    same shape) through the bucketed FlexTree sync: the closing line names
    the mesh, and the checkpoint is the replicated state, which resumes."""
    ckpt = str(tmp_path / "ck")
    out: dict = {}
    assert trainer.main(_SMALL + ["--mesh", "2,1,1", "--steps", "3",
                                  "--log-every", "1", "--ckpt-dir", ckpt,
                                  "--grad-topo", "1"], out=out) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("dense: 3 steps on mesh {'dp': 2, 'sp': 1, "
                           "'tp': 1}; loss ")
    saved = tckpt.restore_train_state(ckpt, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        ttrain.tree_leaves(out["result"].state), ttrain.tree_leaves(saved)))
    assert trainer.main(_SMALL + ["--devices", "2", "--steps", "4",
                                  "--ckpt-dir", ckpt]) == 0
    assert "on mesh {'dp': 2, 'sp': 1, 'tp': 1}" in capsys.readouterr().out


def test_trainer_help_names_the_missing_preemption_guard(capsys):
    """The guard is ported now: the help names it where
    ``--no-preempt-checkpoint`` turns it off."""
    with pytest.raises(SystemExit):
        trainer.main(["--help"])
    assert "preemption.py" in capsys.readouterr().out
