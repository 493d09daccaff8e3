"""The port's train step (``flextree_tpu_torch.parallel.train``) and its
model half (``cross_entropy_loss``, the flash forward) against the JAX
package's, on the same NumPy inputs and the same converted state.

Tolerances (float32 on the CPU): the loss, schedule, norm and AdamW
pieces within 1e-6 of their JAX twins (they differ only in the last bits
of pow/sqrt/cos and summation order); flash-forward logits within 1e-4
(a few layers of attention's 2e-5); three train steps from one state —
the loss within rtol 1e-5 and every parameter within atol 1e-5, the JAX
package's bar for flash against reference attention
(``tests/test_pallas_attention.py``).  JAX runs with ``jax_enable_x64``
under this suite's conftest, so every input is an explicit float32 /
int32 array.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flextree_tpu.models import transformer as jt
from flextree_tpu.parallel import train as jtrain
from flextree_tpu_torch.convert import (
    params_from_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from flextree_tpu_torch.models import transformer as tt
from flextree_tpu_torch.parallel import train as ttrain

OP_ATOL = 1e-6
LOGIT_ATOL = 1e-4
DIMS = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=atol,
                               rtol=rtol)


@pytest.fixture(scope="module")
def jax_state():
    return _np(jtrain.init_train_state(jax.random.PRNGKey(0),
                                       jt.TransformerConfig(**DIMS)))


def _tokens(seed, shape=(2, 16)):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, DIMS["vocab_size"], shape).astype(np.int32),
            rng.integers(0, DIMS["vocab_size"], shape).astype(np.int32))


def test_cross_entropy_loss_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
    targets = rng.integers(0, 11, (2, 5)).astype(np.int32)
    want, want_n = jt.cross_entropy_loss(jnp.asarray(logits),
                                         jnp.asarray(targets))
    got, got_n = tt.cross_entropy_loss(torch.from_numpy(logits),
                                       torch.from_numpy(targets))
    _close(got.item(), float(want), OP_ATOL * 10)
    assert got_n == float(want_n) == 10.0


@pytest.mark.parametrize("cfg", [
    dict(schedule="constant", lr=3e-3),
    dict(schedule="warmup_cosine", lr=1e-3, warmup_steps=5, total_steps=30,
         min_lr_frac=0.1),
    dict(schedule="warmup_cosine", lr=2e-3, warmup_steps=0, total_steps=7),
])
def test_schedule_lr_matches_jax(cfg):
    jc, tc = jtrain.TrainConfig(**cfg), ttrain.TrainConfig(**cfg)
    for step in (0, 1, 3, 5, 6, 17, 30, 45):
        want = float(jtrain.schedule_lr(jc, jnp.int32(step)))
        got = ttrain.schedule_lr(tc, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        _close(got.item(), want, OP_ATOL * 1e-2, rtol=1e-6)


def test_schedule_lr_refuses_bad_configs():
    with pytest.raises(ValueError, match="unknown schedule"):
        ttrain.schedule_lr(ttrain.TrainConfig(schedule="nope"), 1)
    with pytest.raises(ValueError, match="total_steps"):
        ttrain.schedule_lr(ttrain.TrainConfig(schedule="warmup_cosine"), 1)


def test_grad_norm_and_clip_match_jax(jax_state):
    rng = np.random.default_rng(1)
    grads = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        jax_state["params"])
    specs = jt.param_specs(jt.TransformerConfig(**DIMS), tp_axis=None)
    want_norm = jtrain.global_grad_norm(
        jax.tree.map(jnp.asarray, grads), specs)
    tgrads = params_from_numpy(grads, device="cpu")
    got_norm = ttrain.global_grad_norm(tgrads)
    _close(got_norm.item(), float(want_norm), 0, rtol=1e-6)
    clip = float(want_norm) / 3
    want = _np(jtrain.clip_by_global_norm(
        jax.tree.map(jnp.asarray, grads), want_norm, clip))
    got = train_state_to_numpy(
        ttrain.clip_by_global_norm(tgrads, got_norm, clip))
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        _close(b, a, OP_ATOL)
    metrics = {}
    same = ttrain.maybe_clip_grads(tgrads, ttrain.TrainConfig(), metrics)
    assert same is tgrads and not metrics
    ttrain.maybe_clip_grads(tgrads, ttrain.TrainConfig(grad_clip_norm=1.0),
                            metrics)
    _close(metrics["grad_norm"].item(), float(want_norm), 0, rtol=1e-6)
    with pytest.raises(ValueError, match="positive"):
        ttrain.maybe_clip_grads(tgrads,
                                ttrain.TrainConfig(grad_clip_norm=-1.0), {})


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_apply_matches_jax(jax_state, weight_decay):
    rng = np.random.default_rng(2)
    state = jax.tree.map(lambda a: np.array(a), jax_state)
    state["mu"] = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32) * 0.01,
        state["mu"])
    state["nu"] = jax.tree.map(
        lambda a: rng.random(a.shape).astype(np.float32) * 1e-4, state["nu"])
    state["step"] = np.int32(4)
    grads = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        state["params"])
    cfg = dict(lr=1e-3, weight_decay=weight_decay, schedule="warmup_cosine",
               warmup_steps=2, total_steps=10)
    want = _np(jtrain.adamw_apply(jax.tree.map(jnp.asarray, state),
                                  jax.tree.map(jnp.asarray, grads),
                                  jtrain.TrainConfig(**cfg)))
    got = ttrain.adamw_apply(train_state_from_numpy(state, device="cpu"),
                             params_from_numpy(grads, device="cpu"),
                             ttrain.TrainConfig(**cfg))
    got = train_state_to_numpy(got)
    assert int(got["step"]) == int(want["step"]) == 5
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        _close(b, a, OP_ATOL)


def test_flash_forward_matches_jax_flash_forward(jax_state):
    jcfg = jt.TransformerConfig(**DIMS, attn_impl="flash")
    tcfg = tt.TransformerConfig(**DIMS, attn_impl="flash")
    tokens, _ = _tokens(3, (2, 24))
    want = jt.forward(jax.tree.map(jnp.asarray, jax_state["params"]),
                      jnp.asarray(tokens), jcfg)
    params = params_from_numpy(jax_state["params"], device="cpu")
    got = tt.forward(params, torch.from_numpy(tokens).long(), tcfg)
    _close(got.numpy(), want, LOGIT_ATOL)
    ref = tt.forward(params, torch.from_numpy(tokens).long(),
                     dataclasses.replace(tcfg, attn_impl="reference"))
    _close(got.numpy(), ref.numpy(), LOGIT_ATOL)


def test_three_train_steps_match_jax(jax_state):
    """Three flash train steps with clipping and warmup-cosine from one
    state, carried over by ``train_state_from_numpy``, against JAX
    ``make_train_step`` on a (1, 1, 1) mesh."""
    kw = dict(lr=1e-3, grad_clip_norm=1.0, schedule="warmup_cosine",
              warmup_steps=1, total_steps=3)
    jcfg = jt.TransformerConfig(**DIMS, attn_impl="flash")
    tcfg = tt.TransformerConfig(**DIMS, attn_impl="flash")
    mesh = jtrain.make_mesh_3d(1, (1, 1, 1))
    jstep = jtrain.make_train_step(mesh, jcfg, jtrain.TrainConfig(**kw))
    tstep = ttrain.make_train_step(tcfg, ttrain.TrainConfig(**kw),
                                   device="cpu")
    jstate = jax.tree.map(jnp.asarray, jax_state)
    tstate = train_state_from_numpy(jax_state, device="cpu")
    for i in range(3):
        tokens, targets = _tokens(10 + i)
        jstate, jm = jstep(jstate, jnp.asarray(tokens), jnp.asarray(targets))
        tstate, tm = tstep(tstate, tokens, targets)
        _close(tm["loss"].item(), float(jm["loss"]), 0, rtol=1e-5)
        _close(tm["grad_norm"].item(), float(jm["grad_norm"]), 0, rtol=1e-5)
    want = _np(jstate)
    got = train_state_to_numpy(tstate)
    assert int(got["step"]) == int(want["step"]) == 3
    for a, b in zip(jax.tree.leaves(want["params"]),
                    jax.tree.leaves(got["params"])):
        _close(b, a, 1e-5)


def test_train_state_round_trips_and_refuses_other_layouts(jax_state):
    state = train_state_from_numpy(jax_state, device="cpu")
    assert state["step"].dtype == torch.int32 and state["step"].dim() == 0
    back = train_state_to_numpy(state)
    for a, b in zip(jax.tree.leaves(jax_state), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # a lossy codec's residual converts too; keys of no layout refuse
    lossy = train_state_from_numpy(dict(jax_state, ef=jax_state["mu"]),
                                   device="cpu")
    for a, b in zip(jax.tree.leaves(jax_state["mu"]),
                    jax.tree.leaves(train_state_to_numpy(lossy)["ef"])):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="ef"):
        train_state_from_numpy(dict(jax_state, master=jax_state["mu"]),
                               device="cpu")


@pytest.mark.parametrize("field", [dict(codec="int8"), dict(codec="bf16"),
                                   dict(overlap=True),
                                   dict(shard_optimizer=True),
                                   dict(autotune=True)])
def test_unported_train_config_features_refuse(field):
    """Every field runs now.  A lossy codec: its
    state carries a zero ``"ef"`` and a step on one rank (no sync, so the
    residual stays zero) gives the identity codec's update; so does
    ``overlap``: on one rank its segmented backward gives the plain step's
    update, bitwise; and so does ``shard_optimizer``: on one rank no leaf
    is sharded, its moments are whole in ``*_rep``, and the step and its
    moments are the plain step's, bitwise; and so does ``autotune``: on
    one rank it times nothing and the step is the plain one, bitwise."""
    cfg = ttrain.TrainConfig(**field)
    if "shard_optimizer" in field:
        model = tt.TransformerConfig(**DIMS)
        state = ttrain.init_train_state(model, torch.Generator().manual_seed(0),
                                        cfg, device="cpu")
        plain = ttrain.init_train_state(model, torch.Generator().manual_seed(0),
                                        device="cpu")
        assert set(state) == {"params", "step", "mu_shard", "mu_tail",
                              "mu_rep", "nu_shard", "nu_tail", "nu_rep"}
        assert all(t.numel() == 0 for k in ("mu_shard", "mu_tail",
                                            "nu_shard", "nu_tail")
                   for t in ttrain.tree_leaves(state[k]))
        tokens, targets = _tokens(1)
        new, m = ttrain.make_train_step(model, cfg, device="cpu")(
            state, tokens, targets)
        want, wm = ttrain.make_train_step(model, device="cpu")(
            plain, tokens, targets)
        assert torch.equal(m["loss"], wm["loss"])
        for key, ref in (("params", "params"), ("mu_rep", "mu"),
                         ("nu_rep", "nu"), ("step", "step")):
            for a, b in zip(ttrain.tree_leaves(new[key]),
                            ttrain.tree_leaves(want[ref])):
                assert torch.equal(a, b)
        return
    if "overlap" in field:
        model = tt.TransformerConfig(**DIMS)
        state = ttrain.init_train_state(model, torch.Generator().manual_seed(0),
                                        cfg, device="cpu")
        tokens, targets = _tokens(1)
        new, m = ttrain.make_train_step(model, cfg, device="cpu")(
            state, tokens, targets)
        want, wm = ttrain.make_train_step(model, device="cpu")(
            state, tokens, targets)
        assert torch.equal(m["loss"], wm["loss"])
        for a, b in zip(ttrain.tree_leaves(new), ttrain.tree_leaves(want)):
            assert torch.equal(a, b)
        return
    if "codec" in field:
        model = tt.TransformerConfig(**DIMS)
        state = ttrain.init_train_state(model, torch.Generator().manual_seed(0),
                                        cfg, device="cpu")
        plain = ttrain.init_train_state(model, torch.Generator().manual_seed(0),
                                        device="cpu")
        assert set(state) == set(plain) | {"ef"}
        assert not any(e.any() for e in ttrain.tree_leaves(state["ef"]))
        tokens, targets = _tokens(1)
        new, _ = ttrain.make_train_step(model, cfg, device="cpu")(
            state, tokens, targets)
        want, _ = ttrain.make_train_step(model, device="cpu")(
            plain, tokens, targets)
        for a, b in zip(ttrain.tree_leaves(new["params"]),
                        ttrain.tree_leaves(want["params"])):
            assert torch.equal(a, b)
        assert not any(e.any() for e in ttrain.tree_leaves(new["ef"]))
        loss_and_grads = ttrain.make_loss_and_grads(model, cfg, device="cpu")
        loss, grads, ef = loss_and_grads(state["params"], tokens, targets,
                                         state)
        assert not any(e.any() for e in ttrain.tree_leaves(ef))
        with pytest.raises(ValueError, match="needs the train state"):
            loss_and_grads(state["params"], tokens, targets)
        with pytest.raises(ValueError, match="unsupported codec"):
            ttrain.make_train_step(model, ttrain.TrainConfig(codec="fp4"),
                                   device="cpu")
        return
    # autotune runs now (test_torch_autotune.py): on one rank no axis
    # needs a sync, so nothing is timed, grad_topo resolves to no axis and
    # the state and the step are the plain ones, bitwise; on a 2-rank mesh
    # the dp axis' plan comes from the plan cache
    assert "autotune" in field
    model = tt.TransformerConfig(**DIMS)
    state = ttrain.init_train_state(model, torch.Generator().manual_seed(0),
                                    cfg, device="cpu")
    plain = ttrain.init_train_state(model, torch.Generator().manual_seed(0),
                                    device="cpu")
    assert set(state) == set(plain)
    assert ttrain.maybe_autotune_grad_topo(None, model, cfg) == \
        dataclasses.replace(cfg, grad_topo={}, autotune=False)
    tokens, targets = _tokens(1)
    new, m = ttrain.make_train_step(model, cfg, device="cpu")(
        state, tokens, targets)
    want, wm = ttrain.make_train_step(model, device="cpu")(
        plain, tokens, targets)
    assert torch.equal(m["loss"], wm["loss"])
    for a, b in zip(ttrain.tree_leaves(new), ttrain.tree_leaves(want)):
        assert torch.equal(a, b)


def test_sync_grads_is_the_identity_on_one_rank_only():
    """No comm (one rank): the grads themselves; a mesh of two ranks sums
    every leaf over them (per leaf and bucketed alike)."""
    from flextree_tpu_torch.parallel.mesh import flat_mesh

    grads = {"w": torch.ones(3)}
    assert ttrain.sync_grads(grads) is grads
    two = [{"w": torch.arange(3.0)}, {"w": torch.full((3,), 10.0)}]
    for bucket_bytes in (0, None):
        synced = ttrain.sync_grads(two, bucket_bytes=bucket_bytes,
                                   comm=flat_mesh(2, "cpu", "dp"))
        for tree in synced:
            assert torch.equal(tree["w"], torch.tensor([10.0, 11.0, 12.0]))


def test_model_refuses_parallel_axes_and_stray_attn_opts(jax_state):
    params = params_from_numpy(jax_state["params"], device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    cfg = tt.TransformerConfig(**DIMS)
    # an axis is a parallel.spmd.Axis of an in-process mesh (the sharded
    # forward is test_torch_model_parallel.py's); a bare JAX axis name
    # binds nothing in the port
    for axes in (dict(tp_axis="tp"), dict(sp_axis="sp")):
        with pytest.raises(TypeError, match="spmd.Axis"):
            tt.forward(params, tokens, cfg, **axes)
    with pytest.raises(ValueError, match="attn_opts"):
        tt.forward(params, tokens,
                   dataclasses.replace(cfg, attn_opts=(("block_q", 8),)))
    flash = dataclasses.replace(cfg, attn_impl="flash",
                                attn_opts=(("block_q", 8),
                                           ("variant", "kvgrid")))
    _close(tt.forward(params, tokens, flash).numpy(),
           tt.forward(params, tokens, cfg).numpy(), LOGIT_ATOL)


def test_layer_forward_is_attention_then_mlp(jax_state):
    params = params_from_numpy(jax_state["params"], device="cpu")
    cfg = tt.TransformerConfig(**DIMS)
    layer = params["layers"][0]
    x = torch.from_numpy(
        np.random.default_rng(4).standard_normal((2, 6, 32)).astype(np.float32))
    pos = torch.arange(6)
    want = jt.layer_forward(jax.tree.map(jnp.asarray,
                                         jax_state["params"]["layers"][0]),
                            jnp.asarray(x.numpy()), jnp.arange(6),
                            jt.TransformerConfig(**DIMS))
    got = tt.layer_forward(layer, x, pos, cfg)
    _close(got.numpy(), want, 1e-5)
