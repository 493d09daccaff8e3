"""The port's MoE train step (``flextree_tpu_torch/parallel/moe_train.py``)
against the JAX ``make_moe_train_step`` on the same 4-axis meshes.

Each case runs one step of both from the same JAX state (carried over by
``convert.train_state_from_numpy``) on the same batch: the ``loss``,
``aux`` and ``total`` metrics within rtol 1e-5 and the parameters within
atol 5e-5 (the JAX MoE tests' bar: the routed sums reorder by shard).
The capacity factor is high enough that no shard drops a token, the
condition under which the sharded step equals the one-rank step.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flextree_tpu_torch.convert import (
    train_state_from_numpy,
    train_state_to_numpy,
)
from flextree_tpu_torch.models import moe as tm
from flextree_tpu_torch.parallel import moe_train as tmt
from flextree_tpu_torch.parallel import train as ttrain

jm = importlib.import_module("flextree_tpu.models.moe")
jmt = importlib.import_module("flextree_tpu.parallel.moe_train")
jtrain = importlib.import_module("flextree_tpu.parallel.train")

DIMS = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            n_experts=8, top_k=2, capacity_factor=8.0)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=atol,
                               rtol=rtol)


def _batch(seed=1, b=8, t=32):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, DIMS["vocab_size"], (b, t)).astype(np.int32),
            rng.integers(0, DIMS["vocab_size"], (b, t)).astype(np.int32))


def _mesh(shape):
    return tmt.make_mesh_moe(shape=shape, device="cpu")


def _jax_step(shape, cfg_kw, tc_kw):
    """One JAX step on ``shape``: ``(state in, state out, metrics)`` as
    numpy."""
    cfg = jm.MoEConfig(**cfg_kw)
    state = jmt.init_moe_train_state(jax.random.PRNGKey(0), cfg)
    tokens, targets = _batch()
    new, m = jmt.make_moe_train_step(
        jmt.make_mesh_moe(int(np.prod(shape)), shape), cfg,
        jtrain.TrainConfig(**tc_kw))(state, jnp.asarray(tokens),
                                     jnp.asarray(targets))
    return _np(state), _np(new), {k: float(v) for k, v in m.items()}


def check_step(shape, cfg_kw, tc_kw, param_atol=5e-5):
    """One port step on ``shape`` against JAX's on the same mesh."""
    state, want, jm_ = _jax_step(shape, cfg_kw, tc_kw)
    tokens, targets = _batch()
    new, m = tmt.make_moe_train_step(
        tm.MoEConfig(**cfg_kw), ttrain.TrainConfig(**tc_kw),
        comm=_mesh(shape))(train_state_from_numpy(state, "cpu"), tokens,
                           targets)
    assert set(m) == set(jm_)
    for k, v in jm_.items():
        _close(m[k].item(), v, 0, rtol=1e-5)
    got = jax.tree.leaves(train_state_to_numpy(new)["params"])
    for a, b in zip(got, jax.tree.leaves(want["params"])):
        _close(a, b, param_atol)
    assert int(new["step"]) == 1
    return new, m


@pytest.mark.parametrize("shape", [(1, 4, 1, 2), (1, 2, 2, 2), (2, 2, 2, 1)])
def test_moe_step_matches_jax(shape):
    check_step(shape, {**DIMS, "router_aux_weight": 1e-2}, {})


def test_clipped_moe_step_matches_jax():
    """Expert-sharded leaves join the global norm once an expert shard;
    a large aux weight makes the router's aux gradient count (a step
    without the aux's 1/n_devices moves the norm)."""
    _, m = check_step((1, 2, 2, 2), {**DIMS, "router_aux_weight": 0.5},
                      dict(lr=1e-2, grad_clip_norm=0.05, eps=1e-3))
    assert m["grad_norm"].item() > 0.05


def test_moe_step_tree_grad_topo_and_one_rank():
    """A 2,2 gradient topology on dp x ep = (4, 2) against JAX's, and the
    port's one-rank step against JAX's one-device step."""
    check_step((4, 2, 1, 1), {**DIMS, "router_aux_weight": 0.0},
               dict(grad_topo="2,2"))
    check_step((1, 1, 1, 1), {**DIMS, "router_aux_weight": 1e-2}, {})


def test_moe_step_loss_falls_and_aux_reported():
    cfg = tm.MoEConfig(**{**DIMS, "router_aux_weight": 1e-2})
    state = tmt.init_moe_train_state(cfg, torch.Generator().manual_seed(0),
                                     device="cpu")
    step = tmt.make_moe_train_step(cfg, ttrain.TrainConfig(lr=3e-3),
                                   comm=_mesh((1, 4, 1, 2)))
    tokens, targets = _batch()
    losses, auxes = [], []
    for _ in range(4):
        state, m = step(state, tokens, targets)
        losses.append(m["loss"].item())
        auxes.append(m["aux"].item())
        _close(m["total"].item(), losses[-1] + 1e-2 * auxes[-1], 0,
               rtol=1e-6)
    assert losses[-1] < losses[0] - 0.1, losses
    assert all(a > 0 for a in auxes), auxes


def test_moe_step_validation_and_refusals():
    with pytest.raises(ValueError, match="divisible"):
        tmt.make_moe_train_step(tm.MoEConfig(**{**DIMS, "n_experts": 6}),
                                comm=_mesh((1, 4, 1, 2)))
    with pytest.raises(ValueError, match="top_k"):
        tmt.make_moe_train_step(tm.MoEConfig(**{**DIMS, "top_k": 9}),
                                comm=_mesh((1, 4, 1, 2)))
    with pytest.raises(ValueError, match="missing axis"):
        tmt.make_moe_train_step(tm.MoEConfig(**DIMS),
                                comm=ttrain.make_mesh_nd(
                                    None, (2, 2, 2), ttrain.AXIS_NAMES,
                                    "cpu"))
    # the options once refused here train a step on the mesh now
    mesh = _mesh((1, 2, 2, 2))
    tokens = np.random.default_rng(3).integers(
        0, DIMS["vocab_size"], (4, 16)).astype(np.int32)
    for kw in (dict(overlap=True), dict(shard_optimizer=True),
               dict(codec="int8"), dict(codec="bf16")):
        tc = ttrain.TrainConfig(**kw)
        cfg = tm.MoEConfig(**DIMS)
        state = tmt.init_moe_train_state(
            cfg, torch.Generator().manual_seed(0), tc, device="cpu",
            comm=mesh)
        new, m = tmt.make_moe_train_step(cfg, tc, comm=mesh)(
            state, tokens, tokens)
        assert np.isfinite(m["total"].item()) and int(new["step"]) == 1
        assert ("mu_shard" in new) == tc.shard_optimizer
        assert isinstance(new.get("ef"), list) == (tc.codec != "f32")


def test_factor_devices_moe_matches_jax():
    cfg = tm.MoEConfig(**DIMS)
    sspecs = tmt.moe_state_specs(cfg)
    assert sspecs["params"] == sspecs["mu"] == tm.moe_param_specs(cfg)
    for n in range(1, 33):
        assert tmt.factor_devices_moe(n) == jmt.factor_devices_moe(n)
    assert tmt.make_mesh_moe(8, device="cpu").shape == (1, 2, 2, 2)
