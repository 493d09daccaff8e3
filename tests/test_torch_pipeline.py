"""The port's GPipe train step (``flextree_tpu_torch/parallel/pipeline.py``)
against the JAX ``make_pipeline_train_step`` on the same 4-axis meshes.

Each case runs one step of both from the same JAX state in the stacked
layout (carried over by ``convert.train_state_from_numpy``) on the same
batch: the loss (and, clipped, the norm) within rtol 1e-5 and the
parameters within atol 1e-5 (the JAX pipeline tests' bars).  Beside it:
the stacked layout and its specs, pp=1 as gradient accumulation against
the port's one-rank dense step, a 2,2 gradient topology, the schedule's
refusals and the options that train on the mesh (their JAX comparison is
``test_torch_wide_jax_pipeline.py``), and ``factor_devices_4d`` against
JAX's.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flextree_tpu_torch.convert import (
    params_from_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from flextree_tpu_torch.models import transformer as tt
from flextree_tpu_torch.parallel import pipeline as tpp
from flextree_tpu_torch.parallel import train as ttrain

jt = importlib.import_module("flextree_tpu.models.transformer")
jpp = importlib.import_module("flextree_tpu.parallel.pipeline")
jtrain = importlib.import_module("flextree_tpu.parallel.train")

DIMS = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=4, d_ff=64)


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
    return tpp.make_mesh_4d(shape=shape, device="cpu")


@pytest.fixture(scope="module")
def jax_state():
    return _np(jpp.init_pipeline_train_state(jax.random.PRNGKey(0),
                                             jt.TransformerConfig(**DIMS)))


def check_step(jax_state, shape, microbatches, tc_kw, sp_impl="ring"):
    """One port step on ``shape`` against JAX's on the same mesh."""
    tokens, targets = _batch()
    jnew, jm = jpp.make_pipeline_train_step(
        jpp.make_mesh_4d(int(np.prod(shape)), shape),
        jt.TransformerConfig(**DIMS, sp_impl=sp_impl),
        jtrain.TrainConfig(**tc_kw), n_microbatches=microbatches)(
            jax.tree.map(jnp.asarray, jax_state), jnp.asarray(tokens),
            jnp.asarray(targets))
    new, m = tpp.make_pipeline_train_step(
        tt.TransformerConfig(**DIMS, sp_impl=sp_impl),
        ttrain.TrainConfig(**tc_kw), microbatches, comm=_mesh(shape))(
            train_state_from_numpy(jax_state, "cpu"), tokens, targets)
    assert set(m) == set(jm)
    for k in jm:
        _close(m[k].item(), float(jm[k]), 0, rtol=1e-5)
    got = jax.tree.leaves(train_state_to_numpy(new)["params"])
    for a, b in zip(got, jax.tree.leaves(_np(jnew["params"]))):
        _close(a, b, 1e-5)
    assert int(new["step"]) == 1
    return new, m


@pytest.mark.parametrize("shape,microbatches,sp_impl", [
    ((1, 2, 2, 2), 2, "ring"),
    ((2, 4, 1, 1), 4, "ring"),
    ((1, 2, 2, 2), 4, "zigzag"),
])
def test_pipeline_step_matches_jax(jax_state, shape, microbatches, sp_impl):
    check_step(jax_state, shape, microbatches, {}, sp_impl)


def test_clipped_pipeline_step_matches_jax(jax_state):
    """Each rank holds its stage's slice: the norm sums over pp and tp
    exactly once."""
    _, m = check_step(jax_state, (1, 2, 2, 2), 2,
                      dict(lr=1e-2, grad_clip_norm=0.05))
    assert m["grad_norm"].item() > 0.05


def test_pipeline_tree_grad_topo_matches_jax(jax_state):
    check_step(jax_state, (4, 2, 1, 1), 2, dict(grad_topo="2,2"))


def test_pp1_is_gradient_accumulation(jax_state):
    """pp=1 over dp=8, one microbatch: the port's one-rank dense step on
    the unstacked parameters."""
    tokens, targets = _batch()
    state = train_state_from_numpy(jax_state, "cpu")
    new, m = tpp.make_pipeline_train_step(
        tt.TransformerConfig(**DIMS), ttrain.TrainConfig(), 1,
        comm=_mesh((8, 1, 1, 1)))(state, tokens, targets)
    dense = {k: tpp.unstack_layer_params(state[k])
             for k in ("params", "mu", "nu")}
    one, m1 = ttrain.make_train_step(tt.TransformerConfig(**DIMS),
                                     device="cpu")(
        dict(dense, step=state["step"]), tokens, targets)
    _close(m["loss"].item(), m1["loss"].item(), 0, rtol=1e-5)
    for a, b in zip(
            ttrain.tree_leaves(tpp.unstack_layer_params(new["params"])),
            ttrain.tree_leaves(one["params"])):
        _close(a.numpy(), b.numpy(), 1e-5)


def test_stacked_layout_and_specs_match_jax(jax_state):
    params = params_from_numpy(jax_state["params"], device="cpu")
    assert isinstance(params["layers"], dict)
    back = tpp.stack_layer_params(tpp.unstack_layer_params(params))
    assert all(torch.equal(a, b) for a, b in zip(
        ttrain.tree_leaves(back), ttrain.tree_leaves(params)))
    jparams = jt.init_params(jax.random.PRNGKey(0),
                             jt.TransformerConfig(**DIMS))
    stacked = tpp.stack_layer_params(params_from_numpy(_np(jparams),
                                                       device="cpu"))
    for a, b in zip(ttrain.tree_leaves(stacked),
                    jax.tree.leaves(jax_state["params"])):
        np.testing.assert_array_equal(a.numpy(), b)
    want = jpp.pipeline_param_specs(jt.TransformerConfig(**DIMS))
    got = tpp.pipeline_param_specs(tt.TransformerConfig(**DIMS))
    assert {k: tuple(v) for k, v in want["layers"].items()} == got["layers"]
    sspecs = tpp.pipeline_state_specs(tt.TransformerConfig(**DIMS))
    assert sspecs["params"] == sspecs["mu"] == sspecs["nu"] == got
    with pytest.raises(ValueError, match="unexpected keys"):
        params_from_numpy({**jax_state["params"], "layers": {
            k: v for k, v in jax_state["params"]["layers"].items()
            if k != "w2"}}, device="cpu")


def test_pipeline_refusals():
    cfg = tt.TransformerConfig(**DIMS)
    with pytest.raises(ValueError, match="divisible"):
        tpp.make_pipeline_train_step(tt.TransformerConfig(
            **{**DIMS, "n_layers": 3}), comm=_mesh((4, 2, 1, 1)))
    state = tpp.init_pipeline_train_state(
        cfg, torch.Generator().manual_seed(0), device="cpu")
    step = tpp.make_pipeline_train_step(cfg, n_microbatches=4,
                                        comm=_mesh((1, 2, 2, 2)))
    with pytest.raises(ValueError, match="microbatch"):
        step(state, *_batch(b=6))
    # the options once refused here train a step on the mesh now
    mesh = _mesh((1, 2, 2, 2))
    for kw in (dict(overlap=True), dict(shard_optimizer=True),
               dict(codec="int8"), dict(codec="bf16")):
        tc = ttrain.TrainConfig(**kw)
        state = tpp.init_pipeline_train_state(
            cfg, torch.Generator().manual_seed(0), tc, device="cpu",
            comm=mesh)
        new, m = tpp.make_pipeline_train_step(cfg, tc, comm=mesh)(
            state, *_batch())
        assert np.isfinite(m["loss"].item()) and int(new["step"]) == 1
        assert ("mu_shard" in new) == tc.shard_optimizer
        assert isinstance(new.get("ef"), list) == (tc.codec != "f32")


def test_factor_devices_4d_matches_jax():
    for n in range(1, 33):
        assert tpp.factor_devices_4d(n) == jpp.factor_devices_4d(n)
    assert tpp.factor_devices_4d(16) == (2, 2, 2, 2)
    assert _mesh(None).shape == (1, 1, 1, 1)
