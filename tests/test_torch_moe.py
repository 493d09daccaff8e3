"""The port's MoE model (``flextree_tpu_torch/models/moe.py``) against the
JAX package's ``flextree_tpu/models/moe.py``.

- ``route_topk``: the dispatch bitwise JAX's on the same probabilities,
  with and without capacity overflow (the drop order of JAX's
  ``test_route_topk_capacity_drops_in_order``), the combine within 1e-7.
- ``moe_layer`` and ``moe_forward`` on one device within 2e-5 of JAX's
  (float32; reduction orders differ), with the JAX parameters carried
  over by ``convert.params_from_numpy``.
- The sharded forward on an in-process ``(ep,)`` mesh and on ``(ep, sp,
  tp)`` with ``moe_every=2``: every rank's logits within 2e-4 (JAX's own
  bar) of JAX's forward under ``shard_map`` on the same mesh, and its aux
  within the same of JAX's.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from flextree_tpu_torch.convert import params_from_numpy
from flextree_tpu_torch.models import moe as tm
from flextree_tpu_torch.parallel.mesh import Mesh
from flextree_tpu_torch.parallel.spmd import axis, shard_batch, shard_tree
from flextree_tpu_torch.utils.tree import tree_leaves

jm = importlib.import_module("flextree_tpu.models.moe")

DIMS = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            n_experts=8, top_k=2, capacity_factor=8.0, router_aux_weight=0.0)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=atol, rtol=0)


def _tokens(b=4, t=32, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, DIMS["vocab_size"], (b, t)).astype(np.int32)


def _probs(s, e, seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((s, e)).astype(np.float32)
    return np.array(jax.nn.softmax(jnp.asarray(logits), axis=-1))


# ----------------------------------------------------------------- routing


@pytest.mark.parametrize("s,e,k,cap", [(16, 4, 2, 16), (32, 8, 2, 3),
                                       (64, 8, 1, 5), (24, 6, 3, 7)])
def test_route_topk_dispatch_is_bitwise_jax(s, e, k, cap):
    probs = _probs(s, e, seed=s + e)
    jd, jc = jm.route_topk(jnp.asarray(probs), k, cap)
    d, c = tm.route_topk(torch.from_numpy(probs), k, cap)
    np.testing.assert_array_equal(d.numpy(), np.array(jd))
    _close(c.numpy(), np.array(jc), 1e-7)


def test_route_topk_capacity_drops_in_order():
    """Every token prefers expert 0; the first C keep their slots, the
    rest are dropped with no combine mass, as in JAX."""
    probs = np.tile(np.array([[0.9, 0.1]], np.float32), (8, 1))
    d, c = tm.route_topk(torch.from_numpy(probs), 1, 3)
    jd, jc = jm.route_topk(jnp.asarray(probs), 1, 3)
    np.testing.assert_array_equal(d[:, 0].sum(dim=1).numpy(),
                                  [1, 1, 1, 0, 0, 0, 0, 0])
    np.testing.assert_array_equal(d.numpy(), np.array(jd))
    np.testing.assert_array_equal(c.sum(dim=(1, 2)).numpy()[3:], np.zeros(5))
    _close(c.numpy(), np.array(jc), 1e-7)
    with pytest.raises(ValueError, match="top_k"):
        tm.route_topk(torch.from_numpy(probs), 3, 3)


def test_expert_capacity_and_specs_match_jax():
    for kw in (dict(capacity_factor=1.0), dict(capacity_factor=2.0),
               dict(n_experts=6, top_k=3, capacity_factor=1.25)):
        cfg_j = jm.MoEConfig(**{**DIMS, **kw})
        cfg_t = tm.MoEConfig(**{**DIMS, **kw})
        for n in (1, 7, 256, 2048):
            assert tm.expert_capacity(n, cfg_t) == jm.expert_capacity(n, cfg_j)
    cfg_j = jm.MoEConfig(**{**DIMS, "moe_every": 2, "n_layers": 4})
    cfg_t = tm.MoEConfig(**{**DIMS, "moe_every": 2, "n_layers": 4})
    want = jm.moe_param_specs(cfg_j, "tp", "ep")
    got = tm.moe_param_specs(cfg_t, "tp", "ep")
    for lw, lg in zip(want["layers"], got["layers"]):
        assert {k: tuple(v) for k, v in lw.items()} == lg
    assert [cfg_t.is_moe_layer(i) for i in range(4)] == \
        [cfg_j.is_moe_layer(i) for i in range(4)] == [False, True] * 2
    params = tm.init_moe_params(cfg_t, torch.Generator().manual_seed(0),
                                device="cpu")
    shapes = jax.eval_shape(lambda k: jm.init_moe_params(k, cfg_j),
                            jax.random.PRNGKey(0))
    assert [tuple(x.shape) for x in jax.tree.leaves(shapes)] == \
        [tuple(x.shape) for x in tree_leaves(params)]


# ------------------------------------------------------ one device


@pytest.fixture(scope="module")
def jax_params():
    return _np(jm.init_moe_params(jax.random.PRNGKey(0),
                                  jm.MoEConfig(**DIMS)))


def test_moe_layer_matches_jax(jax_params):
    cfg_j, cfg_t = jm.MoEConfig(**DIMS), tm.MoEConfig(**DIMS)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 16, DIMS["d_model"])).astype(np.float32)
    layer = jax.tree.map(jnp.asarray, jax_params["layers"][0])
    want, want_aux = jm.moe_layer(layer, jnp.asarray(x), cfg_j)
    params = params_from_numpy(jax_params, device="cpu")
    got, aux = tm.moe_layer(params["layers"][0], torch.from_numpy(x), cfg_t)
    _close(got.numpy(), np.array(want), 2e-5)
    _close(aux.item(), float(want_aux), 2e-5)


@pytest.mark.parametrize("capacity_factor", [8.0, 0.5])
def test_moe_forward_matches_jax(jax_params, capacity_factor):
    """One device, without and with dropped tokens."""
    kw = {**DIMS, "capacity_factor": capacity_factor}
    tokens = _tokens()
    want, want_aux = jm.moe_forward(jax.tree.map(jnp.asarray, jax_params),
                                    jnp.asarray(tokens), jm.MoEConfig(**kw))
    got, aux = tm.moe_forward(params_from_numpy(jax_params, device="cpu"),
                              torch.from_numpy(tokens).long(),
                              tm.MoEConfig(**kw))
    _close(got.numpy(), np.array(want), 2e-5)
    _close(aux.item(), float(want_aux), 2e-5)


# ------------------------------------------------------ sharded forward


def _sharded(cfg_kw, shape, names, data_spec, jax_seed=0):
    """JAX's sharded forward and the port's on the same mesh: ``(want
    logits, want aux by rank, got logits, got aux, rank blocks)``."""
    cfg_j, cfg_t = jm.MoEConfig(**cfg_kw), tm.MoEConfig(**cfg_kw)
    params = _np(jm.init_moe_params(jax.random.PRNGKey(jax_seed), cfg_j))
    tokens = _tokens(b=4)
    axes = dict(zip(("tp_axis", "sp_axis", "ep_axis"),
                    [n if n in names else None for n in ("tp", "sp", "ep")]))
    mesh_j = jax.make_mesh(shape, names)
    jspecs = jm.moe_param_specs(cfg_j, axes["tp_axis"], axes["ep_axis"])
    logits, aux = jax.jit(jax.shard_map(
        lambda p, tok: (lambda lg, a: (lg, a[None]))(
            *jm.moe_forward(p, tok, cfg_j, **axes)),
        mesh=mesh_j, in_specs=(jspecs, P(*data_spec)),
        out_specs=(P(*data_spec), P(names)), check_vma=False))(
            jax.tree.map(jnp.asarray, params), jnp.asarray(tokens))
    mesh = Mesh(("cpu",) * int(np.prod(shape)), names, shape)
    ranks = shard_tree(params_from_numpy(params, device="cpu"),
                       tm.moe_param_specs(cfg_t, axes["tp_axis"],
                                          axes["ep_axis"]), mesh)
    toks = [x.long() for x in shard_batch(torch.from_numpy(tokens),
                                          data_spec, mesh)]
    got, got_aux = tm.moe_forward(
        ranks, toks, cfg_t,
        **{k: v and axis(mesh, v) for k, v in axes.items()})
    blocks = shard_batch(torch.arange(tokens.size).reshape(tokens.shape),
                         data_spec, mesh)
    return np.array(logits), np.array(aux), got, got_aux, blocks


def _check_sharded(want, want_aux, got, got_aux, blocks):
    flat = want.reshape(-1, want.shape[-1])
    for lg, a, ja, blk in zip(got, got_aux, want_aux, blocks):
        rows = blk.numpy().reshape(-1)
        _close(lg.detach().numpy().reshape(len(rows), -1), flat[rows], 2e-4)
        _close(a.item(), float(ja), 2e-4)


def test_moe_forward_ep_mesh_matches_jax():
    want, want_aux, got, got_aux, blocks = _sharded(
        DIMS, (4,), ("ep",), ("ep", None))
    _check_sharded(want, want_aux, got, got_aux, blocks)


def test_moe_forward_full_mesh_matches_jax():
    """ep x sp x tp at once, dense layers interleaved (moe_every=2)."""
    kw = {**DIMS, "n_layers": 4, "moe_every": 2, "n_heads": 8}
    want, want_aux, got, got_aux, blocks = _sharded(
        kw, (2, 2, 2), ("ep", "sp", "tp"), ("ep", "sp"))
    _check_sharded(want, want_aux, got, got_aux, blocks)


def test_moe_layer_refuses_indivisible_experts_and_bad_lists():
    cfg = tm.MoEConfig(**{**DIMS, "n_experts": 6})
    params = tm.init_moe_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    mesh = Mesh(("cpu",) * 4, ("ep",), (4,))
    x = [torch.zeros((1, 4, DIMS["d_model"]))] * 4
    with pytest.raises(ValueError, match="divisible"):
        tm.moe_layer([params["layers"][0]] * 4, x, cfg,
                     ep_axis=axis(mesh, "ep"))
    with pytest.raises(ValueError, match="per-rank lists"):
        tm.moe_layer(params["layers"][0], x, cfg)
    with pytest.raises(ValueError, match="one entry a rank"):
        tm.moe_layer([params["layers"][0]] * 2, x[:2], cfg,
                     ep_axis=axis(mesh, "ep"))
    with pytest.raises(TypeError, match="spmd.Axis"):
        tm.moe_layer(params["layers"][0], x[0], cfg, ep_axis="ep")
