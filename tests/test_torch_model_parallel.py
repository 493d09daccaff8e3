"""The port's dense model and train step over a (dp, sp, tp) mesh of
in-process ranks against the JAX package's under ``shard_map``.

- ``forward`` on (1, 2, 2) and (2, 2, 2), each sp_impl: every rank's
  logits against JAX's sharded forward and the port's single-rank forward,
  within 2e-5 (float32; reduction orders differ).
- :func:`check_step`, which ``test_torch_model_parallel_steps.py`` and
  ``test_torch_model_parallel_shapes.py`` run on each mesh shape and
  sp_impl: one train step, clipping on, against JAX ``make_train_step``
  on the same mesh: the loss and the clip norm within rtol 1e-5, the
  synced gradient (``make_loss_and_grads``) against JAX's gradient of the
  global mean loss within 1e-5, and the parameters within 1e-5 except
  where the step-1 gradient is below 1e-6, which AdamW's first update
  ``lr g / (|g| + eps)`` makes ill-conditioned: those within 2 lr
  (``tests/test_torch_overlap.py``'s rule for one step); and against the
  port's one-rank step the same way.
- ``global_grad_norm`` over every rank's slices against JAX's per-axis
  norm within rtol 1e-6.
- The bucketed sync on (2, 2, 2), each leaf over its replication axes, is
  bitwise the per-leaf sync, and every rank of a group holds the same bits.
- A checkpoint written at (2, 2, 2) resumes at (1, 1, 1) and one written
  at (1, 1, 1) resumes at (2, 2, 2): the state is one layout at every
  shape.
- The combine's backward and the sequence offset each have a test that
  fails without them: the step's gradients, and the sharded forward.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from flextree_tpu_torch import trainer
from flextree_tpu_torch.convert import (
    params_from_numpy,
    train_state_from_numpy,
    train_state_to_numpy,
)
from flextree_tpu_torch.models import transformer as tt
from flextree_tpu_torch.parallel import train as ttrain
from flextree_tpu_torch.parallel.mesh import Mesh
from flextree_tpu_torch.parallel.spmd import axis, gather_tree, shard_tree
from flextree_tpu_torch.utils import checkpoint as tckpt

jt = importlib.import_module("flextree_tpu.models.transformer")
jtrain = importlib.import_module("flextree_tpu.parallel.train")

DIMS = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
KW = dict(lr=1e-3, grad_clip_norm=0.5)
IMPLS = ("ring", "zigzag", "ulysses")


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=atol,
                               rtol=rtol)


def _batch(seed, shape=(4, 16)):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, DIMS["vocab_size"], shape).astype(np.int32),
            rng.integers(0, DIMS["vocab_size"], shape).astype(np.int32))


def _mesh(shape):
    return Mesh(("cpu",) * int(np.prod(shape)), ttrain.AXIS_NAMES, shape)


@pytest.fixture(scope="module")
def jax_state():
    return _np(jtrain.init_train_state(jax.random.PRNGKey(0),
                                       jt.TransformerConfig(**DIMS)))


def jax_grads(params, tokens, targets):
    """The JAX model's gradient of the global mean token loss on one
    device: what its sharded step's synced gradient computes."""
    cfg = jt.TransformerConfig(**DIMS)

    def loss(p):
        total, _ = jt.cross_entropy_loss(jt.forward(p, tokens, cfg), targets)
        return total / tokens.size

    return jax.tree.leaves(_np(jax.grad(loss)(jax.tree.map(jnp.asarray,
                                                           params))))


def check_step(jax_state, shape, impl, seed=0):
    """One clipped step of the port on ``shape`` against JAX's on the same
    mesh and against the port's one-rank step (see the module
    docstring)."""
    tokens, targets = _batch(seed)
    cfg_t = tt.TransformerConfig(**DIMS, sp_impl=impl)
    tc = ttrain.TrainConfig(**KW)
    n = int(np.prod(shape))
    jstep = jtrain.make_train_step(jtrain.make_mesh_3d(n, shape),
                                   jt.TransformerConfig(**DIMS, sp_impl=impl),
                                   jtrain.TrainConfig(**KW))
    jnew, jm = jstep(jax.tree.map(jnp.asarray, jax_state),
                     jnp.asarray(tokens), jnp.asarray(targets))
    state = train_state_from_numpy(jax_state, device="cpu")
    new, m = ttrain.make_train_step(cfg_t, tc, comm=_mesh(shape))(
        state, tokens, targets)
    one, m1 = ttrain.make_train_step(cfg_t, tc, device="cpu")(
        state, tokens, targets)
    for got in (m, m1):
        _close(got["loss"].item(), float(jm["loss"]), 0, rtol=1e-5)
        _close(got["grad_norm"].item(), float(jm["grad_norm"]), 0, rtol=1e-5)
    g1 = jax_grads(jax_state["params"], tokens, targets)
    _, grads, _ = ttrain.make_loss_and_grads(cfg_t, tc, comm=_mesh(shape))(
        state["params"], tokens, targets)
    for a, b in zip(ttrain.tree_leaves(grads), g1):
        _close(a.numpy(), b, 1e-5)
    want = jax.tree.leaves(_np(jnew["params"]))
    for got in (new, one):
        leaves = jax.tree.leaves(train_state_to_numpy(got)["params"])
        for a, b, g in zip(leaves, want, g1):
            tiny = np.abs(g) < 1e-6
            _close(a[~tiny], b[~tiny], 1e-5)
            _close(a[tiny], b[tiny], 2 * KW["lr"])
    assert int(new["step"]) == 1


# ------------------------------------------------------------ forward


@pytest.mark.parametrize("shape", [(1, 2, 2), (2, 2, 2)])
@pytest.mark.parametrize("impl", IMPLS)
def test_sharded_forward_matches_jax_and_one_rank(jax_state, impl, shape):
    cfg_j = jt.TransformerConfig(**DIMS, sp_impl=impl)
    cfg_t = tt.TransformerConfig(**DIMS, sp_impl=impl)
    dp, sp, tp = shape
    tokens, _ = _batch(1)
    mesh_j = jtrain.make_mesh_3d(int(np.prod(shape)), shape)
    want = np.array(jax.jit(jax.shard_map(
        lambda p, tok: jt.forward(p, tok, cfg_j, tp_axis="tp",
                                  sp_axis="sp"),
        mesh=mesh_j, in_specs=(jt.param_specs(cfg_j, "tp"), P("dp", "sp")),
        out_specs=P("dp", "sp"), check_vma=False))(
            jax.tree.map(jnp.asarray, jax_state["params"]),
            jnp.asarray(tokens)))
    params = params_from_numpy(jax_state["params"], device="cpu")
    mesh = _mesh(shape)
    ranks = shard_tree(params, tt.param_specs(cfg_t), mesh)
    d_idx, s_idx = axis(mesh, "dp").index, axis(mesh, "sp").index
    rows, cols = tokens.shape[0] // dp, tokens.shape[1] // sp
    toks = [torch.from_numpy(tokens[d * rows:(d + 1) * rows,
                                    s * cols:(s + 1) * cols].copy()).long()
            for d, s in zip(d_idx, s_idx)]
    logits = tt.forward(ranks, toks, cfg_t, tp_axis=axis(mesh, "tp"),
                        sp_axis=axis(mesh, "sp"))
    one = tt.forward(params, torch.from_numpy(tokens).long(), cfg_t)
    for r, lg in enumerate(logits):
        d, s = d_idx[r], s_idx[r]
        block = (slice(d * rows, (d + 1) * rows), slice(s * cols,
                                                         (s + 1) * cols))
        _close(lg.detach().numpy(), want[block], 2e-5)
        _close(lg.detach().numpy(), one[block].detach().numpy(), 2e-5)


def test_axes_are_handles_and_per_rank_lists(jax_state):
    params = params_from_numpy(jax_state["params"], device="cpu")
    cfg = tt.TransformerConfig(**DIMS)
    tokens = torch.zeros((1, 4), dtype=torch.long)
    for axes in (dict(tp_axis="tp"), dict(sp_axis="sp")):
        with pytest.raises(TypeError, match="spmd.Axis"):
            tt.forward(params, tokens, cfg, **axes)
    mesh = _mesh((1, 2, 1))
    with pytest.raises(ValueError, match="one entry a rank"):
        tt.forward(params, tokens, cfg, sp_axis=axis(mesh, "sp"))
    with pytest.raises(ValueError, match="sp_impl"):
        tt.forward([params] * 2, [tokens] * 2,
                   dataclasses.replace(cfg, sp_impl="striped"),
                   sp_axis=axis(mesh, "sp"))
    flash = dataclasses.replace(cfg, attn_impl="flash",
                                attn_opts=(("block_q", 8),))
    for impl in ("ring", "zigzag"):
        with pytest.raises(ValueError, match="attn_opts"):
            tt.forward([params] * 2, [tokens] * 2,
                       dataclasses.replace(flash, sp_impl=impl),
                       sp_axis=axis(mesh, "sp"))
    out = tt.forward([params] * 2, [tokens] * 2,
                     dataclasses.replace(flash, sp_impl="ulysses"),
                     sp_axis=axis(mesh, "sp"))
    assert len(out) == 2 and out[0].shape == (1, 4, DIMS["vocab_size"])
    pos = tt.global_positions(4, axis(mesh, "sp"))
    assert [p.tolist() for p in pos] == [[0, 1, 2, 3], [4, 5, 6, 7]]


# --------------------------------------------------------- the step


def test_global_grad_norm_matches_jax(jax_state):
    """The norm over every rank's synced slices, by axis group, against
    the JAX norm under ``shard_map`` on (2, 2, 2)."""
    cfg = tt.TransformerConfig(**DIMS)
    rng = np.random.default_rng(5)
    grads = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        jax_state["params"])
    jspecs = jt.param_specs(jt.TransformerConfig(**DIMS), "tp")
    want = jax.jit(jax.shard_map(
        lambda g: jtrain.global_grad_norm(g, jspecs),
        mesh=jtrain.make_mesh_3d(8, (2, 2, 2)), in_specs=(jspecs,),
        out_specs=P(), check_vma=False))(jax.tree.map(jnp.asarray, grads))
    full = params_from_numpy(grads, device="cpu")
    mesh = _mesh((2, 2, 2))
    pspecs = tt.param_specs(cfg)
    shards = shard_tree(full, pspecs, mesh)
    got = ttrain.global_grad_norm(shards, pspecs, comm=mesh)
    _close(got.item(), float(want), 0, rtol=1e-6)
    _close(got.item(), ttrain.global_grad_norm(full).item(), 0, rtol=1e-6)
    metrics = {}
    clipped = ttrain.maybe_clip_grads(shards, ttrain.TrainConfig(
        grad_clip_norm=1.0), metrics, pspecs, mesh)
    assert metrics["grad_norm"] is not None
    back = gather_tree(clipped, pspecs, mesh)
    _close(ttrain.global_grad_norm(back).item(), 1.0, 0, rtol=1e-5)


def test_bucketed_sync_on_three_axes_is_the_per_leaf_sync():
    """Each leaf summed over its replication axes, one walk an axis over
    each group: the bucketed sync bitwise the per-leaf sync, every rank of
    a group the same bits, a tp slice summed over dp and sp only."""
    cfg = tt.TransformerConfig(**DIMS)
    pspecs = tt.param_specs(cfg)
    mesh = _mesh((2, 2, 2))
    full = tt.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    gen = torch.Generator().manual_seed(1)
    trees = [ttrain.tree_map(lambda p: torch.randn(p.shape, generator=gen), t)
             for t in shard_tree(full, pspecs, mesh)]
    topos = ttrain.resolve_axis_topos(mesh, ttrain.AXIS_NAMES, None)
    per_leaf = ttrain.sync_grads(trees, pspecs, ttrain.AXIS_NAMES, topos,
                                 bucket_bytes=0, comm=mesh)
    for cap in (None, 1 << 10):
        fused = ttrain.sync_grads(trees, pspecs, ttrain.AXIS_NAMES, topos,
                                  bucket_bytes=cap, comm=mesh)
        for a, b in zip(fused, per_leaf):
            assert all(torch.equal(x, y) for x, y in zip(
                ttrain.tree_leaves(a), ttrain.tree_leaves(b)))
    tp = axis(mesh, "tp")
    for r in range(8):
        w = per_leaf[r]["layers"][0]["wq"]
        mates = [q for q in range(8) if tp.index[q] == tp.index[r]]
        assert all(torch.equal(per_leaf[q]["layers"][0]["wq"], w)
                   for q in mates)
        want = sum(trees[q]["layers"][0]["wq"] for q in mates)
        _close(w.numpy(), want.numpy(), 1e-5)
        assert torch.equal(per_leaf[r]["ln_f"], per_leaf[0]["ln_f"])


_SMALL = ["--cpu", "--vocab", "64", "--d-model", "32", "--n-heads", "4",
          "--n-layers", "2", "--d-ff", "64", "--seq-len", "16", "--batch",
          "4", "--corpus-tokens", "4000", "--log-every", "1"]


@pytest.mark.parametrize("first,then", [("2,2,2", "1,1,1"),
                                        ("1,1,1", "2,2,2")])
def test_checkpoint_resumes_across_mesh_shapes(tmp_path, first, then):
    """Two steps on one shape with a checkpoint, a third on the other from
    it: the state a third step from the file on the second shape reaches
    is within float32 reduction order of the first shape's own third
    step, and the file restores to the live state bitwise."""
    ckpt = str(tmp_path / "ck")
    out: dict = {}
    assert trainer.main(_SMALL + ["--mesh", first, "--steps", "2",
                                  "--ckpt-dir", ckpt, "--ckpt-every", "2"],
                        out=out) == 0
    saved = tckpt.restore_train_state(ckpt, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        ttrain.tree_leaves(out["result"].state), ttrain.tree_leaves(saved)))
    resumed: dict = {}
    assert trainer.main(_SMALL + ["--mesh", then, "--steps", "3",
                                  "--ckpt-dir", ckpt], out=resumed) == 0
    assert resumed["result"].resumed_from == 2
    straight: dict = {}
    assert trainer.main(_SMALL + ["--mesh", first, "--steps", "3"],
                        out=straight) == 0
    for a, b in zip(ttrain.tree_leaves(resumed["result"].state["params"]),
                    ttrain.tree_leaves(straight["result"].state["params"])):
        _close(a.numpy(), b.numpy(), 5e-5)
