"""The port's data-parallel train step (``parallel.train.make_train_step``
with a ``comm``) against the JAX ``make_train_step`` on a (dp, 1, 1)
mesh, and its two transports against each other.

- Three steps on ``flat_mesh(4, "cpu", "dp")`` from one converted state
  against the JAX step on a (4, 1, 1) mesh of CPU devices: the loss and
  the clip norm within rtol 1e-5, the synced gradient and the parameters
  within atol 1e-5, the tolerances of
  ``test_torch_train.py::test_three_train_steps_match_jax`` (the JAX tree
  stages are XLA's ``psum_scatter``, so the sums differ in their last
  bits); a parameter whose first gradient is below 1e-7 is held to the
  bound AdamW's update gives it instead (see the test).
- Three ``codec="int8"`` steps against the JAX step with its error
  feedback: the losses within rtol 1e-5, the parameters within atol
  1e-5, and each rank's ``ef`` against the JAX device's own buffer: every
  element within one quantization step of the largest residual input,
  and all but 1% of them within 1e-6 (the same encode bits, a float32
  rounding apart; a rare stochastic rounding flips by one step, see
  ``test_torch_compressed.py``).  The checkpoint and the resume against
  JAX's: the file holds the first rank's residual (JAX's ``device_get``
  reads the first device's), and a resumed step gives it to every rank.
- Inside the port, bitwise: the bucketed sync's step equals the per-leaf
  sync's; a mesh of one rank equals the step without a ``comm``; two gloo
  processes end in the in-process mesh's state on every rank, the int8
  codec's per-rank residual included.

The suite runs JAX with ``jax_enable_x64``: every input is an explicit
float32 / int32 array.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from flextree_tpu_torch.bench.harness import digest, dist_train_steps
from flextree_tpu_torch.convert import (
    train_state_from_numpy,
    train_state_to_numpy,
)
from flextree_tpu_torch.models import transformer as tt
from flextree_tpu_torch.parallel import launch
from flextree_tpu_torch.parallel import train as ttrain
from flextree_tpu_torch.parallel.mesh import Mesh, flat_mesh

jt = importlib.import_module("flextree_tpu.models.transformer")
jtrain = importlib.import_module("flextree_tpu.parallel.train")

DIMS = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
KW = dict(lr=1e-3, grad_clip_norm=1.0, schedule="warmup_cosine",
          warmup_steps=1, total_steps=3)


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


@pytest.fixture(scope="module")
def jax_state():
    return _np(jtrain.init_train_state(jax.random.PRNGKey(0),
                                       jt.TransformerConfig(**DIMS)))


def _jax_grads(params, tokens, targets):
    """The JAX model's gradient of the mean token loss on one device."""
    cfg = jt.TransformerConfig(**DIMS)

    def loss(p):
        total, _ = jt.cross_entropy_loss(jt.forward(p, tokens, cfg), targets)
        return total / tokens.size

    return _np(jax.grad(loss)(jax.tree.map(jnp.asarray, params)))


@pytest.mark.parametrize("grad_topo", [None, "1"], ids=["flat", "ring"])
def test_three_dp_train_steps_match_jax(jax_state, grad_topo):
    """Data parallelism over 4 ranks, bucketed sync, clipping and
    warmup-cosine, reference attention on both sides.  The step-1 synced
    gradient within atol 1e-5 of the JAX model's; the parameters within
    atol 1e-5, except where the step-1 gradient is below 1e-7: there
    AdamW's first update, ``lr * g / (|g| + eps)`` with eps = 1e-8, turns a
    last-bit gap in g into up to ~lr (ROADMAP Queue 3, "AdamW at full
    width"), so those elements are held to the most three updates can
    move a parameter apart, 2 * lr * 3."""
    kw = dict(KW, grad_topo=grad_topo)
    mesh = jtrain.make_mesh_3d(4, (4, 1, 1))
    jstep = jtrain.make_train_step(mesh, jt.TransformerConfig(**DIMS),
                                   jtrain.TrainConfig(**kw))
    tcfg = tt.TransformerConfig(**DIMS)
    comm = flat_mesh(4, "cpu", "dp")
    tstep = ttrain.make_train_step(tcfg, ttrain.TrainConfig(**kw), comm=comm)
    jstate = jax.tree.map(jnp.asarray, jax_state)
    tstate = train_state_from_numpy(jax_state, device="cpu")
    _, grads, _ = ttrain.make_loss_and_grads(tcfg, ttrain.TrainConfig(**kw),
                                             comm=comm)(
        tstate["params"], *_batch(20))
    g1 = jax.tree.leaves(train_state_to_numpy({"g": grads})["g"])
    for a, b in zip(jax.tree.leaves(_jax_grads(jax_state["params"],
                                               *_batch(20))), g1):
        _close(b, a, 1e-5)
    for i in range(3):
        tokens, targets = _batch(20 + i)
        jstate, jm = jstep(jstate, jnp.asarray(tokens), jnp.asarray(targets))
        tstate, tm = tstep(tstate, tokens, targets)
        _close(tm["loss"].item(), float(jm["loss"]), 0, rtol=1e-5)
        _close(tm["grad_norm"].item(), float(jm["grad_norm"]), 0, rtol=1e-5)
    want = _np(jstate)
    got = train_state_to_numpy(tstate)
    assert int(got["step"]) == int(want["step"]) == 3
    for a, b, g in zip(jax.tree.leaves(want["params"]),
                       jax.tree.leaves(got["params"]), g1):
        tiny = np.abs(g) < 1e-7
        _close(b[~tiny], a[~tiny], 1e-5)
        _close(b[tiny], a[tiny], 2 * KW["lr"] * 3)


def _run(comm, train_cfg, steps=2, state=None):
    cfg = tt.TransformerConfig(**DIMS)
    if state is None:
        state = ttrain.init_train_state(cfg, torch.Generator().manual_seed(0),
                                        train_cfg, device="cpu")
    step = ttrain.make_train_step(cfg, train_cfg, device="cpu", comm=comm)
    losses = []
    for i in range(steps):
        state, m = step(state, *_batch(30 + i))
        losses.append(float(m["loss"]))
    return state, losses


def _same_state(a, b):
    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in
               zip(ttrain.tree_leaves(a), ttrain.tree_leaves(b)))


def test_dp_step_bucketed_equals_per_leaf_and_one_rank_equals_none():
    mesh = flat_mesh(4, "cpu", "dp")
    tc = ttrain.TrainConfig(**KW)
    fused, _ = _run(mesh, tc)
    per_leaf, _ = _run(mesh, dataclasses.replace(tc, bucket_bytes=0))
    chunked, _ = _run(mesh, dataclasses.replace(tc, bucket_bytes=64,
                                                grad_chunks=2))
    assert _same_state(fused, per_leaf) and _same_state(fused, chunked)
    alone, _ = _run(None, tc)
    one, _ = _run(flat_mesh(1, "cpu", "dp"), tc)
    assert _same_state(alone, one)


def test_gloo_ranks_end_in_the_mesh_state():
    """One spawn of 2 gloo processes, each a rank of the process group
    running the same steps: every rank's state bitwise the in-process
    mesh's, and the same losses."""
    tc = dict(KW, grad_topo="1")
    batches = [_batch(30 + i) for i in range(2)]
    got = launch.spawn(dist_train_steps, 2,
                       (DIMS, tc, batches, 0), backend="gloo", timeout=120)
    state, losses = _run(flat_mesh(2, "cpu", "dp"), ttrain.TrainConfig(**tc))
    want = [digest(t) for t in ttrain.tree_leaves(state)]
    for digests, rank_losses in got:
        assert digests == want and rank_losses == losses


def test_gloo_int8_ranks_end_in_the_mesh_state():
    """The int8 codec on 2 gloo processes: each rank's state, its own
    residual included, bitwise the in-process mesh's rank."""
    tc = dict(KW, codec="int8")
    batches = [_batch(30 + i) for i in range(2)]  # as _run steps
    got = launch.spawn(dist_train_steps, 2,
                       (DIMS, tc, batches, 0), backend="gloo", timeout=120)
    state, losses = _run(flat_mesh(2, "cpu", "dp"), ttrain.TrainConfig(**tc))
    for r, (digests, rank_losses) in enumerate(got):
        mine = dict(state, ef=state["ef"][r])
        assert digests == [digest(t) for t in ttrain.tree_leaves(mine)]
        assert rank_losses == losses
    assert not _same_state(state["ef"][0], state["ef"][1])


def test_dp_step_refuses_what_is_not_ported():
    cfg = tt.TransformerConfig(**DIMS)
    # an sp axis above 1 runs now (test_torch_model_parallel*.py), and so
    # do overlap, ZeRO-1 and a lossy codec on it (test_torch_wide*.py)
    sp2 = Mesh(("cpu",) * 2, ("dp", "sp", "tp"), (1, 2, 1))
    ttrain.make_train_step(cfg, comm=sp2)
    for field in (dict(overlap=True), dict(shard_optimizer=True),
                  dict(codec="int8")):
        tc = ttrain.TrainConfig(**field)
        state = ttrain.init_train_state(
            cfg, torch.Generator().manual_seed(0), tc, device="cpu",
            comm=sp2)
        new, m = ttrain.make_train_step(cfg, tc, comm=sp2)(state,
                                                          *_batch(0))
        assert np.isfinite(m["loss"].item()) and int(new["step"]) == 1
    # a lossy codec runs now (see the int8 tests below); an unknown one
    # raises
    for codec in ("int8", "bf16"):
        state, losses = _run(flat_mesh(2, "cpu", "dp"),
                             ttrain.TrainConfig(**KW, codec=codec))
        assert len(state["ef"]) == 2 and all(np.isfinite(losses))
    with pytest.raises(ValueError, match="unsupported codec"):
        ttrain.make_train_step(cfg, ttrain.TrainConfig(codec="fp4"),
                               comm=flat_mesh(2, "cpu", "dp"))
    with pytest.raises(Exception, match="IR families"):
        ttrain.make_train_step(cfg, ttrain.TrainConfig(grad_topo="swing"),
                               comm=flat_mesh(2, "cpu", "dp"))
    step = ttrain.make_train_step(cfg, comm=flat_mesh(3, "cpu", "dp"))
    state = ttrain.init_train_state(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    with pytest.raises(ValueError, match="does not split"):
        step(state, *_batch(0))


def test_global_grad_norm_with_specs_matches_jax(jax_state):
    """The port's norm (every leaf whole, as data parallelism leaves it)
    equals the JAX norm grouped by the axes the specs name, on a (1, 1, 1)
    mesh; on a (1, 1, 2) mesh, where the JAX norm sums the sharded leaves'
    squares over tp, so does the port's over the two ranks' slices."""
    rng = np.random.default_rng(3)
    grads = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        jax_state["params"])
    jspecs = jt.param_specs(jt.TransformerConfig(**DIMS), "tp")
    mesh = jtrain.make_mesh_3d(1, (1, 1, 1))
    want = jax.jit(jax.shard_map(
        lambda g: jtrain.global_grad_norm(g, jspecs), mesh=mesh,
        in_specs=(jspecs,), out_specs=P(), check_vma=False))(
        jax.tree.map(jnp.asarray, grads))
    tgrads = train_state_from_numpy(
        {"params": grads, "mu": grads, "nu": grads, "step": 0},
        device="cpu")["params"]
    _close(ttrain.global_grad_norm(tgrads).item(), float(want), 0,
           rtol=1e-6)
    from flextree_tpu_torch.parallel.spmd import shard_tree

    tp2 = Mesh(("cpu",) * 2, ("dp", "sp", "tp"), (1, 1, 2))
    want2 = jax.jit(jax.shard_map(
        lambda g: jtrain.global_grad_norm(g, jspecs),
        mesh=jtrain.make_mesh_3d(2, (1, 1, 2)), in_specs=(jspecs,),
        out_specs=P(), check_vma=False))(jax.tree.map(jnp.asarray, grads))
    tspecs = tt.param_specs(tt.TransformerConfig(**DIMS))
    _close(ttrain.global_grad_norm(shard_tree(tgrads, tspecs, tp2), tspecs,
                                   comm=tp2).item(), float(want2), 0,
           rtol=1e-6)


# ------------------------------------------------- lossy codec, EF


def _ef_close(jax_ef, port_ef, rank, pos, bar):
    """Rank ``rank``'s residual tree against the JAX device's own buffer
    (``addressable_shards``): within one quantization step ``bar``, all
    but 1% of the elements within 1e-6."""
    got = jax.tree.leaves(train_state_to_numpy({"e": port_ef})["e"])
    for a, b in zip(jax.tree.leaves(jax_ef), got):
        mine = np.array(next(sh.data for sh in a.addressable_shards
                             if pos[sh.device] == rank))
        gap = np.abs(mine - b)
        assert gap.max() <= bar and (gap > 1e-6).mean() <= 0.01, \
            (rank, float(gap.max()))


def test_int8_dp_steps_match_jax_with_per_rank_ef(jax_state, tmp_path):
    from flextree_tpu.utils import checkpoint as jckpt
    from flextree_tpu_torch.utils import checkpoint as tckpt

    kw = dict(KW, codec="int8")
    mesh = jtrain.make_mesh_3d(4, (4, 1, 1))
    pos = {d: i for i, d in enumerate(mesh.devices.reshape(-1))}
    jstep = jtrain.make_train_step(mesh, jt.TransformerConfig(**DIMS),
                                   jtrain.TrainConfig(**kw))
    tstep = ttrain.make_train_step(tt.TransformerConfig(**DIMS),
                                   ttrain.TrainConfig(**kw),
                                   comm=flat_mesh(4, "cpu", "dp"))
    zeros = jax.tree.map(np.zeros_like, jax_state["params"])
    jstate = jax.tree.map(jnp.asarray, dict(jax_state, ef=zeros))
    tstate = train_state_from_numpy(dict(jax_state, ef=zeros), device="cpu")
    saved = {}
    for i in range(3):
        tokens, targets = _batch(20 + i)
        jstate, jm = jstep(jstate, jnp.asarray(tokens), jnp.asarray(targets))
        tstate, tm = tstep(tstate, tokens, targets)
        _close(tm["loss"].item(), float(jm["loss"]), 0, rtol=1e-5)
        assert isinstance(tstate["ef"], list) and len(tstate["ef"]) == 4
        top = max(float(np.abs(g).max()) for g in
                  jax.tree.leaves(_jax_grads(jax_state["params"], tokens,
                                             targets)))
        for r in range(4):
            _ef_close(jstate["ef"], tstate["ef"][r], r, pos, 2 * top / 127)
        for a, b in zip(jax.tree.leaves(_np(jstate["params"])),
                        jax.tree.leaves(train_state_to_numpy(
                            {"p": tstate["params"]})["p"])):
            _close(b, a, 1e-5)
        if i == 1:
            saved["port"] = tckpt.save_train_state(tmp_path / "t", tstate)
            saved["jax"] = jckpt.save_train_state(str(tmp_path / "j"),
                                                  jstate)
            before = (tstate, jax.tree.map(lambda a: np.array(next(
                sh.data for sh in a.addressable_shards
                if pos[sh.device] == 0)), jstate["ef"]))
    # the files hold the first rank's (device's) residual, bitwise
    t_back = tckpt.restore_train_state(saved["port"], "cpu")
    assert _same_state(t_back["ef"], before[0]["ef"][0])
    j_back = jckpt.restore_train_state(saved["jax"])
    for a, b in zip(jax.tree.leaves(j_back["ef"]),
                    jax.tree.leaves(before[1])):
        assert np.array_equal(a, b)
    # resumed from the files, every rank starts from that residual: the
    # step after is JAX's, rank by rank; rank 0's residual is the straight
    # run's and rank 1's is not (its own was lost: a fault of the
    # reference, which the port keeps)
    tokens, targets = _batch(22)
    jres, _ = jstep(jax.tree.map(jnp.asarray, j_back), jnp.asarray(tokens),
                    jnp.asarray(targets))
    tres, _ = tstep(t_back, tokens, targets)
    for r in range(4):
        _ef_close(jres["ef"], tres["ef"][r], r, pos, 2 * top / 127)
    assert _same_state(tres["ef"][0], tstate["ef"][0])
    assert not _same_state(tres["ef"][1], tstate["ef"][1])


def test_ef_only_under_a_lossy_codec_as_in_jax(jax_state):
    cfg, jcfg = tt.TransformerConfig(**DIMS), jt.TransformerConfig(**DIMS)
    gen = torch.Generator().manual_seed(0)
    for codec in ("f32", "bf16", "int8"):
        want = jtrain.init_train_state(jax.random.PRNGKey(0), jcfg,
                                       jtrain.TrainConfig(codec=codec))
        got = ttrain.init_train_state(cfg, gen, ttrain.TrainConfig(
            codec=codec), device="cpu")
        assert set(got) == set(want), codec
