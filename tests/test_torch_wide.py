"""Lossy codecs, ZeRO-1 and overlap on the wide meshes: the shared
harness of ``tests/test_torch_wide_*.py``, the layouts and the
checkpoints.

The three families run on the JAX tests' small model (vocab 64, d_model
32, 4 heads, 2 layers, d_ff 64; MoE: 4 experts, top_k 1, moe_every 2):
the dense step on a (2, 2, 2) dp/sp/tp mesh, the GPipe step on a (1, 2,
2, 2) dp/pp/sp/tp mesh with 2 microbatches and the MoE step on a (1, 2,
2, 2) dp/ep/sp/tp mesh, each from one JAX state carried over by
``convert``, on batches of shape (4, 32) drawn by
``np.random.default_rng``.

Here: the ZeRO layout of each family equals the JAX
``build_zero_layout`` leaf by leaf and the state's buffers have the JAX
global shapes; the checkpoint of a wide lossy run holds, slice by slice,
the first rank's residual, and a sharded wide run's consolidated
checkpoint round-trips and resumes on the replicated step.  The port's
bitwise contracts are ``test_torch_wide_bits.py``, the fold's launch
counts ``test_torch_wide_folds.py``, the JAX comparisons
``test_torch_wide_jax_*.py`` (:func:`check_against_jax`).
"""

import dataclasses
import functools
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
from flextree_tpu_torch.models import moe as tmo
from flextree_tpu_torch.models import transformer as tt
from flextree_tpu_torch.parallel import moe_train as tmt
from flextree_tpu_torch.parallel import pipeline as tpp
from flextree_tpu_torch.parallel import train as ttrain
from flextree_tpu_torch.parallel.mesh import Mesh
from flextree_tpu_torch.parallel.spmd import gather_tree
from flextree_tpu_torch.utils.tree import tree_leaves

# One intra-op thread for the whole test process (every worker imports this
# module when it collects): six workers each running torch's default pool
# of one thread a core oversubscribe the host; on 8 cores the whole suite
# at six workers took 1230 s that way and 739 s with one thread.
torch.set_num_threads(1)

jt = importlib.import_module("flextree_tpu.models.transformer")
jmo = importlib.import_module("flextree_tpu.models.moe")
jtrain = importlib.import_module("flextree_tpu.parallel.train")
jpp = importlib.import_module("flextree_tpu.parallel.pipeline")
jmt = importlib.import_module("flextree_tpu.parallel.moe_train")
jzero = importlib.import_module("flextree_tpu.parallel.zero")

DIMS = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
MOE = dict(n_experts=4, top_k=1, moe_every=2)
SHAPES = {"dense": (2, 2, 2), "pipeline": (1, 2, 2, 2), "moe": (1, 2, 2, 2)}
AXES = {"dense": ("dp", "sp", "tp"), "pipeline": ("dp", "pp", "sp", "tp"),
        "moe": ("dp", "ep", "sp", "tp")}
MICRO = 2
BATCH = (4, 32)
OPTIONS = {"int8": dict(codec="int8"), "bf16": dict(codec="bf16"),
           "zero": dict(shard_optimizer=True), "overlap": dict(overlap=True),
           "zero_overlap": dict(shard_optimizer=True, overlap=True)}
# the JAX tests' step config: AdamW, warmup-cosine, clipping
KW = dict(lr=1e-3, grad_clip_norm=1.0, schedule="warmup_cosine",
          warmup_steps=1, total_steps=3)
STEPS = 2


def np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=atol,
                               rtol=rtol)


def batches(seed=7, n=STEPS):
    rng = np.random.default_rng(seed)
    return [tuple(rng.integers(0, DIMS["vocab_size"], BATCH).astype(np.int32)
                  for _ in range(2)) for _ in range(n)]


def port_cfg(family):
    if family == "moe":
        return tmo.MoEConfig(**DIMS, **MOE)
    return tt.TransformerConfig(**DIMS)


def jax_cfg(family):
    if family == "moe":
        return jmo.MoEConfig(**DIMS, **MOE)
    return jt.TransformerConfig(**DIMS)


def port_mesh(family):
    shape = SHAPES[family]
    return Mesh(("cpu",) * int(np.prod(shape)), AXES[family], shape)


def port_specs(family):
    cfg = port_cfg(family)
    if family == "pipeline":
        return tpp.pipeline_param_specs(cfg)
    if family == "moe":
        return tmo.moe_param_specs(cfg)
    return tt.param_specs(cfg)


def port_step(family, tc, serialize=False):
    cfg, mesh = port_cfg(family), port_mesh(family)
    if family == "pipeline":
        return tpp.make_pipeline_train_step(cfg, tc, MICRO, comm=mesh,
                                            serialize_overlap=serialize)
    if family == "moe":
        return tmt.make_moe_train_step(cfg, tc, comm=mesh,
                                       serialize_overlap=serialize)
    return ttrain.make_train_step(cfg, tc, comm=mesh,
                                  serialize_overlap=serialize)


def port_state(family, tc, seed=0):
    """A fresh port state of ``family`` under ``tc`` on its mesh."""
    cfg, mesh, gen = port_cfg(family), port_mesh(family), \
        torch.Generator().manual_seed(seed)
    if family == "pipeline":
        return tpp.init_pipeline_train_state(cfg, gen, tc, device="cpu",
                                             comm=mesh)
    if family == "moe":
        return tmt.init_moe_train_state(cfg, gen, tc, device="cpu",
                                        comm=mesh)
    return ttrain.init_train_state(cfg, gen, tc, device="cpu", comm=mesh)


def port_layout(family, params):
    return ttrain.zero_layout_for(port_mesh(family), params,
                                  port_specs(family), AXES[family])


def run_port(family, tc, state=None, serialize=False, data=None):
    """``STEPS`` steps of ``tc`` from ``state`` (default a fresh one):
    ``(state, losses, metrics)``."""
    state = port_state(family, tc) if state is None else state
    step = port_step(family, tc, serialize)
    losses, metrics = [], []
    for tokens, targets in data or batches():
        state, m = step(state, tokens, targets)
        losses.append(m["loss"])
        metrics.append(m)
    return state, losses, metrics


@functools.lru_cache(maxsize=32)
def run_cached(family, tc, serialize=False):
    """:func:`run_port` from a fresh state on the default batches, once a
    test process for each ``(family, tc, serialize)``: the tests that share
    a run only read it."""
    return run_port(family, tc, serialize=serialize)


def f32(**kw):
    """The step config with clipping off (the sharded norm sums in another
    order), float32, plus ``kw``."""
    return ttrain.TrainConfig(**dict(KW, grad_clip_norm=0.0), **kw)


def jax_mesh(family):
    shape = SHAPES[family]
    if family == "dense":
        return jtrain.make_mesh_3d(8, shape)
    return jpp.make_mesh_4d(8, shape, AXES[family])


def jax_run(family, opts):
    """The JAX step of ``family`` under ``KW`` and ``opts`` from its own
    init: ``(initial state, states after each step, losses, metrics)``, as
    JAX arrays."""
    tc = jtrain.TrainConfig(**KW, **opts)
    cfg, mesh = jax_cfg(family), jax_mesh(family)
    key = jax.random.PRNGKey(0)
    if family == "pipeline":
        state = jpp.init_pipeline_train_state(key, cfg, tc, mesh=mesh)
        step = jpp.make_pipeline_train_step(mesh, cfg, tc, MICRO)
    elif family == "moe":
        state = jmt.init_moe_train_state(key, cfg, tc, mesh=mesh)
        step = jmt.make_moe_train_step(mesh, cfg, tc)
    else:
        state = jtrain.init_train_state(key, cfg, tc, mesh=mesh)
        step = jtrain.make_train_step(mesh, cfg, tc)
    init, states, metrics = state, [], []
    for tokens, targets in batches():
        state, m = step(state, jnp.asarray(tokens), jnp.asarray(targets))
        states.append(state)
        metrics.append(m)
    return init, states, metrics


def device_blocks(arr, mesh) -> list:
    """Each device's block of a JAX array, in the mesh's row-major device
    order (the port's rank order)."""
    pos = {d: i for i, d in enumerate(mesh.devices.reshape(-1))}
    out = [None] * len(pos)
    for sh in arr.addressable_shards:
        out[pos[sh.device]] = np.array(sh.data)
    return out


def same_trees(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def same_state(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(
        same_trees(a[k], b[k]) for k in a)


# --------------------------------------------------------------- layouts


@pytest.mark.parametrize("family", list(SHAPES))
def test_zero_layout_and_state_are_jax_leaf_by_leaf(family):
    """The port's ``ZeroLayout`` equals JAX's ``build_zero_layout`` leaf by
    leaf (the shard axis often not dp), and the sharded state's buffers
    have the shapes of the JAX state's global arrays."""
    jcfg = jax_cfg(family)
    tc = ttrain.TrainConfig(shard_optimizer=True, codec="int8")
    state = port_state(family, tc)
    got = port_layout(family, state["params"])
    jtc = jtrain.TrainConfig(shard_optimizer=True, codec="int8")
    mesh = jax_mesh(family)
    key = jax.random.PRNGKey(0)
    if family == "pipeline":
        jstate = jpp.init_pipeline_train_state(key, jcfg, jtc, mesh=mesh)
        jspecs = jpp.pipeline_param_specs(jcfg)
    elif family == "moe":
        jstate = jmt.init_moe_train_state(key, jcfg, jtc, mesh=mesh)
        jspecs = jmo.moe_param_specs(jcfg)
    else:
        jstate = jtrain.init_train_state(key, jcfg, jtc, mesh=mesh)
        jspecs = jt.param_specs(jcfg, "tp")
    want = jtrain.zero_layout_for(mesh, jstate["params"], jspecs,
                                  AXES[family])
    assert [dataclasses.astuple(x) for x in got.leaves] == \
        [tuple(int(v) if isinstance(v, (int, np.integer)) else v
               for v in dataclasses.astuple(x)) for x in want.leaves]
    assert dict(got.axis_sizes) == {k: int(v) for k, v in
                                    want.axis_sizes.items()}
    shard_axes = {p.shard_ax for p in got.leaves}
    assert shard_axes == {"dense": {"dp"}, "pipeline": {"pp", "sp"},
                          "moe": {"ep", "sp"}}[family]
    for key_ in jstate:
        for a, b in zip(jax.tree.leaves(jstate[key_]),
                        tree_leaves(state[key_])):
            assert tuple(a.shape) == tuple(b.shape), key_


# ------------------------------------------------ against the JAX package


def _loss_and_grads(family, tc):
    cfg, mesh = port_cfg(family), port_mesh(family)
    if family == "pipeline":
        return tpp.make_pipeline_loss_and_grads(cfg, tc, MICRO, comm=mesh)
    if family == "moe":
        return tmt.make_moe_loss_and_grads(cfg, tc, comm=mesh)
    fn = ttrain.make_loss_and_grads(cfg, tc, comm=mesh)
    return lambda *a, **k: fn(*a, **k)[:2]


def _index_slices(params, family):
    """Each rank's slices of each leaf's flat element indices."""
    from flextree_tpu_torch.parallel.spmd import shard_tree

    idx = ttrain.tree_map(lambda p: torch.arange(p.numel()).view(p.shape),
                          params)
    return [tree_leaves(t) for t in shard_tree(idx, port_specs(family),
                                               port_mesh(family))]


# the share of a leaf's elements (counted over every rank's slices, at one
# step) whose residual may sit one quantum off JAX's: a stochastic (int8)
# or nearest (bf16) rounding whose input lies on its threshold to within
# the two packages' float32 difference (a gradient that cancels carries
# its terms' rounding error, near a bf16 ulp of a small element; the
# most seen is 5 of 4096 at the second bf16 step); 1 element at least
FLIP_SHARE = 1e-2


def _quanta(family, tc, xs, specs):
    """Each rank's, each leaf's largest rounding quantum at its input
    ``xs`` (every rank's flat ``grad + ef`` leaves): for int8, the largest
    ``|x| / 127`` of any block that can hold the element in its bucket's
    packed buffer (``block - 1`` elements each side); for bf16, one bf16
    ulp of ``|x|``.  A residual lies within one quantum of zero, and a
    flipped rounding moves it by exactly one.  ``specs``: the leaves'
    partition specs."""
    from flextree_tpu_torch.ops.quantize import get_codec
    from flextree_tpu_torch.parallel.bucketing import plan_buckets

    codec, mesh = get_codec(tc.codec), port_mesh(family)
    if codec.name == "bf16":
        return [[torch.ldexp(torch.ones_like(x), torch.frexp(x)[1] - 8) *
                 (x != 0) for x in rank] for rank in xs]
    sizes = dict(zip(AXES[family], SHAPES[family]))
    if tc.bucket_bytes == 0:
        groups = [(i,) for i in range(len(xs[0]))]
    else:
        groups = [b.indices for b in plan_buckets(
            xs[0], specs, AXES[family],
            topos=ttrain.resolve_axis_topos(mesh, AXES[family], tc.grad_topo),
            axis_sizes=sizes, bucket_bytes=tc.bucket_bytes, codec=codec)]
    out = [[torch.zeros_like(x) for x in rank] for rank in xs]
    w = codec.block
    for rank, q in zip(xs, out):
        for idx in groups:
            packed = torch.cat([rank[i].reshape(-1) for i in idx]).abs()
            amax = torch.nn.functional.max_pool1d(
                packed[None, None], 2 * w - 1, 1, w - 1)[0, 0]
            for i, a in zip(idx, amax.split([rank[i].numel() for i in idx])):
                q[i] = (a / 127).view(rank[i].shape)
    return out


def _check_residuals(got_ef, jax_ef, quanta, jmesh, index, flips, where):
    """Every rank's residual against the JAX device's, element by element:
    both within one quantum of zero; apart by at most 1e-6, or (a flipped
    rounding) by at most one quantum, on at most ``FLIP_SHARE`` of each
    leaf.  Marks the flipped elements in ``flips`` (flat leaf indices) and
    returns their count."""
    n_flipped = 0
    for i, a in enumerate(jax.tree.leaves(jax_ef)):
        wants = device_blocks(a, jmesh)
        count = sum(w.size for w in wants)
        here = 0
        for r, want in enumerate(wants):
            got = tree_leaves(got_ef[r])[i].numpy().astype(np.float64)
            q = quanta[r][i].double().numpy() * (1 + 1e-5) + 1e-9
            assert (np.abs(got) <= q).all(), (where, i, r, "port")
            assert (np.abs(want) <= q).all(), (where, i, r, "jax")
            gap = np.abs(got - want)
            flip = gap > 1e-6
            assert (gap[flip] <= q[flip]).all(), (where, i, r, "flip")
            flips[i][index[r][i].numpy()[flip]] = True
            here += int(flip.sum())
        assert here <= max(1, FLIP_SHARE * count), (where, i, here, count)
        n_flipped += here
    return n_flipped


def check_against_jax(family, option):
    """``STEPS`` steps of ``family`` under ``option`` in both packages from
    one JAX state, on the same batches.

    - The loss and (clipped) the norm within rtol 1e-5 at every step.
    - Under a lossy codec, every rank's residual against the JAX device's
      element by element (:func:`_check_residuals`): within 1e-6, or, where
      a rounding sat on its threshold, one quantum of the element's block
      on at most ``FLIP_SHARE`` of each leaf.
    - The parameters within atol 1e-5, except where AdamW's update is
      ill-conditioned (the step-1 gradient below 1e-6 or the first two
      steps' below 1e-5 together, ``tests/test_torch_overlap.py``'s rule)
      or a rounding flipped: those within AdamW's bound, 2 lr a step.
    - Under ZeRO, the consolidated moments against JAX's
      ``make_consolidate_fn`` of its state: ``mu`` and ``sqrt(nu)`` (the
      gradient's scale) within rtol 1e-4 plus 1e-5 of the leaf's largest
      value (a gradient that is a sum which cancels carries the float32
      error of its terms, not of itself)."""
    from flextree_tpu_torch.ops.quantize import get_codec
    from flextree_tpu_torch.parallel import zero as tzero
    from flextree_tpu_torch.parallel.bucketing import spec_leaves
    from flextree_tpu_torch.parallel.spmd import rank_trees

    opts = OPTIONS[option]
    init, jstates, jm = jax_run(family, opts)
    tc = ttrain.TrainConfig(**KW, **opts)
    codec = get_codec(tc.codec)
    state = train_state_from_numpy(np_tree(init), device="cpu")
    step = port_step(family, tc)
    synced = _loss_and_grads(family, ttrain.TrainConfig(**KW))
    raw = _loss_and_grads(family, ttrain.TrainConfig(**KW,
                                                     shard_optimizer=True))
    mesh, jmesh = port_mesh(family), jax_mesh(family)
    index = _index_slices(state["params"], family)
    flips = [np.zeros(p.numel(), bool) for p in tree_leaves(state["params"])]
    gs, n_flipped = [], []
    for k, (tokens, targets) in enumerate(batches()):
        gs.append([g.numpy() for g in tree_leaves(
            synced(state["params"], tokens, targets)[1])])
        if codec.lossy:
            efs = rank_trees(state["ef"], port_specs(family), mesh)
            grads = raw(state["params"], tokens, targets)[1]
            xs = [[(g + e).float() for g, e in zip(tree_leaves(r),
                                                   tree_leaves(e))]
                  for r, e in zip(grads, efs)]
            quanta = _quanta(family, tc, xs, spec_leaves(
                grads[0], port_specs(family)))
        state, m = step(state, tokens, targets)
        close(m["loss"].item(), float(jm[k]["loss"]), 0, rtol=1e-5)
        close(m["grad_norm"].item(), float(jm[k]["grad_norm"]), 0,
              rtol=1e-5)
        if codec.lossy:
            n_flipped.append(_check_residuals(
                state["ef"], jstates[k]["ef"], quanta, jmesh, index, flips,
                (family, option, k)))
    print(f"{family} {option}: flipped roundings a step {n_flipped}")
    want = jax.tree.leaves(np_tree(jstates[-1]["params"]))
    got = [p.numpy() for p in tree_leaves(state["params"])]
    for a, b, g1, g2, flip in zip(got, want, gs[0], gs[1], flips):
        loose = (np.abs(g1) < 1e-6) | (np.hypot(g1, g2) < 1e-5) | \
            flip.reshape(a.shape)
        close(a[~loose], b[~loose], 1e-5)
        close(a[loose], b[loose], 2 * KW["lr"] * STEPS)
    if not tc.shard_optimizer:
        return
    specs = port_specs(family)
    layout = port_layout(family, state["params"])
    cons = tzero.make_consolidate_fn(mesh, specs, layout, None,
                                     codec.lossy)(state)
    jspecs = {"dense": lambda c: jt.param_specs(c, "tp"),
              "pipeline": jpp.pipeline_param_specs,
              "moe": jmo.moe_param_specs}[family](jax_cfg(family))
    jlayout = jtrain.zero_layout_for(jmesh, jstates[-1]["params"], jspecs,
                                     AXES[family])
    jcons = np_tree(jzero.make_consolidate_fn(
        jmesh, jspecs, jlayout, None, codec.lossy)(jstates[-1]))
    for key, f in (("mu", np.asarray), ("nu", np.sqrt)):
        for a, b in zip(tree_leaves(cons[key]), jax.tree.leaves(jcons[key])):
            a, b = f(a.numpy().astype(np.float64)), f(b.astype(np.float64))
            close(a, b, 1e-5 * np.abs(b).max(), rtol=1e-4)


# ------------------------------------------------ checkpoints and convert


@pytest.mark.parametrize("family", list(SHAPES))
def test_lossy_checkpoint_holds_the_first_holders_residual(family,
                                                           tmp_path):
    """Two int8 steps through ``fit`` with the trainer's hooks: the file's
    ``ef`` is, slice by slice, the first rank's that holds it (JAX's
    ``device_get``), every other tree the live state's; the conversion to
    the JAX pytree reads the same residual, and a resume cuts it for
    every rank."""
    from flextree_tpu_torch.parallel.loop import FitConfig, fit
    from flextree_tpu_torch.trainer import sharded_hooks
    from flextree_tpu_torch.utils import checkpoint as tckpt

    tc = ttrain.TrainConfig(**KW, codec="int8")
    state = port_state(family, tc)
    pack, unpack = sharded_hooks(port_mesh(family), port_cfg(family),
                                 state["params"], tc, family)
    assert unpack is None
    data = batches()

    class Data:
        def batch_at(self, i):
            return data[i]

    ckpt = str(tmp_path / "ck")
    res = fit(state, port_step(family, tc), Data(),
              FitConfig(num_steps=STEPS, ckpt_dir=ckpt, log_every=1),
              state_pack=pack)
    live = res.state
    saved = tckpt.restore_train_state(ckpt, "cpu")
    want = gather_tree(live["ef"], port_specs(family), port_mesh(family))
    assert same_trees(saved["ef"], want)
    assert same_state({k: v for k, v in saved.items() if k != "ef"},
                      {k: v for k, v in live.items() if k != "ef"})
    as_np = train_state_to_numpy(live, port_specs(family), port_mesh(family))
    assert all(np.array_equal(a, b.numpy()) for a, b in zip(
        jax.tree.leaves(as_np["ef"]), tree_leaves(want)))
    back = train_state_from_numpy(as_np, device="cpu")
    assert same_trees(back["ef"], want)
    # resumed: the first rank's residual is the live one's, bitwise
    again, _, _ = run_port(family, tc, state=saved, data=data[:1])
    step_live, _, _ = run_port(family, tc, state=live, data=data[:1])
    assert same_trees(again["ef"][0], step_live["ef"][0])


@pytest.mark.parametrize("family", list(SHAPES))
def test_sharded_checkpoint_round_trips_and_resumes_replicated(family):
    """A sharded state on the wide mesh, int8 and float32: consolidate
    then reshard is a bitwise fixed point (under int8 the working
    parameters aside: the consolidated ones are the float32 master), the
    JAX global buffers survive the round trip through ``convert``, and the
    consolidated float32 state resumes on the replicated step."""
    from flextree_tpu_torch.parallel import zero as tzero

    for codec in ("int8", "f32"):
        tc = f32(shard_optimizer=True, codec=codec)
        state, _, _ = run_cached(family, tc)
        lossy = codec != "f32"
        layout = port_layout(family, state["params"])
        args = (port_mesh(family), port_specs(family), layout, None, lossy)
        cons = tzero.make_consolidate_fn(*args)(state)
        again = tzero.make_reshard_fn(*args)(cons)
        keys = [k for k in state if k != "ef"]
        assert same_state({k: again[k] for k in keys if k != "params"
                           or not lossy},
                          {k: state[k] for k in keys if k != "params"
                           or not lossy})
        trip = train_state_from_numpy(train_state_to_numpy(
            {k: state[k] for k in keys}), device="cpu")
        assert same_state(trip, {k: state[k] for k in keys})
        if lossy:
            continue
        rep, _, _ = run_port(family, f32(), state=dict(cons),
                             data=batches(9, 1))
        sh, _, _ = run_port(family, tc, state=state, data=batches(9, 1))
        assert same_trees(rep["params"], sh["params"])
