"""The port's ZeRO-1 train step (``TrainConfig(shard_optimizer=True)``)
against the JAX package's and against its own replicated step, with its
checkpoints.

- Three float32 sharded steps on ``flat_mesh(8, "cpu", "dp")`` from one
  converted state against the JAX sharded step on a (8, 1, 1) mesh: the
  loss within rtol 1e-5 (as ``test_torch_train_dp.py`` holds the
  replicated step); the parameters within atol 1e-5 except where the
  step-1 gradient is below 1e-7, held to AdamW's update bound 2·lr·3
  there; ``mu_shard``/``mu_tail`` within 1e-5 (a moment is a mean of
  gradients, each within 1e-5) and ``nu_shard``/``nu_tail`` within
  2·max|g|·1e-5 (the square of a gradient within 1e-5).
- Inside the port, bitwise: the sharded step equals the replicated step
  (loss, parameters, and the consolidated moments equal the replicated
  ``mu``/``nu``) on ``grad_topo`` None, ``"2,2,2"`` and the ring; with
  ``overlap`` the overlapped sharded step, its serialized twin and the
  replicated step all equal (the JAX
  ``test_dense_overlap_composition_bitwise``); a ZeRO fire's shards equal
  the serialized reduce-scatter's (``test_torch_overlap.py``).
- Lossy: the int8 sharded step trains (finite, falling loss), its master
  starts from the working params (one update away from them after step
  1), each rank's ``ef`` is its own; with
  clipping the sharded norm is the replicated one within rtol 1e-5 (the
  JAX ``test_clipping_close_to_replicated``).
- Checkpoints: consolidate then reshard is a bitwise fixed point at dp=8
  and across worlds (8 -> 4 -> consolidate again); the consolidated state
  equals JAX's ``make_consolidate_fn`` on the same converted sharded
  state, bitwise; ``fit`` with the trainer's hooks saves, resumes bitwise
  and its checkpoint resumes on the replicated step; under int8 the file
  holds the first rank's ``ef``, which every rank takes on resume (the
  JAX package's ``device_get``, kept as the replicated path keeps it).
- Two gloo processes end, each rank, in the mesh's state: its own block
  of every shard buffer, the rest whole.

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

from flextree_tpu_torch.bench.harness import digest, dist_train_steps
from flextree_tpu_torch.convert import (
    train_state_from_numpy,
    train_state_to_numpy,
)
from flextree_tpu_torch.models import transformer as tt
from flextree_tpu_torch.parallel import launch
from flextree_tpu_torch.parallel import train as ttrain
from flextree_tpu_torch.parallel.loop import FitConfig, fit
from flextree_tpu_torch.parallel.mesh import flat_mesh
from flextree_tpu_torch.trainer import sharded_hooks
from flextree_tpu_torch.utils import checkpoint as tckpt

jt = importlib.import_module("flextree_tpu.models.transformer")
jtrain = importlib.import_module("flextree_tpu.parallel.train")
jz = importlib.import_module("flextree_tpu.parallel.zero")

DIMS = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
KW = dict(lr=1e-3, grad_clip_norm=1.0, schedule="warmup_cosine",
          warmup_steps=1, total_steps=3)
AXES = ("dp", "sp", "tp")
N = 8


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=atol,
                               rtol=rtol)


def _batch(seed, shape=(8, 16)):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, DIMS["vocab_size"], shape).astype(np.int32),
            rng.integers(0, DIMS["vocab_size"], shape).astype(np.int32))


def _same(a, b):
    la, lb = ttrain.tree_leaves(a), ttrain.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _cfg():
    return tt.TransformerConfig(**DIMS)


def _run(comm, tc, steps=2, state=None, serialize=False, seed=30):
    """``steps`` steps of ``tc`` over ``comm`` from a fresh state (or
    ``state``); returns the state and the losses (tensors)."""
    if state is None:
        state = ttrain.init_train_state(
            _cfg(), torch.Generator().manual_seed(0), tc, device="cpu",
            comm=comm)
    step = ttrain.make_train_step(_cfg(), tc, device="cpu", comm=comm,
                                  serialize_overlap=serialize)
    losses = []
    for i in range(steps):
        state, m = step(state, *_batch(seed + i))
        losses.append(m["loss"])
    return state, losses


def _hooks(comm, tc):
    params = tt.init_params(_cfg(), torch.Generator().manual_seed(0),
                            device="cpu")
    return sharded_hooks(comm, _cfg(), params, tc)


# ------------------------------------------------------------- vs JAX


def test_three_sharded_steps_match_jax():
    mesh = jtrain.make_mesh_3d(N, (N, 1, 1))
    jtc = jtrain.TrainConfig(**KW, shard_optimizer=True)
    jcfg = jt.TransformerConfig(**DIMS)
    jstate = jtrain.init_train_state(jax.random.PRNGKey(0), jcfg, jtc,
                                     mesh=mesh)
    jstep = jtrain.make_train_step(mesh, jcfg, jtc)
    comm = flat_mesh(N, "cpu", "dp")
    tc = ttrain.TrainConfig(**KW, shard_optimizer=True)
    tstate = train_state_from_numpy(_np(jstate), device="cpu")
    assert tstate["mu_shard"]["embed"].shape == (64 * 32,)  # host-global
    # the conversion is a copy, both ways
    for a, b in zip(jax.tree.leaves(_np(jstate)),
                    jax.tree.leaves(train_state_to_numpy(tstate))):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    tstep = ttrain.make_train_step(_cfg(), tc, device="cpu", comm=comm)
    g1 = None
    for i in range(3):
        tokens, targets = _batch(20 + i)
        if g1 is None:  # the step-1 gradient, for AdamW's bound below
            _, grads, _ = ttrain.make_loss_and_grads(
                _cfg(), ttrain.TrainConfig(**KW), comm=comm)(
                tstate["params"], tokens, targets)
            g1 = [g.numpy() for g in ttrain.tree_leaves(grads)]
        jstate, jm = jstep(jstate, jnp.asarray(tokens), jnp.asarray(targets))
        tstate, tm = tstep(tstate, tokens, targets)
        _close(tm["loss"].item(), float(jm["loss"]), 0, rtol=1e-5)
        _close(tm["grad_norm"].item(), float(jm["grad_norm"]), 0, rtol=1e-5)
    want, got = _np(jstate), train_state_to_numpy(tstate)
    assert set(got) == set(want) and int(got["step"]) == 3
    gmax = max(float(np.abs(g).max()) for g in g1)
    for a, b, g in zip(jax.tree.leaves(want["params"]),
                       jax.tree.leaves(got["params"]), g1):
        tiny = np.abs(g) < 1e-7
        _close(b[~tiny], a[~tiny], 1e-5)
        _close(b[tiny], a[tiny], 2 * KW["lr"] * 3)
    for key, bar in (("mu_shard", 1e-5), ("mu_tail", 1e-5),
                     ("nu_shard", 2 * gmax * 1e-5),
                     ("nu_tail", 2 * gmax * 1e-5)):
        for a, b in zip(jax.tree.leaves(want[key]),
                        jax.tree.leaves(got[key])):
            assert a.shape == b.shape
            _close(b, a, bar)


def test_consolidated_state_equals_jax_consolidate_bitwise():
    """The port's consolidation of a sharded state (two steps on the
    ring, whose blocks the ranks own out of order) and JAX's
    ``make_consolidate_fn`` of the same state, converted: bitwise."""
    tc = ttrain.TrainConfig(grad_topo={"dp": "1"}, shard_optimizer=True)
    comm = flat_mesh(N, "cpu", "dp")
    state, _ = _run(comm, tc)
    pack, _ = _hooks(comm, tc)
    got = train_state_to_numpy(pack(state))
    mesh = jtrain.make_mesh_3d(N, (N, 1, 1))
    jcfg = jt.TransformerConfig(**DIMS)
    jspecs = jt.param_specs(jcfg, "tp")
    shapes = jax.eval_shape(lambda k: jt.init_params(k, jcfg),
                            jax.random.PRNGKey(0))
    layout = jtrain.zero_layout_for(mesh, shapes, jspecs, AXES)
    jstate = jax.tree.map(jnp.asarray, train_state_to_numpy(state))
    want = _np(jz.make_consolidate_fn(mesh, jspecs, layout, {"dp": "1"},
                                      False)(jstate))
    assert set(got) == set(want) == {"params", "mu", "nu", "step"}
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# --------------------------------------------- vs the replicated step


@pytest.mark.parametrize("grad_topo", [None, "2,2,2", {"dp": "1"}],
                         ids=["flat", "2,2,2", "ring"])
def test_sharded_step_bitwise_replicated_overlap_composed(grad_topo):
    """Loss, parameters and the consolidated moments: the sharded step,
    its overlapped step and the overlapped step's twin, each bitwise the
    replicated step, after two steps."""
    comm = flat_mesh(N, "cpu", "dp")
    rep_tc = ttrain.TrainConfig(grad_topo=grad_topo)
    rep, rep_losses = _run(comm, rep_tc)
    sh_tc = dataclasses.replace(rep_tc, shard_optimizer=True)
    ovl_tc = dataclasses.replace(sh_tc, overlap=True)
    pack, _ = _hooks(comm, sh_tc)
    for tc, ser in ((sh_tc, False), (ovl_tc, False), (ovl_tc, True)):
        st, losses = _run(comm, tc, serialize=ser)
        assert all(torch.equal(a, b) for a, b in zip(losses, rep_losses))
        assert _same(pack(st), rep), (tc, ser)
    assert set(st) == {"params", "step", "mu_shard", "mu_tail", "mu_rep",
                       "nu_shard", "nu_tail", "nu_rep"}


def test_int8_sharded_trains_with_master_and_per_rank_ef():
    comm = flat_mesh(N, "cpu", "dp")
    tc = ttrain.TrainConfig(codec="int8", shard_optimizer=True)
    state = ttrain.init_train_state(_cfg(), torch.Generator().manual_seed(0),
                                    tc, device="cpu", comm=comm)
    assert {"master_shard", "master_tail", "ef"} <= set(state)
    assert not any(m.any() for m in ttrain.tree_leaves(state["master_shard"]))
    step = ttrain.make_train_step(_cfg(), tc, device="cpu", comm=comm)
    pack, _ = _hooks(comm, tc)
    init = state["params"]
    losses = []
    for i in range(4):
        state, m = step(state, *_batch(40))  # one batch: the loss falls
        losses.append(float(m["loss"]))
        if i == 0:
            # the first update starts from the working params, not the
            # zeros the master held: one AdamW step moves each by <= lr
            assert all(m.any() for m in
                       ttrain.tree_leaves(state["master_shard"]))
            for a, b in zip(ttrain.tree_leaves(pack(state)["params"]),
                            ttrain.tree_leaves(init)):
                assert float((a - b).abs().max()) <= 1.001e-3
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    efs = state["ef"]
    assert isinstance(efs, list) and len(efs) == N
    assert all(any(e.any() for e in ttrain.tree_leaves(ef)) for ef in efs)
    assert not _same(efs[0], efs[1])
    # overlap composed: the overlapped step and its twin, bitwise
    ovl = dataclasses.replace(tc, overlap=True)
    a, _ = _run(comm, ovl)
    b, _ = _run(comm, ovl, serialize=True)
    assert _same(a, b) and len(a["ef"]) == N


def test_clipping_close_to_replicated():
    """With clipping on, the norm sums the ranks' blocks in another order:
    the sharded step's clip norm within rtol 1e-5 of the replicated one
    and, after one step, the parameters within AdamW's update bound
    (where the clip scales differ in the last bits, an update near
    ``lr * g / (|g| + eps)`` can move by up to ``2 * lr``)."""
    comm = flat_mesh(N, "cpu", "dp")
    tc = ttrain.TrainConfig(grad_clip_norm=0.5)
    rep, rl = _run(comm, tc, steps=1)
    step = ttrain.make_train_step(_cfg(), tc, device="cpu", comm=comm)
    sh_tc = dataclasses.replace(tc, shard_optimizer=True)
    st = ttrain.init_train_state(_cfg(), torch.Generator().manual_seed(0),
                                 sh_tc, device="cpu", comm=comm)
    base = ttrain.init_train_state(_cfg(), torch.Generator().manual_seed(0),
                                   tc, device="cpu")
    _, mr = step(base, *_batch(30))
    sh, ms = ttrain.make_train_step(_cfg(), sh_tc, device="cpu", comm=comm)(
        st, *_batch(30))
    _close(ms["grad_norm"].item(), mr["grad_norm"].item(), 0, rtol=1e-5)
    assert torch.equal(ms["loss"], rl[0])
    for a, b in zip(ttrain.tree_leaves(sh["params"]),
                    ttrain.tree_leaves(rep["params"])):
        _close(a, b, 2 * 1e-3)


# ---------------------------------------------------------- checkpoints


def test_consolidate_reshard_fixed_point_across_worlds():
    tc = ttrain.TrainConfig(grad_topo="4,2", shard_optimizer=True)
    comm8 = flat_mesh(N, "cpu", "dp")
    state, _ = _run(comm8, tc)
    pack8, unpack8 = _hooks(comm8, tc)
    cons = pack8(state)
    assert _same(pack8(unpack8(cons)), cons)
    assert _same(unpack8(cons), state)  # the live shards, bitwise
    comm4 = flat_mesh(4, "cpu", "dp")
    pack4, unpack4 = _hooks(comm4, tc)
    four = unpack4(cons)
    assert four["mu_shard"]["embed"].shape == (64 * 32,)
    assert _same(pack4(four), cons)
    # and the 4-rank world trains on from it as the replicated step does
    rep = {k: cons[k] for k in ("params", "mu", "nu", "step")}
    a, la = _run(comm4, tc, steps=1, state=four)
    b, lb = _run(comm4, ttrain.TrainConfig(grad_topo="4,2"), steps=1,
                 state=rep)
    assert torch.equal(la[0], lb[0]) and _same(pack4(a), b)


def test_fit_checkpoints_consolidated_and_resumes(tmp_path):
    """``fit`` with the trainer's hooks: the file is the consolidated
    state; a resumed run ends bitwise where a straight run ends; the file
    resumes on the replicated step."""

    class Data:
        def batch_at(self, step):
            return _batch(50 + step)

    comm = flat_mesh(4, "cpu", "dp")
    tc = ttrain.TrainConfig(shard_optimizer=True)
    pack, unpack = _hooks(comm, tc)
    step = ttrain.make_train_step(_cfg(), tc, device="cpu", comm=comm)

    def fresh():
        return ttrain.init_train_state(_cfg(), torch.Generator().manual_seed(
            0), tc, device="cpu", comm=comm)

    def run(steps, ckpt):
        return fit(fresh(), step, Data(), FitConfig(
            num_steps=steps, ckpt_dir=ckpt, ckpt_every=2, log_every=0,
            prefetch=0), state_pack=pack, state_unpack=unpack)

    straight = run(4, None).state
    ckpt = str(tmp_path / "ck")
    first = run(2, ckpt)
    saved = tckpt.restore_train_state(ckpt, "cpu")
    assert set(saved) == {"params", "mu", "nu", "step"}
    assert _same(saved, pack(first.state))
    resumed = run(4, ckpt)
    assert resumed.resumed_from == 2 and _same(resumed.state, straight)
    rep = fit(tckpt.restore_train_state(ckpt, "cpu"),
              ttrain.make_train_step(_cfg(), ttrain.TrainConfig(),
                                     device="cpu", comm=comm),
              Data(), FitConfig(num_steps=4, log_every=0, prefetch=0))
    assert _same(rep.state, pack(straight))


def test_int8_checkpoint_holds_the_first_ranks_ef(tmp_path):
    """The consolidated file holds rank 0's residual (the JAX package's
    ``device_get`` of the first device's) and, as params, the float32
    master; resumed, every rank starts from rank 0's residual: the next
    step is the live state's with rank 0's residual given to every rank,
    and not the live state's with each rank's own."""
    comm = flat_mesh(N, "cpu", "dp")
    tc = ttrain.TrainConfig(codec="int8", shard_optimizer=True)
    pack, unpack = _hooks(comm, tc)
    state, _ = _run(comm, tc)
    path = tckpt.save_train_state(tmp_path, pack(state))
    back = tckpt.restore_train_state(path, "cpu")
    assert _same(back["ef"], state["ef"][0])
    cons = pack(state)
    for a, b in zip(ttrain.tree_leaves(back["params"]),
                    ttrain.tree_leaves(cons["params"])):
        assert torch.equal(a, b)  # the master, not the working params
    live = dict(state, params=cons["params"])
    lost, _ = _run(comm, tc, steps=1, seed=32,
                   state=dict(live, ef=[state["ef"][0]] * N))
    kept, _ = _run(comm, tc, steps=1, state=live, seed=32)
    resumed, _ = _run(comm, tc, steps=1, state=unpack(back), seed=32)
    assert _same(resumed, lost) and not _same(resumed, kept)


# ------------------------------------------------------------------ gloo


def test_gloo_ranks_end_in_the_mesh_state():
    """One spawn of 2 gloo processes: each rank's sharded state (its own
    block of every shard buffer, the tails and params whole) and losses
    bitwise the in-process mesh's."""
    tc = dict(grad_topo="1", shard_optimizer=True)
    batches = [_batch(30 + i) for i in range(2)]
    got = launch.spawn(dist_train_steps, 2, (DIMS, tc, batches, 0),
                       backend="gloo", timeout=120)
    state, losses = _run(flat_mesh(2, "cpu", "dp"),
                         ttrain.TrainConfig(**tc))
    for r, (digests, rank_losses) in enumerate(got):
        mine = {}
        for key, tree in state.items():
            if key.endswith("_shard"):
                tree = ttrain.tree_map(
                    lambda t: t.view(2, -1)[r], tree)
            mine[key] = tree
        assert digests == [digest(t) for t in ttrain.tree_leaves(mine)]
        assert rank_losses == [float(x) for x in losses]
