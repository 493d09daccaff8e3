"""ZeRO-1's layout, wire and phase programs (``parallel/zero.py``,
``analysis/schedule_check.py``) against the JAX package's, and the port's
split collectives against its own replicated sync.

- Exact: ``build_zero_layout`` field for field at dp 2, 4 and 8 on a model
  whose leaves have tails and, at dp 8, no head (``tile == 0``);
  ``zero_shard_bytes``, lossy and not; ``perm_for`` under ``8``, ``4,2``,
  ``2,2,2``, the ring, the ``"psum"`` sentinel and lonely shapes;
  ``plan_buckets(sharded=True)`` with one cost-parameter set on both sides.
- The wire, on the same per-rank gradients (8 ranks, a (8, 1, 1) mesh on
  both sides): each rank's owned block bitwise JAX's on the width-2 tree
  and the ring (where ``test_torch_allreduce.py`` holds the allreduce's
  head bitwise), within the fold-order bound N·u·Σ|x| on the wider trees
  and on the tails (JAX's are XLA's ``psum``); under int8, op by op
  (``jax.disable_jit``), the blocks and each rank's residual bitwise.
- The port alone: each leaf's shard gathered back (``all_gather`` of block
  and tail) is bitwise the replicated bucketed sync; the fold stages
  ``sync_fold_stages(sharded=True)`` derives are the ones the sync runs;
  error feedback's running mean on the sharded int8 wire converges.
- The phase programs of the standalone reduce-scatter and all-gather equal
  JAX's on every row of the default matrix; the split-schedule check is
  green; a tampered ownership and a tampered closure are caught.

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

from flextree_tpu_torch.analysis import schedule_check as tsc
from flextree_tpu_torch.models import transformer as tt
from flextree_tpu_torch.parallel import allreduce as tar
from flextree_tpu_torch.parallel import bucketing as tb
from flextree_tpu_torch.parallel import compressed as tc
from flextree_tpu_torch.parallel import train as ttrain
from flextree_tpu_torch.parallel import zero as tz
from flextree_tpu_torch.parallel.mesh import flat_mesh
from flextree_tpu_torch.planner import cost_model as tcost
from flextree_tpu_torch.schedule import stages as tstages

jt = importlib.import_module("flextree_tpu.models.transformer")
jtrain = importlib.import_module("flextree_tpu.parallel.train")
jz = importlib.import_module("flextree_tpu.parallel.zero")
jb = importlib.import_module("flextree_tpu.parallel.bucketing")
jcost = importlib.import_module("flextree_tpu.planner.cost_model")
jstages = importlib.import_module("flextree_tpu.schedule.stages")
jsc = importlib.import_module("flextree_tpu.analysis.schedule_check")
jflat_mesh = importlib.import_module("flextree_tpu.parallel.mesh").flat_mesh

AXES = ("dp", "sp", "tp")
DIMS = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
# at dp=8: the embedding (50 x 6) and w1/w2 (6 x 10) have tails, the norm
# scales (6) have no head
ODD = dict(vocab_size=50, d_model=6, n_heads=2, n_layers=1, d_ff=10)
N = 8
U = 2.0 ** -24  # float32 unit roundoff


def _shapes(dims):
    """The JAX params' abstract shapes and the port's as meta tensors."""
    jshapes = jax.eval_shape(lambda k: jt.init_params(
        k, jt.TransformerConfig(**dims)), jax.random.PRNGKey(0))
    tshapes = jax.tree.map(lambda s: torch.empty(s.shape, device="meta"),
                           jshapes)
    return jshapes, tshapes


def _specs(dims):
    return (jt.param_specs(jt.TransformerConfig(**dims), "tp"),
            tt.param_specs(tt.TransformerConfig(**dims)))


def _params(pkg, launch_us=2.0):
    """Cost params with the same numbers in either package (their defaults
    differ: a TPU's there, an H100's here)."""
    return pkg.TpuCostParams(
        ici=pkg.LinkParams(bandwidth_GBps=45.0, latency_us=1.0),
        reduce_bw_GBps=300.0, control_us_per_width=0.05,
        launch_us=launch_us, codec_bw_GBps=60.0)


# ---------------------------------------------------------------- layout


@pytest.mark.parametrize("dims", [DIMS, ODD], ids=["small", "odd"])
@pytest.mark.parametrize("dp", [2, 4, 8])
def test_layout_and_bytes_match_jax(dims, dp):
    jshapes, tshapes = _shapes(dims)
    jspecs, tspecs = _specs(dims)
    sizes = {"dp": dp, "sp": 1, "tp": 1}
    want = jz.build_zero_layout(jshapes, jspecs, AXES, sizes)
    got = tz.build_zero_layout(tshapes, tspecs, AXES, sizes)
    assert got.mesh_axes == want.mesh_axes
    assert dict(got.axis_sizes) == dict(want.axis_sizes)
    assert [dataclasses.astuple(leaf) for leaf in got.leaves] == \
        [dataclasses.astuple(leaf) for leaf in want.leaves]
    assert got.n_sharded == want.n_sharded == len(got.leaves)
    for lossy in (False, True):
        assert tz.zero_shard_bytes(got, lossy) == \
            jz.zero_shard_bytes(want, lossy)
    if dims is ODD and dp == 8:
        assert any(leaf.tail and leaf.tile for leaf in got.leaves)
        assert any(leaf.tile == 0 for leaf in got.leaves)
    # one rank: every leaf unsharded, its whole moments in *_rep
    one = ttrain.zero_layout_for(None, tshapes, tspecs)
    assert not one.n_sharded and all(leaf.n == 1 for leaf in one.leaves)


@pytest.mark.parametrize("n,spec", [(8, "8"), (8, "4,2"), (8, "2,2,2"),
                                    (8, "1"), (8, "psum"), (7, "3,2+1"),
                                    (7, "6+1"), (4, "2,2"), (1, "1")])
def test_perm_for_matches_jax(n, spec):
    jshapes, tshapes = _shapes(DIMS)
    jspecs, tspecs = _specs(DIMS)
    sizes = {"dp": n, "sp": 1, "tp": 1}
    topo = None if spec == "psum" else spec
    want = jz.build_zero_layout(jshapes, jspecs, AXES, sizes).perm_for(
        {"dp": topo}, "dp")
    got = tz.build_zero_layout(tshapes, tspecs, AXES, sizes).perm_for(
        {"dp": topo}, "dp")
    assert got == want
    assert sorted(got) == list(range(n))
    if spec in ("4,2", "2,2,2"):
        assert got != tuple(range(n))  # the permutation is not the identity


@pytest.mark.parametrize("codec", [None, "int8"])
@pytest.mark.parametrize("launch_us", [1e6, 2.0, 1e-3])
@pytest.mark.parametrize("grad_topo", [None, "2,2,2", "psum"])
def test_sharded_plan_buckets_match_jax(codec, launch_us, grad_topo):
    jshapes, tshapes = _shapes(DIMS)
    jspecs, tspecs = _specs(DIMS)
    sizes = {"dp": N, "sp": 1, "tp": 1}

    def topos(stages):
        return {"dp": None if grad_topo == "psum" else
                stages.Topology.resolve(N, grad_topo), "sp": None,
                "tp": None}

    jq = importlib.import_module("flextree_tpu.ops.quantize")
    from flextree_tpu_torch.ops import quantize as tq

    kw = dict(axis_sizes=sizes, max_bucket_bytes=1 << 20, sharded=True)
    want = jb.plan_buckets(
        jax.tree.leaves(jshapes), jax.tree.leaves(
            jspecs, is_leaf=lambda x: isinstance(x, P)), AXES,
        topos=topos(jstages), params=_params(jcost, launch_us),
        codec=jq.get_codec(codec) if codec else None, **kw)
    leaves = ttrain.tree_leaves(tshapes)
    got = tb.plan_buckets(
        leaves, tb.spec_leaves(tshapes, tspecs), AXES, topos=topos(tstages),
        params=_params(tcost, launch_us),
        codec=tq.get_codec(codec) if codec else None, **kw)
    assert [(b.axes, b.dtype, b.indices, b.nbytes) for b in got] == \
        [(b.axes, b.dtype, b.indices, b.nbytes) for b in want]
    assert got


# ------------------------------------------------------------------ wire


def _grads(dims, seed, n=N):
    """Each rank's gradient tree as numpy, (n, *shape) a leaf."""
    jshapes, _ = _shapes(dims)
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: rng.standard_normal(
        (n,) + tuple(s.shape)).astype(np.float32), jshapes)


def _port_trees(stacked, n=N):
    return [jax.tree.map(lambda a: torch.from_numpy(a[r].copy()), stacked)
            for r in range(n)]


def _jax_zero_rs(dims, stacked, grad_topo, n, codec="f32", step=0,
                 bucket_bytes=2048):
    """The JAX ``zero_reduce_scatter_grads`` over a mesh of one ``dp``
    axis of n devices (the (n, 1, 1) mesh's only axis above size 1): each
    rank's [tiles, tails(, residuals)], one (n, ...) array a leaf."""
    mesh = jflat_mesh(n, "dp")
    jspecs = jt.param_specs(jt.TransformerConfig(**dims), "tp")
    topos = jtrain.resolve_axis_topos(mesh, ("dp",), grad_topo)
    lossy = codec != "f32"

    def body(tree):
        grads = jax.tree.map(lambda a: a[0], tree)
        got = jz.zero_reduce_scatter_grads(
            grads, jspecs, ("dp",), topos, bucket_bytes=bucket_bytes,
            codec=codec, step=step, return_residual=lossy)
        shards, res = got if lossy else (got, None)
        flat = jax.tree.leaves(shards,
                               is_leaf=lambda x: isinstance(x, jz.ZeroShard))
        out = ([s.tile[None] for s in flat], [s.tail[None] for s in flat])
        if lossy:
            out += ([r[None] for r in jax.tree.leaves(res)],)
        return out

    fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P("dp"),),
                               out_specs=P("dp"), check_vma=False))
    return [[np.array(a) for a in part] for part in fn(
        jax.tree.map(jnp.asarray, stacked))]


def _port_zero_rs(dims, stacked, grad_topo, n, codec="f32", step=0,
                  bucket_bytes=2048):
    """The port's ``zero_reduce_scatter_grads`` on ``flat_mesh(n)``, in
    :func:`_jax_zero_rs`' form."""
    comm = flat_mesh(n, "cpu", "dp")
    tspecs = tt.param_specs(tt.TransformerConfig(**dims))
    topos = ttrain.resolve_axis_topos(comm, AXES, grad_topo)
    lossy = codec != "f32"
    got = tz.zero_reduce_scatter_grads(
        _port_trees(stacked, n), tspecs, AXES, topos, comm=comm,
        bucket_bytes=bucket_bytes, codec=codec, step=step,
        return_residual=lossy)
    shards, res = got if lossy else (got, None)
    flat = [ttrain.tree_leaves(t) for t in shards]
    out = [[np.stack([f[i].tile.numpy() for f in flat])
            for i in range(len(flat[0]))],
           [np.stack([f[i].tail.numpy() for f in flat])
            for i in range(len(flat[0]))]]
    if lossy:
        rflat = [ttrain.tree_leaves(t) for t in res]
        out.append([np.stack([f[i].numpy() for f in rflat])
                    for i in range(len(rflat[0]))])
    return out


@pytest.mark.parametrize("grad_topo,bitwise", [
    ("2,2,2", True), ({"dp": "1"}, True), (None, False), ("4,2", False)],
    ids=["2,2,2", "ring", "flat", "4,2"])
def test_reduce_scatter_shards_match_jax(grad_topo, bitwise):
    stacked = _grads(ODD, 1)
    want = _jax_zero_rs(ODD, stacked, grad_topo, N)
    got = _port_zero_rs(ODD, stacked, grad_topo, N)
    leaves = jax.tree.leaves(stacked)
    for part, (w_part, g_part) in enumerate(zip(want, got)):
        for x, w, g in zip(leaves, w_part, g_part):
            assert w.shape == g.shape
            if not w.size:
                continue
            if bitwise and part == 0:
                assert w.tobytes() == g.tobytes()
            else:
                bound = N * U * float(np.abs(x).sum(0).max())
                assert np.abs(w.astype(np.float64) - g).max() <= bound


def test_int8_shards_and_residuals_bitwise_jax_op_by_op():
    """On 2 ranks (the width-2 tree), a tree whose leaves have tails, in
    one bucket: the bucket's heads block-interleaved (JAX's
    ``_interleave_pack``) through the int8 tree walk of JAX's
    ``compressed_reduce_scatter`` (the wire ``zero_reduce_scatter_grads``
    delegates to; the packed bucket is all head) op by op give each rank's
    owned blocks and residual the port's bits; the tails (one dense fold of
    two ranks) too.  The walk is called directly, with the residual
    ``head - own0`` its caller forms: under ``jax.disable_jit`` the
    caller's scatter of that residual into a zero buffer trips a sharding
    assertion of JAX's eager ``shard_map``."""
    jc = importlib.import_module("flextree_tpu.parallel.compressed")
    jq = importlib.import_module("flextree_tpu.ops.quantize")
    n, step = 2, 3
    dims = dict(vocab_size=7, d_model=4, n_heads=2, n_layers=1, d_ff=5)
    stacked = _grads(dims, 2, n=n)
    leaves = jax.tree.leaves(stacked)
    heads = [(a[0].size // n) * n for a in leaves]
    fused = np.stack([np.array(jz._interleave_pack(
        [jnp.asarray(a[r].reshape(-1)[:h]) for a, h in zip(leaves, heads)
         if h], n)) for r in range(n)])

    def body(row):
        head = row[0]
        shard, own0 = jc._tree_rs_int8_all_stages(
            head, "ft", jstages.Topology.resolve(n, "2"),
            jq.get_codec("int8"), step)
        return shard[None], (head - own0)[None]

    with jax.disable_jit():
        shards, res = (np.array(a) for a in jax.shard_map(
            body, mesh=jflat_mesh(n, "ft"), in_specs=P("ft"),
            out_specs=P("ft"), check_vma=False)(jnp.asarray(fused)))
    got_tiles, got_tails, got_res = _port_zero_rs(
        dims, stacked, "2", n, codec="int8", step=step, bucket_bytes=1 << 20)
    widths = [h // n for h in heads if h]
    cuts = np.cumsum([0] + widths)
    k = 0
    for i, (a, h) in enumerate(zip(leaves, heads)):
        for r in range(n):
            want_res = np.zeros(a[r].size, np.float32)
            if h:
                want_res[:h] = res[r].reshape(n, -1)[:, cuts[k]:cuts[k + 1]] \
                    .reshape(-1)
                assert shards[r][cuts[k]:cuts[k + 1]].tobytes() == \
                    got_tiles[i][r].tobytes()
            assert want_res.reshape(a[r].shape).tobytes() == \
                got_res[i][r].tobytes()
            tail = (a[0].reshape(-1)[h:] + a[1].reshape(-1)[h:])
            assert tail.tobytes() == got_tails[i][r].tobytes()
        k += bool(h)
    assert any(r.any() for r in got_res)


# ------------------------------------------------------ the port alone


def _odd_trees(n, seed):
    """Each of ``n`` ranks' gradient tree of the odd model (tails, and
    leaves with no head at 8 ranks), as tensors."""
    return _port_trees(_grads(ODD, seed, n), n)


@pytest.mark.parametrize("n,spec", [(8, "8"), (8, "4,2"), (8, "2,2,2"),
                                    (8, "1"), (4, "2,2"), (2, "2")])
def test_gathered_shards_are_the_replicated_sync_bitwise(n, spec):
    """Each leaf's block and tail, all-gathered on the shard topology (what
    the consolidated checkpoint does), are bitwise the replicated bucketed
    sync of the same gradients, on every rank; the ring and ``4,2`` give
    the ranks blocks out of order."""
    comm = flat_mesh(n, "cpu", "dp")
    specs = tt.param_specs(tt.TransformerConfig(**ODD))
    topos = ttrain.resolve_axis_topos(comm, AXES, spec)
    trees = _odd_trees(n, 3)
    synced = ttrain.sync_grads(trees, specs, AXES, topos, bucket_bytes=None,
                               comm=comm)
    shards = tz.zero_reduce_scatter_grads(trees, specs, AXES, topos,
                                          comm=comm, bucket_bytes=1024)
    topo = tz.shard_topo(topos["dp"], n)
    for i, leaf in enumerate(ttrain.tree_leaves(trees[0])):
        rows = [ttrain.tree_leaves(t)[i] for t in shards]
        back = tar.all_gather([torch.cat([s.tile, s.tail]) for s in rows],
                              comm, topo, out_shape=leaf.shape)
        for r in range(n):
            want = ttrain.tree_leaves(synced[r])[i]
            assert torch.equal(back[r], want), (i, r)


@pytest.mark.parametrize("codec", [None, "bf16", "int8"])
@pytest.mark.parametrize("spec", ["8", "4,2", "1", "psum", "3,2+1"])
def test_sharded_fold_stages_are_the_ones_the_sync_runs(codec, spec,
                                                        monkeypatch):
    """Every ``reduce_sources`` call of the sharded sync, as (folds, W, L),
    is the list ``sync_fold_stages(sharded=True)`` derives from the plan:
    what the card's launch counts are checked against."""
    from flextree_tpu_torch.ops import quantize as tq

    n = 7 if "+" in spec else 8
    comm = flat_mesh(n, "cpu", "dp")
    specs = tt.param_specs(tt.TransformerConfig(**ODD))
    topos = ttrain.resolve_axis_topos(comm, AXES, spec)
    trees = _odd_trees(n, 4)
    seen = []
    real = tar.reduce_sources

    def probe(folds, op="sum", sources_tile=1):
        folds = [(list(src), out) for src, out in folds]
        seen.append((len(folds), len(folds[0][0]), folds[0][1].numel()))
        return real(folds, op, sources_tile)

    monkeypatch.setattr(tar, "reduce_sources", probe)
    monkeypatch.setattr(tc, "reduce_sources", probe)
    leaves = ttrain.tree_leaves(trees[0])
    c = tq.get_codec(codec)
    plan = tb.plan_buckets(leaves, tb.spec_leaves(trees[0], specs), AXES,
                           topos=topos, axis_sizes={"dp": n, "sp": 1,
                                                    "tp": 1},
                           bucket_bytes=1024, codec=c if c.lossy else None,
                           sharded=True)
    tz.zero_reduce_scatter_grads(trees, specs, AXES, topos, comm=comm,
                                 bucket_bytes=1024, codec=c, step=2,
                                 return_residual=c.lossy)
    want = tb.sync_fold_stages([g.numel() for g in leaves], n, topos["dp"],
                               plan, codec=c, sharded=True)
    assert len(plan) > 1 and seen == want


def test_sharded_ef_running_mean_converges():
    """Error feedback on the split int8 wire (JAX
    ``TestShardedErrorFeedback``): sync ``g + e`` by the reduce-scatter
    with the wire's residual, then the all-gather, and carry ``e``; the
    running mean of the gathered result tends to the exact ``N * g``."""
    rng = np.random.default_rng(3)
    g = torch.from_numpy(rng.standard_normal(2048).astype(np.float32))
    exact = N * g.double()
    comm = flat_mesh(N, "cpu", "ft")
    e = torch.zeros_like(g)
    acc = torch.zeros_like(exact)
    errs = {}
    for step in range(1, 25):
        shards, res = tc.compressed_reduce_scatter(
            [g + e] * N, comm, "8", "int8", step, return_residual=True)
        out = tc.compressed_all_gather(shards, comm, "8", g.shape, "int8",
                                       step)
        assert all(torch.equal(o, out[0]) for o in out)
        acc += out[0].double()
        e = res[0]
        errs[step] = float((acc / step - exact).abs().max())
    assert errs[24] < errs[1] / 4
    assert float(e.abs().max()) <= float((g + e).abs().max()) / 127 + 1e-6


# ------------------------------------------------------- phase programs


def _program(prog):
    """A phase program as plain data, comparable across the packages."""
    return (prog.num_nodes, prog.kind, prog.num_stages, prog.chunks,
            list(prog.chunk_spans), prog.head_elems, prog.phase_only,
            prog.watchdogged,
            {r: [(ps.rank, [(h.kind, h.peer, tuple(h.blocks))
                            for h in ps.halves], ps.chunk, ps.phase,
                  ps.stage) for ps in posts]
             for r, posts in sorted(prog.posts.items())})


@pytest.mark.parametrize("phase", ["rs", "ag"])
@pytest.mark.parametrize("spec,n,count", tsc.default_phase_matrix())
def test_phase_programs_match_jax(spec, n, count, phase):
    assert tsc.default_phase_matrix() == jsc.default_phase_matrix()
    prog = tsc.build_phase_program(tstages.Topology.resolve(n, spec), phase,
                                   count=count)
    want = jsc.build_phase_program(jstages.Topology.resolve(n, spec), phase,
                                   count=count)
    assert _program(prog) == _program(want)
    assert not tsc.check_phase_program(prog,
                                       tstages.Topology.resolve(n, spec))


def test_split_schedules_green_and_tampering_caught():
    """The JAX ``TestSplitScheduleVerifier``: the default matrix is clean,
    and an rs program whose stage-1 send lost its blocks, or an ag program
    whose recv lost them, is caught."""
    vs, programs = tsc.check_split_schedules()
    assert programs >= 16 and not vs
    topo = tstages.Topology(8, (4, 2))
    prog = tsc.build_phase_program(topo, "rs", count=64)
    ps = [p for p in prog.posts[0] if p.stage == 1][0]
    for i, h in enumerate(ps.halves):
        if h.kind == tsc.SEND:
            ps.halves[i] = tsc.Half(tsc.SEND, h.peer, ())
            break
    assert any(v.kind in ("shard-ownership", "dropped-block",
                          "asymmetric-match")
               for v in tsc.check_phase_program(prog, topo))
    topo = tstages.Topology(8, (2, 2, 2))
    prog = tsc.build_phase_program(topo, "ag", count=64)
    for ps in prog.posts[3]:
        for i, h in enumerate(ps.halves):
            if h.kind == tsc.RECV:
                ps.halves[i] = tsc.Half(tsc.RECV, h.peer, ())
                break
        break
    assert any(v.kind in ("dropped-block", "asymmetric-match")
               for v in tsc.check_phase_program(prog, topo))
