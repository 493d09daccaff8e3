"""The port's bucketed gradient sync (``flextree_tpu_torch.parallel.
bucketing``), its spans (``utils.profiling``) and provenance
(``obs.provenance``) against the JAX package's, and against its own
per-leaf sync.

- ``plan_buckets`` equals the JAX plan field for field on the same leaf
  sizes, dtypes, specs, axis sizes and ``bucket_bytes``; planner-sized
  buckets use explicit cost params with the same numbers on both sides.
- The bucketed sync is bitwise the per-leaf sync (the contract the JAX
  package's ``tests/test_bucketing.py:234-290`` pins), on 8 in-process
  CPU ranks (5 and 7 for the lonely shapes): flat, tree, ring, lonely and
  the ``"psum"`` sentinel, float32 and bfloat16, leaves with tails,
  ``chunks`` 1 and 2, a mixed-spec tree; and it makes the fold calls
  ``sync_fold_stages`` derives.
- Against the JAX ``sync_grads`` on an 8-device CPU mesh: bitwise on
  integer-valued float32 and bfloat16 (every sum exact), within
  N·u·Σ|x| on random float32 (the JAX tree stages are XLA's
  ``psum_scatter``, whose fold order is XLA's).

The suite runs JAX with ``jax_enable_x64``: every input is an explicit
float32 / bfloat16 array.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from flextree_tpu_torch.obs import flight_recorder, topo_spec
from flextree_tpu_torch.ops import quantize as tq
from flextree_tpu_torch.obs import provenance as tprov
from flextree_tpu_torch.parallel import allreduce as tar
from flextree_tpu_torch.parallel import bucketing as tb
from flextree_tpu_torch.parallel import train as ttrain
from flextree_tpu_torch.parallel.mesh import Mesh, flat_mesh
from flextree_tpu_torch.planner import cost_model as tcost
from flextree_tpu_torch.planner.calibrate import default_params
from flextree_tpu_torch.schedule import stages as tstages
from flextree_tpu_torch.utils import profiling as tprof
from flextree_tpu_torch.utils import tree as ttree

jb = importlib.import_module("flextree_tpu.parallel.bucketing")
jtrain = importlib.import_module("flextree_tpu.parallel.train")
jcost = importlib.import_module("flextree_tpu.planner.cost_model")
jstages = importlib.import_module("flextree_tpu.schedule.stages")
jprov = importlib.import_module("flextree_tpu.obs.provenance")
jq = importlib.import_module("flextree_tpu.ops.quantize")
jrecorder = importlib.import_module("flextree_tpu.obs.recorder")

AXES = ("dp", "sp", "tp")
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# odd sizes put a tail on every topology, scalars make pure-tail leaves,
# bfloat16 a second group
LEAVES = [((17,), "float32"), ((3, 3), "float32"), ((16,), "float32"),
          ((5,), "bfloat16"), ((1,), "float32"), ((2, 2), "bfloat16"),
          ((31,), "bfloat16"), ((4, 8), "float32")]


def _params(pkg, launch_us, bw_GBps=45.0):
    """Cost params with the same numbers in either package (their
    defaults differ: a TPU's there, an H100's here)."""
    return pkg.TpuCostParams(
        ici=pkg.LinkParams(bandwidth_GBps=bw_GBps, latency_us=1.0),
        reduce_bw_GBps=300.0, control_us_per_width=0.05,
        launch_us=launch_us, codec_bw_GBps=60.0)


def _jspec(spec):
    return P() if spec is None else P(*spec)


# ---------------------------------------------------------------- plans


@pytest.mark.parametrize("spec", [None, (), (None, "tp"), ("tp", ("dp", "sp")),
                                  (("sp",), None, "dp"), (("dp", "sp"), "tp")])
@pytest.mark.parametrize("axes", [AXES, ("tp", "sp", "dp")])
def test_spec_axes_and_replication_key_match_jax(spec, axes):
    assert tb.spec_axes(spec) == jb.spec_axes(_jspec(spec))
    assert tb.replication_key(spec, axes) == jb.replication_key(_jspec(spec),
                                                                axes)


_SPECS = [None, None, (None, "tp"), None, ("tp",), (None, "tp"), None,
          (("dp", "sp"), "tp")]


@pytest.mark.parametrize("sizes", [dict(dp=8, sp=1, tp=1),
                                   dict(dp=2, sp=2, tp=2)],
                         ids=["dp8", "222"])
@pytest.mark.parametrize("bucket_bytes,launch_us", [
    (None, 1e6), (None, 1e-3), (64, None), (100, None), (1 << 30, None)],
    ids=["planner-one", "planner-many", "cap64B", "cap100B", "one-bucket"])
@pytest.mark.parametrize("grad_topo", [None, "psum", "1"],
                         ids=["flat", "psum", "ring"])
def test_plan_buckets_matches_jax(sizes, bucket_bytes, launch_us, grad_topo):
    tleaves = [torch.empty(s, dtype=TORCH_DT[d], device="meta")
               for s, d in LEAVES]
    jleaves = [jax.ShapeDtypeStruct(s, jnp.dtype(d)) for s, d in LEAVES]

    def topos(stages):
        return {ax: None if grad_topo == "psum" else
                stages.Topology.resolve(n, grad_topo)
                for ax, n in sizes.items()}

    kw = dict(axis_sizes=sizes, bucket_bytes=bucket_bytes,
              max_bucket_bytes=1 << 20)
    got = tb.plan_buckets(
        tleaves, _SPECS, AXES, topos=topos(tstages),
        params=_params(tcost, launch_us) if launch_us else None, **kw)
    want = jb.plan_buckets(
        jleaves, [_jspec(s) for s in _SPECS], AXES, topos=topos(jstages),
        params=_params(jcost, launch_us) if launch_us else None, **kw)
    assert [(b.axes, b.dtype, b.indices, b.nbytes) for b in got] == \
        [(b.axes, b.dtype, b.indices, b.nbytes) for b in want]
    assert got  # every case plans something


def test_flagship_plan_matches_jax_and_the_caps_do():
    """The flagship gradient's 34 leaves (port order) on 8 ranks with the
    card's cap: two buckets, split where the planner's size falls."""
    assert tb.DEFAULT_MAX_BUCKET_BYTES == jb.DEFAULT_MAX_BUCKET_BYTES
    assert tb.CPU_MAX_BUCKET_BYTES == jb.CPU_MAX_BUCKET_BYTES
    d, ff = 512, 2048
    layer = [(d,), (d, d), (d, d), (d, d), (d, d), (d,), (d, ff), (ff, d)]
    shapes = [(8192, d), (d,)] + layer * 4
    tleaves = [torch.empty(s, device="meta") for s in shapes]
    jleaves = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    kw = dict(axis_sizes={"dp": 8}, max_bucket_bytes=tb.DEFAULT_MAX_BUCKET_BYTES)
    got = tb.plan_buckets(tleaves, [None] * 34, ("dp",),
                          topos={"dp": tstages.Topology.flat(8)},
                          params=_params(tcost, 30.0), **kw)
    want = jb.plan_buckets(jleaves, [P()] * 34, ("dp",),
                           topos={"dp": jstages.Topology.flat(8)},
                           params=_params(jcost, 30.0), **kw)
    assert [(b.indices, b.nbytes) for b in got] == \
        [(b.indices, b.nbytes) for b in want]
    assert sum(b.nbytes for b in got) == 67_127_296
    # a planner-sized bucket on host leaves takes the host's cap
    host = tb.plan_buckets([torch.empty(s) for s in shapes], [None] * 34,
                           ("dp",), topos={"dp": tstages.Topology.flat(8)},
                           axis_sizes={"dp": 8})
    assert max(b.nbytes for b in host if len(b.indices) > 1) <= \
        tb.CPU_MAX_BUCKET_BYTES


@pytest.mark.parametrize("sharded", [False, True])
def test_a_plans_cap_plans_it_again_on_host_leaves(sharded):
    """Each bucket carries the size its group packed to: the card's
    derived plan, its ``cap`` passed back as ``bucket_bytes``, plans host
    leaves to the same buckets, where the host's own cap would not."""
    d, ff = 512, 2048
    layer = [(d,), (d, d), (d, d), (d, d), (d, d), (d,), (d, ff), (ff, d)]
    shapes = [(8192, d), (d,)] + layer * 4
    kw = dict(topos={"dp": tstages.Topology.flat(2)}, axis_sizes={"dp": 2},
              sharded=sharded)
    card = tb.plan_buckets([torch.empty(s, device="meta") for s in shapes],
                           [None] * 34, ("dp",),
                           max_bucket_bytes=tb.DEFAULT_MAX_BUCKET_BYTES, **kw)
    (cap,) = {b.cap for b in card}
    host = [torch.empty(s) for s in shapes]
    assert tb.plan_buckets(host, [None] * 34, ("dp",), bucket_bytes=cap,
                           **kw) == card
    assert tb.plan_buckets(host, [None] * 34, ("dp",), **kw) != card


# ------------------------------------------------------- bitwise identity


def _trees(n, leaves, seed, integers=False):
    """``n`` per-rank dict trees from numpy seeds (integer-valued when
    ``integers``, so every sum is exact)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tree = {}
        for i, (shape, dtype) in enumerate(leaves):
            x = (rng.integers(-8, 9, shape) if integers
                 else rng.standard_normal(shape)).astype(np.float32)
            tree[f"leaf{i}"] = torch.from_numpy(x).to(TORCH_DT[dtype])
        out.append(tree)
    return out


def _bits(t):
    return t.contiguous().view(torch.uint8)


def _assert_bitwise(a_trees, b_trees):
    for ta, tbb in zip(a_trees, b_trees):
        for a, b in zip(ttrain.tree_leaves(ta), ttrain.tree_leaves(tbb)):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(_bits(a), _bits(b)), "not bitwise identical"


def _sync(mesh, trees, grad_topo, bucket_bytes, chunks=1, specs=None,
          axes=AXES):
    topos = ttrain.resolve_axis_topos(mesh, axes, grad_topo)
    return ttrain.sync_grads(trees, specs, axes, topos,
                             bucket_bytes=bucket_bytes, chunks=chunks,
                             comm=mesh)


@pytest.mark.parametrize("topo", [None, "4,2", "2,2,2", "1", "psum"],
                         ids=["flat", "tree42", "tree222", "ring", "psum"])
@pytest.mark.parametrize("bucket_bytes", [None, 64, 1 << 30],
                         ids=["planner", "cap64B", "one-bucket"])
def test_bucketed_sync_bitwise_identical(topo, bucket_bytes):
    mesh = flat_mesh(8, "cpu", "dp")
    trees = _trees(8, LEAVES, 0)
    per_leaf = _sync(mesh, trees, topo, 0)
    fused = _sync(mesh, trees, topo, bucket_bytes)
    _assert_bitwise(per_leaf, fused)
    _assert_bitwise(per_leaf, [per_leaf[0]] * 8)  # every rank the same
    exact = _sync(mesh, _trees(8, LEAVES, 0, integers=True), topo,
                  bucket_bytes)[0]
    want = {k: sum(t[k].double() for t in _trees(8, LEAVES, 0, True))
            for k in exact}
    for k, v in exact.items():
        assert torch.equal(v.double(), want[k])


@pytest.mark.parametrize("n,topo", [(5, "4+1"), (7, "3,2+1")])
@pytest.mark.parametrize("bucket_bytes", [None, 1 << 30],
                         ids=["planner", "one-bucket"])
def test_bucketed_sync_bitwise_identical_lonely_fallback(n, topo,
                                                         bucket_bytes):
    mesh = flat_mesh(n, "cpu", "dp")
    trees = _trees(n, LEAVES, 1)
    _assert_bitwise(_sync(mesh, trees, topo, 0),
                    _sync(mesh, trees, topo, bucket_bytes))


@pytest.mark.parametrize("topo", [None, "4,2", "1"], ids=["flat", "tree42",
                                                         "ring"])
@pytest.mark.parametrize("chunks", [2, 3], ids=["c2", "c3"])
def test_bucketed_sync_bitwise_identical_chunked(topo, chunks):
    mesh = flat_mesh(8, "cpu", "dp")
    trees = _trees(8, LEAVES, 2)
    _assert_bitwise(_sync(mesh, trees, topo, 0),
                    _sync(mesh, trees, topo, 1 << 30, chunks=chunks))


def test_bucketed_sync_bitwise_identical_mixed_specs():
    """A (4, 1, 1) mesh: replicated, tp-sharded (synced over dp all the
    same) and dp-sharded (never synced) leaves, two dtype groups, tails."""
    mesh = Mesh(("cpu",) * 4, AXES, (4, 1, 1))
    leaves = [((16,), "float32"), ((4, 2), "float32"), ((4, 2), "float32"),
              ((6,), "bfloat16"), ((7,), "float32")]
    specs = {"leaf0": None, "leaf1": (None, "tp"), "leaf2": (("dp", "sp"), "tp"),
             "leaf3": (), "leaf4": (None,)}
    trees = _trees(4, leaves, 3)
    per_leaf = _sync(mesh, trees, "2,2", 0, specs=specs)
    fused = _sync(mesh, trees, "2,2", None, specs=specs)
    _assert_bitwise(per_leaf, fused)
    for r in range(4):  # the dp-sharded leaf is each rank's own
        assert torch.equal(fused[r]["leaf2"], trees[r]["leaf2"])
    assert not torch.equal(fused[0]["leaf2"], fused[1]["leaf2"])


@pytest.mark.parametrize("n,topo", [(8, None), (8, "4,2"), (8, "1"),
                                    (8, "psum"), (7, "3,2+1")])
@pytest.mark.parametrize("bucket_bytes,chunks", [(0, 1), (None, 1), (64, 1),
                                                 (None, 2)])
def test_sync_makes_the_fold_calls_sync_fold_stages_derives(
        monkeypatch, n, topo, bucket_bytes, chunks):
    """Each ``reduce_sources`` call (one launch a stage on the card) of a
    sync, in order, is a stage ``sync_fold_stages`` derives from the plan
    (what ``chip_smoke.py`` holds the card's launch counts to)."""
    calls = []
    real = tar.reduce_sources

    def counted(folds, rop):
        calls.append((len(folds), len(folds[0][0]), folds[0][1].numel()))
        return real(folds, rop)

    monkeypatch.setattr(tar, "reduce_sources", counted)
    mesh = flat_mesh(n, "cpu", "dp")
    trees = _trees(n, LEAVES, 4)
    _sync(mesh, trees, topo, bucket_bytes, chunks=chunks, axes=("dp",))
    axis = ttrain.resolve_axis_topos(mesh, ("dp",), topo)["dp"]
    leaves = ttrain.tree_leaves(trees[0])
    buckets = None if bucket_bytes == 0 else tb.plan_buckets(
        leaves, [None] * len(leaves), ("dp",), topos={"dp": axis},
        axis_sizes={"dp": n}, bucket_bytes=bucket_bytes)
    assert calls == tb.sync_fold_stages([g.numel() for g in leaves], n, axis,
                                        buckets, chunks)


# ------------------------------------------------------- against JAX


def _jax_sync(trees, grad_topo, bucket_bytes):
    """The JAX ``sync_grads`` on an 8-device CPU mesh, rank r's leaves
    from ``trees[r]`` (one row each of a (8, ...) stacked input)."""
    mesh = jax.make_mesh((8,), ("dp",), devices=jax.devices()[:8])
    topos = jtrain.resolve_axis_topos(mesh, ("dp",), grad_topo)
    keys = list(trees[0])
    stacked = {k: jnp.asarray(np.stack([
        t[k].float().numpy() for t in trees]).astype(np.float32)).astype(
        jnp.bfloat16 if trees[0][k].dtype == torch.bfloat16 else jnp.float32)
        for k in keys}
    io = {k: P("dp") for k in keys}

    def f(t):
        rows = {k: v[0] for k, v in t.items()}
        out = jtrain.sync_grads(rows, {k: P() for k in keys}, ("dp",), topos,
                                bucket_bytes=bucket_bytes)
        return {k: v[None] for k, v in out.items()}

    out = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(io,), out_specs=io,
                                check_vma=False))(stacked)
    return {k: np.array(jnp.asarray(v, jnp.float32)) for k, v in out.items()}


@pytest.mark.parametrize("topo", [None, "4,2", "2,2,2", "1", "psum"],
                         ids=["flat", "tree42", "tree222", "ring", "psum"])
def test_sync_matches_jax_sync_grads(topo):
    mesh = flat_mesh(8, "cpu", "dp")
    ints = _trees(8, LEAVES, 5, integers=True)
    got = _sync(mesh, ints, topo, None, axes=("dp",))
    want = _jax_sync(ints, topo, None)
    for r in range(8):
        for k, v in got[r].items():
            np.testing.assert_array_equal(v.float().numpy(), want[k][r])
    floats = [{k: v for k, v in t.items() if v.dtype == torch.float32}
              for t in _trees(8, LEAVES, 6)]
    got = _sync(mesh, floats, topo, None, axes=("dp",))
    want = _jax_sync(floats, topo, None)
    u = np.finfo(np.float32).eps / 2
    for k in floats[0]:
        abs_sum = sum(np.abs(t[k].numpy().astype(np.float64)) for t in floats)
        for r in range(8):
            gap = np.abs(got[r][k].numpy().astype(np.float64) - want[k][r])
            assert np.all(gap <= 8 * u * abs_sum), k


def test_dense_allreduce_is_the_rank_order_fold():
    """The ``"psum"`` sentinel's fold: every rank the left fold of all
    ranks' buffers in rank order, bitwise."""
    rng = np.random.default_rng(7)
    xs = [torch.from_numpy(rng.standard_normal(1003).astype(np.float32))
          for _ in range(8)]
    want = xs[0].clone()
    for x in xs[1:]:
        want = want + x
    for out in tar.dense_allreduce(xs, flat_mesh(8, "cpu"), "sum"):
        assert torch.equal(out, want)


# ---------------------------------------------------------- refusals


def test_unported_sync_configurations_raise():
    """The lossy codecs run now (within their bound: the bucketed lossy
    tests below); an unknown codec raises, as does an IR family; a mesh of
    two axes above size 1 syncs now."""
    mesh = flat_mesh(4, "cpu", "dp")
    trees = _trees(4, LEAVES[:2], 8)
    for codec in ("bf16", "int8"):
        out = ttrain.sync_grads(trees, codec=codec, comm=mesh)
        assert len(out) == 4 and set(out[0]) == set(trees[0])
    for codec in ("fp4", "identity"):
        with pytest.raises(ValueError, match="unsupported codec"):
            ttrain.sync_grads(trees, codec=codec, comm=mesh)
    with pytest.raises(tstages.TopologyError, match="IR families"):
        ttrain.resolve_axis_topos(mesh, AXES, "swing")
    with pytest.raises(tstages.TopologyError, match="IR families"):
        ttrain.resolve_axis_topos(mesh, AXES, {"dp": "gen:2,2@1"})
    # two axes above size 1 sync now, one walk an axis over its groups:
    # bucketed bitwise per-leaf, every rank the sum of all four
    two = Mesh(("cpu",) * 4, AXES, (2, 2, 1))
    per_leaf = ttrain.sync_grads(trees, bucket_bytes=0, comm=two)
    for a, b in zip(ttrain.sync_grads(trees, comm=two), per_leaf):
        assert all(torch.equal(x, y) for x, y in zip(
            ttrain.tree_leaves(a), ttrain.tree_leaves(b)))
    for k in trees[0]:
        want = sum(t[k].double() for t in trees)
        for out in per_leaf:
            assert torch.allclose(out[k].double(), want, rtol=1e-2,
                                  atol=1e-2)
    with pytest.raises(ValueError, match="do not span"):
        ttrain.sync_grads(trees, comm=flat_mesh(4, "cpu"))  # axis "ft"


@pytest.mark.parametrize("grad_topo", [None, "4,2", "1", "psum",
                                       {"dp": "2,2,2", "tp": "psum"}, "3"])
def test_resolve_axis_topos_matches_jax(grad_topo):
    got = ttrain.resolve_axis_topos(dict(dp=8, sp=1, tp=1), AXES, grad_topo)
    mesh = jax.make_mesh((8, 1, 1), AXES, devices=jax.devices()[:8])
    want = jtrain.resolve_axis_topos(mesh, AXES, grad_topo)
    assert {k: topo_spec(v) for k, v in got.items()} == \
        {k: jprov.topo_spec(v) for k, v in want.items()}


# ---------------------------------------------------- spans and provenance


def test_comm_span_feeds_ledger_profiler_and_recorder():
    with tprof.span_ledger() as outer, flight_recorder(None) as rec:
        with tprof.span_ledger() as inner:
            with torch.profiler.profile() as prof:
                with tprof.comm_span("ft_bucket0_dp_3leaves_128B"):
                    torch.ones(4).sum()
        with tprof.comm_span("ft_other_fooB"):
            pass
    assert inner.names == ("ft_bucket0_dp_3leaves_128B",)
    assert outer.names == ("ft_bucket0_dp_3leaves_128B", "ft_other_fooB")
    assert outer.total_bytes() == 128 and outer.total_bytes("ft_other") == 0
    assert any(e.name == "ft_bucket0_dp_3leaves_128B" for e in prof.events())
    kinds = [(e["kind"], e.get("bytes")) for e in rec.events]
    assert kinds == [("collective", 128), ("collective", None)]


@pytest.mark.parametrize("name", ["x_77B", "x_fooB", "x_8B_more", "ft_0B",
                                  "ft_bucket1_dp_2leaves_4096B", "x_0xB"])
def test_span_bytes_matches_jax(name):
    jprof = importlib.import_module("flextree_tpu.utils.profiling")
    assert tprof.span_bytes(name) == jprof.span_bytes(name)


@pytest.mark.parametrize("tree", [
    {"a": 1, "b": [2, (3, 4)], "c": {"d": 5}},
    [{"x": 1}, {"x": 2, "y": (3,)}],
    (1,),
])
def test_tree_helpers_keep_structure_and_order(tree):
    """``tree_leaves`` lists the leaves in ``tree_map`` order and
    ``tree_unflatten`` puts them back: the order the sync packs and
    unpacks a gradient tree's leaves in."""
    leaves = ttree.tree_leaves(tree)
    assert ttree.tree_unflatten(tree, leaves) == tree
    doubled = ttree.tree_map(lambda a, b: a + b, tree, tree)
    assert ttree.tree_leaves(doubled) == [2 * x for x in leaves]
    assert ttree.tree_unflatten(tree, range(len(leaves))) == \
        ttree.tree_map(lambda x: leaves.index(x), tree)


def test_bucketed_sync_spans_and_provenance():
    """One ``ft_bucket*`` span a bucket whose bytes sum to the tree's; with
    a recorder, each carries the plan's provenance (the JAX payload's
    fields, its prediction from the port's cost model); without one the
    provenance is None and the events are bare."""
    mesh = flat_mesh(8, "cpu", "dp")
    trees = _trees(8, LEAVES, 9)
    nbytes = sum(g.numel() * g.element_size()
                 for g in ttrain.tree_leaves(trees[0]))
    with tprof.span_ledger() as ledger, tprof.plan_capture() as bare:
        _sync(mesh, trees, "4,2", 64, axes=("dp",))
    assert bare == [] and ledger.total_bytes("ft_bucket") == nbytes
    assert len(ledger.names) == len(tb.plan_buckets(
        ttrain.tree_leaves(trees[0]), [None] * len(LEAVES), ("dp",),
        axis_sizes={"dp": 8}, bucket_bytes=64))
    with flight_recorder(None) as rec, tprof.plan_capture() as cap:
        _sync(mesh, trees, "4,2", 64, chunks=2, axes=("dp",))
    assert [n for n, _ in cap] == list(ledger.names)
    assert [e["name"] for e in rec.events
            if e["kind"] == "bucket_planned"] == list(ledger.names)
    topo = tstages.Topology.resolve(8, "4,2")
    with jrecorder.flight_recorder(None):
        for name, prov in cap:
            nb = tprof.span_bytes(name)
            want = jprov.bucket_provenance(
                ("dp",), {"dp": jstages.Topology.resolve(8, "4,2")}, nb,
                n_leaves=prov["n_leaves"], dtype=prov["dtype"], chunks=2)
            drop = ("predicted", "predicted_us")
            assert {k: v for k, v in prov.items() if k not in drop} == \
                {k: v for k, v in want.items() if k not in drop}
            cost = tcost.allreduce_cost(topo, nb, default_params())
            assert prov["predicted_us"] == round(cost.total_us, 3)
    assert tprov.bucket_provenance(("dp",), {"dp": topo}, 64) is None


# ------------------------------------------------------- lossy codecs


@pytest.mark.parametrize("launch_us", [1e6, 1e-3, 30.0])
@pytest.mark.parametrize("grad_topo", [None, "1", "3,2+1"],
                         ids=["flat", "ring", "lonely"])
def test_codec_aware_plan_matches_jax(launch_us, grad_topo):
    """``plan_buckets(codec="int8")`` equals the JAX plan for equal params,
    and the codec moves the chooser toward fewer, larger buckets (JAX
    ``test_codec_aware_bucket_sizing``)."""
    n = 7 if grad_topo == "3,2+1" else 8
    shapes = [(4096 + 7 * i,) for i in range(40)]
    tleaves = [torch.empty(s, device="meta") for s in shapes]
    jleaves = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    kw = dict(axis_sizes={"dp": n}, max_bucket_bytes=64 << 20)
    for codec in ("int8", "bf16", None):
        got = tb.plan_buckets(
            tleaves, [None] * 40, ("dp",),
            topos={"dp": tstages.Topology.resolve(n, grad_topo)},
            params=_params(tcost, launch_us), codec=codec, **kw)
        want = jb.plan_buckets(
            jleaves, [P()] * 40, ("dp",),
            topos={"dp": jstages.Topology.resolve(n, grad_topo)},
            params=_params(jcost, launch_us), codec=codec, **kw)
        assert [(b.indices, b.nbytes) for b in got] == \
            [(b.indices, b.nbytes) for b in want], codec
    # the JAX test's claim holds on the JAX package's default constants
    # (a TPU's), carried into the port's params; on the port's own (an
    # H100's, where the wire is a device copy) it need not
    import dataclasses

    from flextree_tpu.planner.choose import choose_bucket_bytes as j_choose
    from flextree_tpu_torch.planner.choose import choose_bucket_bytes

    jp = jcost.TpuCostParams()
    tp = tcost.TpuCostParams(
        ici=tcost.LinkParams(**dataclasses.asdict(jp.ici)),
        dcn=tcost.LinkParams(**dataclasses.asdict(jp.dcn)),
        **{k: v for k, v in dataclasses.asdict(jp).items()
           if k not in ("ici", "dcn")})
    t, jt = tstages.Topology(8, (4, 2)), jstages.Topology(8, (4, 2))
    sizes = {c: choose_bucket_bytes(64 << 20, t, n_leaves=64, params=tp,
                                    codec=c) for c in (None, "int8")}
    assert sizes == {c: j_choose(64 << 20, jt, n_leaves=64, params=jp,
                                 codec=c) for c in (None, "int8")}
    assert sizes["int8"] >= sizes[None]


def _jax_lossy_sync(trees, bucket_bytes, codec, step):
    """The JAX ``sync_grads`` with ``codec`` and ``return_residual`` on an
    8-device CPU mesh: each rank's (synced, residual) rows."""
    mesh = jax.make_mesh((8,), ("dp",), devices=jax.devices()[:8])
    topos = jtrain.resolve_axis_topos(mesh, ("dp",), None)
    keys = list(trees[0])
    stacked = {k: jnp.asarray(np.stack([t[k].numpy() for t in trees]))
               for k in keys}
    io = {k: P("dp") for k in keys}

    def f(t):
        rows = {k: v[0] for k, v in t.items()}
        out, res = jtrain.sync_grads(rows, {k: P() for k in keys}, ("dp",),
                                     topos, bucket_bytes=bucket_bytes,
                                     codec=codec, step=step,
                                     return_residual=True)
        return ({k: v[None] for k, v in out.items()},
                {k: v[None] for k, v in res.items()})

    out, res = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=(io,),
                                     out_specs=(io, io),
                                     check_vma=False))(stacked)
    return ({k: np.array(v) for k, v in out.items()},
            {k: np.array(v) for k, v in res.items()})


@pytest.mark.parametrize("codec", ["int8", "bf16"])
@pytest.mark.parametrize("bucket_bytes", [0, None], ids=["per-leaf", "bucketed"])
def test_lossy_sync_within_bound_with_jax_residuals(codec, bucket_bytes):
    """The JAX ``test_bucketed_lossy_sync_within_bound_with_residuals`` on
    the port, against the JAX sync on the same rows: every rank's leaves
    identical and within the codec's bound of the exact sum, the same
    bucket plan's residuals as JAX's (within one float32 rounding of the
    decode; see ``test_torch_compressed.py``), each within one
    quantization step of the blocks it lies in (a packed bucket's blocks
    straddle leaves, so of the largest leaf's)."""
    rng = np.random.default_rng(4)
    leaves = [(1000 + 7 * i,) for i in range(5)]
    trees = [{f"leaf{i}": torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)) for i, s in
        enumerate(leaves)} for _ in range(8)]
    mesh = flat_mesh(8, "cpu", "dp")
    topos = ttrain.resolve_axis_topos(mesh, ("dp",), None)
    got, res = ttrain.sync_grads(trees, None, ("dp",), topos,
                                 bucket_bytes=bucket_bytes, codec=codec,
                                 step=3, return_residual=True, comm=mesh)
    want, want_res = _jax_lossy_sync(trees, bucket_bytes, codec, 3)
    exact = ttrain.sync_grads(trees, None, ("dp",), topos, comm=mesh)
    c = tq.get_codec(codec)
    top = max(float(g.abs().max()) for t in trees for g in t.values())
    for k in trees[0]:
        amax = max(float(t[k].abs().max()) for t in trees)
        bound = c.error_bound(amax, 8, (8,)) + 1e-5
        for r in range(8):
            assert torch.equal(got[r][k], got[0][k])
            err = (got[r][k].double() - exact[r][k].double()).abs().max()
            assert err <= bound, (k, r, float(err), bound)
            assert np.abs(want[k][r] - exact[r][k].numpy()).max() <= bound
            np.testing.assert_allclose(res[r][k].numpy(), want_res[k][r],
                                       rtol=0, atol=2.0 ** -22 * amax)
            assert res[r][k].abs().max() <= top / 127.0 + 1e-6


@pytest.mark.parametrize("n,topo", [(8, None), (8, "4,2"), (8, "1"),
                                    (8, "psum"), (7, "3,2+1")])
@pytest.mark.parametrize("codec", ["int8", "bf16"])
@pytest.mark.parametrize("bucket_bytes,chunks", [(0, 1), (None, 1), (64, 1),
                                                 (None, 2)])
def test_lossy_sync_makes_the_fold_calls_sync_fold_stages_derives(
        monkeypatch, n, topo, codec, bucket_bytes, chunks):
    """A lossy sync's ``reduce_sources`` calls, in order, are the stages
    ``sync_fold_stages(codec=...)`` derives; every rank's leaves are
    identical, the bucketed sync's within the bound of the per-leaf one's,
    and the spans are ``ftq_bucket*``."""
    from flextree_tpu_torch.parallel import compressed as tcomp

    calls = []
    real = tar.reduce_sources

    def counted(folds, rop):
        calls.append((len(folds), len(folds[0][0]), folds[0][1].numel()))
        return real(folds, rop)

    monkeypatch.setattr(tar, "reduce_sources", counted)
    monkeypatch.setattr(tcomp, "reduce_sources", counted)
    mesh = flat_mesh(n, "cpu", "dp")
    trees = _trees(n, [(s, "float32") for s, _ in LEAVES] +
                   [((3000,), "float32")], 4)
    topos = ttrain.resolve_axis_topos(mesh, ("dp",), topo)
    with tprof.span_ledger() as ledger:
        got = ttrain.sync_grads(trees, None, ("dp",), topos,
                                bucket_bytes=bucket_bytes, chunks=chunks,
                                codec=codec, step=2, comm=mesh)
    leaves = ttrain.tree_leaves(trees[0])
    buckets = None if bucket_bytes == 0 else tb.plan_buckets(
        leaves, [None] * len(leaves), ("dp",), topos=topos,
        axis_sizes={"dp": n}, bucket_bytes=bucket_bytes, codec=codec)
    assert calls == tb.sync_fold_stages([g.numel() for g in leaves], n,
                                        topos["dp"], buckets, chunks, codec)
    if buckets is not None:
        assert all(name.startswith("ftq_bucket") for name in ledger.names)
        assert len(ledger.names) == len(buckets)
    for r in range(1, n):
        _assert_bitwise([got[r]], [got[0]])


@pytest.mark.parametrize("codec", ["int8", "bf16"])
def test_lossy_bucket_provenance_names_the_codec(codec):
    """A lossy bucket's ``ftq_bucket*`` span carries the JAX payload's
    fields with the codec that ran, and its prediction prices the codec."""
    mesh = flat_mesh(8, "cpu", "dp")
    trees = _trees(8, [(s, "float32") for s, _ in LEAVES], 9)
    topos = ttrain.resolve_axis_topos(mesh, ("dp",), "4,2")
    with flight_recorder(None), tprof.plan_capture() as cap:
        ttrain.sync_grads(trees, None, ("dp",), topos, bucket_bytes=64,
                          codec=codec, step=1, comm=mesh)
    assert cap and all(n.startswith("ftq_bucket") for n, _ in cap)
    topo = tstages.Topology.resolve(8, "4,2")
    with jrecorder.flight_recorder(None):
        for name, prov in cap:
            nb = tprof.span_bytes(name)
            want = jprov.bucket_provenance(
                ("dp",), {"dp": jstages.Topology.resolve(8, "4,2")}, nb,
                n_leaves=prov["n_leaves"], dtype=prov["dtype"],
                codec=jq.get_codec(codec))
            drop = ("predicted", "predicted_us")
            assert prov["codec"] == codec
            assert {k: v for k, v in prov.items() if k not in drop} == \
                {k: v for k, v in want.items() if k not in drop}
            cost = tcost.allreduce_cost(topo, nb, default_params(),
                                        codec=codec)
            assert prov["predicted_us"] == round(cost.total_us, 3)
