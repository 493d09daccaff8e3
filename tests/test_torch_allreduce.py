"""The port's FlexTree collectives (``flextree_tpu_torch.parallel``) on an
in-process mesh on the CPU, against the JAX package's oracle and
collectives, on the same seeded numpy inputs.

Shapes, each at the rank counts it fits: flat ``(N,)`` and the ring at N
in {2, 3, 4, 6, 7, 8}, ``(2,2)``, ``(3,2)``, ``(4,2)``, ``(2,4)``,
``(2,2,2)``, ``"2+1"`` and ``"3,2+1"``; counts {1, 8, 35, 64, 100}.  Held:

- every op x dtype of the registry, bitwise, against the group-fold oracle
  (:func:`group_fold_oracle`: per stage, each group folds its members'
  rows in group order; the tail folds in rank order; lonely ranks fold
  into their buddies first; the ring walks the simulator's steps);
- integer, bool, max and min bitwise against the JAX ``simulate_allreduce``
  at every count; float sum and prod bitwise against it on width-2 trees
  and the ring at counts N divides, and within the fold-order bound
  ``N·u·Σ|x|`` everywhere;
- every rank's row identical; ``all_gather(reduce_scatter(x))`` bitwise
  ``allreduce(x)``; ``chunks=3`` bitwise ``chunks=1``; in place bitwise;
  shard ``r`` is block ``owned_block(topo, r)`` then the tail;
- the mesh's fold stages send no message: a reduce-scatter posts none
  (a lonely shape's only messages mirror the buddies' shards), an
  allreduce only the gather phase's, and each fold stage is one
  ``reduce_sources`` call;
- against the JAX collectives themselves: ``test_torch_allreduce_jax.py``.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from flextree_tpu.backends import simulate_allreduce as j_simulate
from flextree_tpu.ops import reduce as jreduce
from flextree_tpu.schedule.stages import LonelyTopology, Topology
from flextree_tpu_torch.schedule.blocks import owned_block
from flextree_tpu_torch.parallel import allreduce as tar
from flextree_tpu_torch.parallel.mesh import (
    Mesh,
    allreduce_over_mesh,
    flat_mesh,
    topology_from_mesh,
)

SHAPES = ([(n, str(n)) for n in (2, 3, 4, 6, 7, 8)]
          + [(n, "1") for n in (2, 3, 4, 6, 7, 8)]
          + [(4, "2,2"), (6, "3,2"), (8, "4,2"), (8, "2,4"), (8, "2,2,2"),
             (3, "2+1"), (7, "3,2+1")])
COUNTS = (1, 8, 35, 64, 100)
COMBOS = [(op, dt) for op, rop in jreduce.SUPPORTED_OPS.items()
          for dt in rop.dtypes]
UNIT_ROUNDOFF = {"float16": 2.0 ** -11, "bfloat16": 2.0 ** -8,
                 "float32": 2.0 ** -24, "float64": 2.0 ** -53}


def np_dtype(name):
    return np.dtype(ml_dtypes.bfloat16) if name == "bfloat16" else np.dtype(name)


def make_rows(n, count, name, seed):
    """Seeded (n, count) numpy input: normals for floats, the full range
    for integers, random bits for bool."""
    rng = np.random.default_rng(seed)
    dt = np_dtype(name)
    if name in UNIT_ROUNDOFF:
        return rng.standard_normal((n, count)).astype(np.float32).astype(dt)
    if name == "bool":
        return rng.integers(0, 2, (n, count)).astype(np.bool_)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, (n, count), dtype=dt, endpoint=True)


def to_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def to_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        np.array_equal(a.view(np.uint8), b.view(np.uint8))


def group_fold_oracle(data, spec, op):
    """The fold tree every element of the port's allreduce follows, in
    numpy: per tree stage, each group folds its members' rows in group
    order and gives the result to every member; the < owners-element tail
    folds over all ranks in rank order; a lonely shape folds rank m+i into
    buddy i first and hands the tree's result back; the ring walks the
    simulator's steps on the divisible head."""
    fold = jreduce.get_op(op).np_fn
    n, count = data.shape
    topo = Topology.resolve(n, spec)
    lonely = isinstance(topo, LonelyTopology)
    tree = topo.tree if lonely else topo
    owners = tree.num_nodes
    head = count // owners * owners
    out = np.empty_like(data)
    if head:
        if topo.is_ring:
            out[:, :head] = j_simulate(data[:, :head], "1", op)
        else:
            rows = [data[r, :head].copy() for r in range(n)]
            if lonely:
                for i in range(topo.lonely):
                    rows[i] = fold(rows[i], rows[owners + i])
            for i in range(tree.num_stages):
                for grp in tree.groups(i):
                    acc = rows[grp[0]]
                    for r in grp[1:]:
                        acc = fold(acc, rows[r])
                    for r in grp:
                        rows[r] = acc
            for r in range(n):
                out[r, :head] = rows[r if r < owners else r - owners]
    if head < count:
        acc = data[0, head:]
        for r in range(1, n):
            acc = fold(acc, data[r, head:])
        out[:, head:] = acc
    return out


def port_allreduce(data, spec, op, **kw):
    return to_numpy(allreduce_over_mesh(to_torch(data), flat_mesh(
        data.shape[0], "cpu"), spec, op, **kw))


def within_fold_bound(got, want, data, op):
    """|got - want| <= N·u·Σ_r|x_r| (sum) or N·u·|Π_r x_r| (prod), in
    float64, for two results of one reduction folded in different
    orders."""
    n = data.shape[0]
    u = UNIT_ROUNDOFF[np.dtype(data.dtype).name]
    mags = np.abs(data.astype(np.float64))
    scale = mags.sum(0) if op == "sum" else mags.prod(0)
    return np.all(np.abs(got.astype(np.float64) - want.astype(np.float64))
                  <= 2 * n * u * scale)


@pytest.mark.parametrize("count", COUNTS)
@pytest.mark.parametrize("n,spec", SHAPES)
def test_every_op_and_dtype_against_the_oracles(n, spec, count):
    topo = Topology.resolve(n, spec)
    narrow = not isinstance(topo, LonelyTopology) and (
        topo.is_ring or max(topo.widths) <= 2)
    for op, dt in COMBOS:
        data = make_rows(n, count, dt, seed=count * 31 + n)
        got = port_allreduce(data, spec, op)
        what = (op, dt)
        assert all(same_bits(got[r], got[0]) for r in range(n)), what
        assert same_bits(got, group_fold_oracle(data, spec, op)), what
        exact = dt not in UNIT_ROUNDOFF or op in ("max", "min")
        if exact or (narrow and count % n == 0):
            assert same_bits(got, j_simulate(data, spec, op)), what
        else:
            assert within_fold_bound(got[0], j_simulate(data, spec, op)[0],
                                     data, op), what


SPLIT_CASES = (("sum", "float32"), ("sum", "bfloat16"), ("band", "int32"),
               ("prod", "float64"), ("max", "uint16"))


@pytest.mark.parametrize("n,spec", SHAPES)
def test_split_phases_chunks_and_in_place_are_bitwise(n, spec):
    mesh = flat_mesh(n, "cpu")
    topo = Topology.resolve(n, spec)
    owners = topo.tree.num_nodes if isinstance(topo, LonelyTopology) else n
    for count in COUNTS:
        for op, dt in SPLIT_CASES:
            data = make_rows(n, count, dt, seed=count + 7 * n)
            rows = list(to_torch(data))
            full = tar.allreduce(rows, mesh, spec, op)
            shards = tar.reduce_scatter(rows, mesh, spec, op)
            back = tar.all_gather(shards, mesh, spec, out_shape=(count,))
            assert all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                       for a, b in zip(back, full)), (op, dt, count)
            tile, head = count // owners, count // owners * owners
            for r in range(n):
                blk = owned_block(topo, r)
                want = torch.cat([full[r][blk * tile:(blk + 1) * tile],
                                  full[r][head:]])
                assert torch.equal(shards[r].view(torch.uint8),
                                   want.view(torch.uint8)), (r, op, dt, count)
            chunked = tar.allreduce(rows, mesh, spec, op, chunks=3)
            assert all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                       for a, b in zip(chunked, full))
            stacked = to_torch(data)
            same = allreduce_over_mesh(stacked, mesh, spec, op, in_place=True)
            assert same is stacked
            assert torch.equal(same.view(torch.uint8),
                               torch.stack(full).view(torch.uint8))


def test_entry_points_route_like_the_jax_ones():
    mesh = flat_mesh(8, "cpu")
    rows = list(to_torch(make_rows(8, 35, "int32", 1)))
    ring = tar.ring_allreduce(rows, mesh, "bxor")
    assert all(torch.equal(a, b) for a, b in
               zip(ring, tar.allreduce(rows, mesh, "1", "bxor")))
    tree = tar.tree_allreduce(rows, mesh, (4, 2), "bor")
    assert all(torch.equal(a, b) for a, b in
               zip(tree, tar.allreduce(rows, mesh, "4,2", "bor")))
    rows7 = list(to_torch(make_rows(7, 35, "int64", 2)))
    mesh7 = flat_mesh(7, "cpu")
    lonely = tar.lonely_allreduce(rows7, mesh7, "3,2+1", "sum")
    assert all(torch.equal(a, b) for a, b in
               zip(lonely, tar.tree_allreduce(rows7, mesh7, "3,2+1", "sum")))
    one = flat_mesh(1, "cpu")
    x = [torch.arange(5)]
    assert tar.allreduce(x, one) is x
    assert tar.reduce_scatter(x, one)[0].tolist() == list(range(5))


@pytest.mark.parametrize("in_place", [False, True])
def test_a_world_of_one_hands_back_its_input(in_place):
    one = flat_mesh(1, "cpu")
    data = make_rows(1, 35, "float32", 3)
    stacked = to_torch(data)
    got = allreduce_over_mesh(stacked, one, None, "sum", in_place=in_place)
    assert (got is stacked) == in_place
    assert same_bits(to_numpy(got), data)
    for run in (lambda x, out: tar.allreduce(x, one, out=out),
                lambda x, out: tar.ring_allreduce(x, one, out=out)):
        out = [torch.full((35,), float("nan"))]
        res = run(list(to_torch(data)), out)
        assert res[0].data_ptr() == out[0].data_ptr()
        assert same_bits(out[0].numpy(), data[0])


def test_unported_routes_raise_naming_their_roadmap_item(monkeypatch):
    """The IR families run now (swing, generalized, and swing through
    ``FT_TOPO``) and equal the plain sum; a lossy codec still raises."""
    mesh = flat_mesh(4, "cpu")
    data = np.random.default_rng(4).integers(-8, 8, (4, 35)).astype(np.float32)
    rows = list(torch.from_numpy(data))
    want = data.sum(0)
    for spec in ("swing", "gen:2,2@1"):
        for got in tar.allreduce(rows, mesh, spec):
            assert same_bits(got.numpy(), want), spec
    monkeypatch.setenv("FT_TOPO", "swing")
    for got in tar.allreduce(rows, mesh):
        assert same_bits(got.numpy(), want)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tar.reduce_scatter(rows, mesh, "2,2", codec="int8")


def test_mesh_helpers():
    with pytest.raises(ValueError):
        tar.allreduce(list(torch.ones(3, 4)), flat_mesh(4, "cpu"))
    assert topology_from_mesh(flat_mesh(8, "cpu")).widths == (8,)
    m = Mesh(("cpu",) * 8, ("a", "b"), (2, 4))
    assert topology_from_mesh(m).widths == (2, 4)
    assert topology_from_mesh(m, "b").widths == (4,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            flat_mesh(4)  # entry points default to the card


@pytest.mark.parametrize("n,spec,folds,copies", [
    (8, "8", [(8, 8, 2_097_728)], 64),
    (8, "4,2", [(8, 4, 4_195_456), (8, 2, 2_097_728)], 48),
    (8, "2,2,2", [(8, 2, 8_390_912), (8, 2, 4_195_456),
                  (8, 2, 2_097_728)], 48),
    (8, "1", [(8, 2, 2_097_728)] * 7, 56),
    (7, "3,2+1", [(1, 2, 16_781_820), (6, 3, 5_593_940),
                  (6, 2, 2_796_970), (7, 7, 4)], 38),
])
def test_call_shape_at_the_flagship_gradient(n, spec, folds, copies):
    """The launches a call that PERF.md reports for the flagship's
    16,781,824-element gradient: one fold a stage, and the gather's
    copies plus a one-a-rank snapshot of an in-place tail."""
    got = tar.call_shape(n, spec, 16_781_824)
    assert got.folds == folds
    assert got.copies == copies


@pytest.mark.parametrize("n,spec", SHAPES)
def test_the_fold_stages_send_no_message(n, spec, monkeypatch):
    sent, folds = [], []
    run, fold = tar.MeshTransport.run, tar.reduce_sources
    monkeypatch.setattr(tar.MeshTransport, "run", lambda self, msgs: (
        sent.extend((m.src, m.dst) for m in msgs), run(self, msgs))[1])
    monkeypatch.setattr(tar, "reduce_sources", lambda fs, rop: (
        folds.append(len(fs)), fold(fs, rop))[1])
    mesh = flat_mesh(n, "cpu")
    topo = Topology.resolve(n, spec)
    m = topo.tree.num_nodes if isinstance(topo, LonelyTopology) else n
    for count in (35, 64):
        rows = list(to_torch(make_rows(n, count, "float32", seed=count)))
        want = tar.call_shape(n, spec, count)
        sent.clear(), folds.clear()
        tar.reduce_scatter(rows, mesh, spec, "sum")
        assert all(s == d - m for s, d in sent), sent  # the mirror only
        assert folds == [r for r, _, _ in want.folds]
        sent.clear(), folds.clear()
        tar.allreduce(rows, mesh, spec, "sum")
        assert len(sent) == want.messages
        assert folds == [r for r, _, _ in want.folds]
