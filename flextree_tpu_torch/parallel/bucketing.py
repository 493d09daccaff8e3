"""Gradient bucketing: the fused FlexTree gradient sync.

The port's copy of ``flextree_tpu/parallel/bucketing.py``.  A transformer
gradient hands the sync dozens of leaves, and every leaf synced alone pays
a whole collective: its fold stages, its gather messages and the host's
dispatch of each.  The bucketed sync packs the leaves into a few flat
buffers and runs one FlexTree allreduce a bucket.  The bucket size comes
from the planner (:func:`..planner.choose.choose_bucket_bytes`, the
alpha-beta argmin over the cost model's constants), capped by the leaves'
device: ``DEFAULT_MAX_BUCKET_BYTES`` on a card, ``CPU_MAX_BUCKET_BYTES``
on the host (the JAX package's caps, chosen there by
``jax.default_backend()``).

Leaves fuse only when they agree on (replication axes, dtype)
(:func:`replication_key`): a bucket runs one allreduce an axis, and its
buffer has one dtype.

**Bitwise identity** with the per-leaf sync is the contract (the per-leaf
sync, ``bucket_bytes=0`` in ``train.sync_grads``, is its oracle).  It
holds because every element keeps the fold order it had per leaf:

- *tree stages* fold a group's members in group order at every position
  of a tile, so packing leaves into one buffer changes no element's fold;
- *tails*: each leaf's < N-element remainder is decided per leaf as
  ``allreduce`` decides it, and the bucket's tails go, concatenated, to
  one dense fold of every rank in rank order
  (:func:`.allreduce.dense_allreduce`), which is the fold each leaf's
  tail got alone.  The fused tails can exceed N elements, so handing them
  to ``allreduce`` would run their head through the tree's order instead;
- *the ring* folds block ``b`` in an order that depends on ``b``
  (``allreduce._ring_rs``), so ring buckets pack block-interleaved: fused
  block ``b`` is every leaf's block ``b``, one after another.

A lonely shape (``"3,2+1"``) folds by position and so syncs per leaf, as
in the JAX package.  The ``"psum"`` sentinel (a ``None`` topology) is
the dense fold on both transports.  The sync is sum-only.

The ranks are a :class:`~.mesh.Mesh` (this process runs every rank; the
gradients are a list of one tree a rank) or a ``torch.distributed``
process group (this process is one rank; the gradients are its tree,
and one axis, data parallelism, spans the group).  On a mesh of several
axes above size 1 (``dp``, ``sp``, ``tp``) a leaf syncs over each of its
replication axes in turn, in the mesh order, one walk an axis over each
group of ranks that differ only along it (:class:`~.spmd.Axis`), as the
JAX collective acts on each such group; the bucketed sync does the same a
bucket and axis, so it stays bitwise the per-leaf sync.

A lossy wire ``codec`` (``"bf16"``, ``"int8"``; ``ops/quantize.py``) has
no bitwise contract: each bucket's leaves are packed into one float32
buffer and each axis runs one :func:`.compressed.compressed_allreduce`
on it (lonely shapes too), which folds its own < N-element tail exactly;
``return_residual=True`` also returns each leaf's error-feedback residual
(see :func:`bucketed_sync_grads`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Sequence

import torch

from ..schedule.stages import LonelyTopology, Topology
from ..utils.profiling import comm_span
from ..utils.tree import tree_leaves, tree_unflatten
from .allreduce import (
    _split,
    allreduce,
    call_shape,
    chunk_sizes,
    dense_allreduce,
)
from .compressed import (
    compressed_allreduce,
    int8_fold_stages,
    local_residual,
)
from .mesh import Mesh

__all__ = [
    "spec_axes",
    "replication_key",
    "spec_leaves",
    "comm_axis_sizes",
    "Bucket",
    "plan_buckets",
    "per_leaf_sync_grads",
    "bucketed_sync_grads",
    "sync_fold_stages",
    "mesh_fold_launches",
    "DEFAULT_MAX_BUCKET_BYTES",
    "CPU_MAX_BUCKET_BYTES",
    "WIDE_AXES_ITEM",
]

#: Cap on a planner-sized bucket on a card: a bucket holds one packed copy
#: of its leaves, so an unbounded one would double the peak gradient memory
DEFAULT_MAX_BUCKET_BYTES = 64 << 20

#: The cap on the CPU: the JAX package measured 64-128 KiB buckets beating
#: per-leaf sync inside the train step on a CPU host, one giant bucket
#: losing (the pack, collective, unpack and AdamW chain must stay in cache)
CPU_MAX_BUCKET_BYTES = 128 << 10

#: the ROADMAP item that the pipeline and MoE steps over a
#: ``torch.distributed`` group wait on (a process group is one data-parallel
#: axis, :func:`comm_axis_sizes`)
WIDE_AXES_ITEM = \
    "ROADMAP.md, Queue 1: 'Sequence, pipeline and expert parallelism'"


def _default_max_bucket_bytes(leaves) -> int:
    """The cap for the leaves' device: a card's, or the host's."""
    on_card = any(getattr(g, "is_cuda", False) for g in leaves)
    return DEFAULT_MAX_BUCKET_BYTES if on_card else CPU_MAX_BUCKET_BYTES


def spec_axes(spec) -> tuple[str, ...]:
    """The mesh axes a spec names (sorted): the axes the leaf is sharded
    over.  A spec is a tuple with one entry a dimension, each ``None``, an
    axis name or a tuple of names (JAX's ``PartitionSpec``); ``None`` is
    fully replicated."""
    names: set[str] = set()
    for entry in tuple(spec) if spec is not None else ():
        if entry is None:
            continue
        names.update(entry if isinstance(entry, (tuple, list)) else (entry,))
    return tuple(sorted(names))


def replication_key(spec, mesh_axes) -> tuple[str, ...]:
    """The axes a leaf with ``spec`` is replicated on, in ``mesh_axes``
    order: the axes its gradient is summed over, and its bucket group."""
    used = set(spec_axes(spec))
    return tuple(a for a in mesh_axes if a not in used)


def spec_leaves(grads, pspecs) -> list:
    """The spec of each leaf of ``grads`` in ``tree_leaves`` order, read
    from ``pspecs`` up to the gradient tree's structure (a spec is itself a
    tuple); ``pspecs=None``: every leaf replicated."""
    out: list = []

    def walk(g, s):
        if isinstance(g, dict):
            for k in sorted(g):
                walk(g[k], s[k])
        elif isinstance(g, (list, tuple)):
            if len(g) != len(s):
                raise ValueError("pspecs do not match the gradient tree")
            for v, sv in zip(g, s):
                walk(v, sv)
        else:
            out.append(s)

    if pspecs is None:
        return [None] * len(tree_leaves(grads))
    walk(grads, pspecs)
    return out


def comm_axis_sizes(comm, mesh_axes) -> dict:
    """The size of each of ``mesh_axes`` over ``comm``: a :class:`Mesh`
    (its named axes; others are 1), a process group (the first axis spans
    it: a process of a group is one data-parallel rank) or ``None`` (one
    rank).  The axes must span the ranks."""
    mesh_axes = tuple(mesh_axes)
    if comm is None:
        return {ax: 1 for ax in mesh_axes}
    if isinstance(comm, Mesh):
        named = dict(zip(comm.axis_names, comm.shape))
        sizes = {ax: int(named.get(ax, 1)) for ax in mesh_axes}
        ranks = comm.size
    else:
        import torch.distributed as dist

        ranks = dist.get_world_size(comm)
        sizes = {ax: ranks if i == 0 else 1 for i, ax in enumerate(mesh_axes)}
    if math.prod(sizes.values()) != ranks:
        raise ValueError(f"the axes {sizes} of {mesh_axes} do not span the "
                         f"{ranks} ranks of {comm}")
    return sizes


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One fused sync unit: ``indices`` into the flat gradient leaves, all
    sharing ``axes`` (replication axes, mesh order) and ``dtype`` (the
    numpy-style name, ``"float32"``, so plans compare across packages).
    ``cap`` is the size its group packed to (``bucket_bytes`` or the
    derived one; a leaf above it is a bucket of its own): passed back as
    ``bucket_bytes``, it plans the group again on any device."""

    axes: tuple[str, ...]
    dtype: str
    indices: tuple[int, ...]
    nbytes: int
    cap: int = dataclasses.field(default=0, compare=False, repr=False)


def _dtype_name(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def plan_buckets(
    leaves: Sequence[Any],
    specs: Sequence[Any],
    mesh_axes,
    topos: Mapping[str, Any] | None = None,
    axis_sizes: Mapping[str, int] | None = None,
    bucket_bytes: int | None = None,
    params=None,
    max_bucket_bytes: int | None = None,
    codec=None,
    sharded: bool = False,
) -> tuple[Bucket, ...]:
    """Partition the flat gradient leaves (tensors; ``meta`` ones do) into
    fused sync buckets.

    Leaves group by ``(replication_key, dtype)`` in flat order; within a
    group, consecutive leaves pack greedily until the bucket would pass
    ``bucket_bytes``.  ``bucket_bytes=None`` derives the size a group from
    the cost model (:func:`..planner.choose.choose_bucket_bytes` on the
    group's topologies and bytes, with ``params``), capped at
    ``max_bucket_bytes`` (None: the leaves' device's cap).  Axes of size 1
    (``axis_sizes``) drop out of a key; a leaf sharded over every axis is
    not synced and is in no bucket.  ``codec`` prices the derived size
    with the codec's wire bytes and hop cost (a lossy sync's buckets);
    ``sharded`` prices the ZeRO-1 split schedule instead (the gradient's
    reduce-scatter and the parameters' all-gather, :mod:`.zero`)."""
    if max_bucket_bytes is None:
        max_bucket_bytes = _default_max_bucket_bytes(leaves)
    groups: dict[tuple[tuple[str, ...], str], list[int]] = {}
    for i, (g, spec) in enumerate(zip(leaves, specs)):
        axes = replication_key(spec, mesh_axes)
        if axes and axis_sizes is not None:
            axes = tuple(a for a in axes if axis_sizes.get(a, 1) > 1)
        if not axes:
            continue
        groups.setdefault((axes, _dtype_name(g)), []).append(i)

    buckets: list[Bucket] = []
    for (axes, dtype), idxs in groups.items():
        sizes = [leaves[i].numel() * leaves[i].element_size() for i in idxs]
        cap = bucket_bytes
        if cap is None:
            cap = _derived_bucket_bytes(
                sum(sizes), len(idxs), axes, topos or {}, axis_sizes or {},
                params, max_bucket_bytes, codec, sharded=sharded)
        cap = max(int(cap), 1)
        cur: list[int] = []
        cur_bytes = 0
        for i, nb in zip(idxs, sizes):
            if cur and cur_bytes + nb > cap:
                buckets.append(Bucket(axes, dtype, tuple(cur), cur_bytes,
                                      cap))
                cur, cur_bytes = [], 0
            cur.append(i)
            cur_bytes += nb
        if cur:
            buckets.append(Bucket(axes, dtype, tuple(cur), cur_bytes, cap))
    return tuple(buckets)


def _derived_bucket_bytes(total_bytes, n_leaves, axes, topos, axis_sizes,
                          params, max_bucket_bytes, codec=None,
                          sharded: bool = False):
    """The planner's bucket size for one (axes, dtype) group: a bucket runs
    one allreduce an axis, so the fixed cost the chooser amortizes is the
    sum over the axes; the sentinel axis is priced as the flat tree.
    ``sharded`` prices the ZeRO-1 split schedule
    (``planner.choose.choose_bucket_bytes``)."""
    from ..planner.choose import choose_bucket_bytes

    cost_topos = []
    for ax in axes:
        n = int(axis_sizes.get(ax, 0)) or None
        topo = topos.get(ax)
        if topo is None:
            if n is None:
                continue
            topo = Topology.flat(n)
        cost_topos.append(Topology.resolve(n or topo.num_nodes, topo))
    if not cost_topos:
        return max_bucket_bytes
    derived = choose_bucket_bytes(total_bytes, cost_topos, n_leaves=n_leaves,
                                  params=params, codec=codec, sharded=sharded)
    return min(derived, max_bucket_bytes)


# ------------------------------------------------------------ the sync


class _Ranks:
    """The ranks a sync runs over, as the collectives take them: on a mesh
    a list of every rank's tensor, on a process group this rank's.
    :meth:`along` narrows a mesh to the groups of one of its axes."""

    def __init__(self, comm, axis=None):
        self.comm = comm
        self.mesh = isinstance(comm, Mesh)
        self.axis = axis
        if axis is not None:
            self.size = axis.size
        elif self.mesh:
            self.size = comm.size
        else:
            import torch.distributed as dist

            self.size = dist.get_world_size(comm)

    def along(self, ax: str) -> "_Ranks":
        """The ranks as groups along mesh axis ``ax`` (each collective then
        runs once a group); itself where ``ax`` spans every rank (a
        one-axis mesh, a process group) or the mesh has no such axis (the
        callers sync no axis of size 1)."""
        size = dict(zip(self.comm.axis_names, self.comm.shape)).get(ax) \
            if self.mesh else None
        if size is None or size == self.size:
            return self
        from .spmd import axis

        return _Ranks(self.comm, axis(self.comm, ax))

    def run(self, fn, xs: list, **kw) -> list:
        """``fn`` (a collective) over ``xs``, one tensor a local rank."""
        if self.axis is not None:
            return self.axis.run(fn, xs, **kw)
        got = fn(xs if self.mesh else xs[0], self.comm, **kw)
        return list(got) if self.mesh else [got]

    def run_pair(self, fn, xs: list, **kw) -> tuple[list, list]:
        """As :meth:`run`, for a collective that returns two results a rank
        (a result and its residual)."""
        if self.axis is not None:
            pairs = self.axis.run(lambda x, m, **k: list(zip(*fn(x, m, **k))),
                                  xs, **kw)
            return [a for a, _ in pairs], [b for _, b in pairs]
        a, b = fn(xs if self.mesh else xs[0], self.comm, **kw)
        return (list(a), list(b)) if self.mesh else ([a], [b])


def sync_leaf(ranks: _Ranks, xs: list, topo, chunks: int = 1) -> list:
    """One leaf's sum over the ranks: the FlexTree ``allreduce`` on
    ``topo``, or the dense fold for the ``"psum"`` sentinel (None)."""
    if topo is None:
        return ranks.run(dense_allreduce, xs)
    return ranks.run(allreduce, xs, topo=topo, op="sum", chunks=chunks)


def _unflatten_ranks(trees: list, flat: list, ranks: _Ranks):
    """Each local rank's tree with its synced leaves, in the caller's form
    (a list on a mesh, this rank's tree otherwise)."""
    out = [tree_unflatten(t, f) for t, f in zip(trees, flat)]
    return out if ranks.mesh else out[0]


def per_leaf_sync_grads(grads, pspecs, mesh_axes, topos: Mapping[str, Any],
                        chunks: int = 1, *, comm, codec="f32", step=0,
                        return_residual: bool = False):
    """The per-leaf sync, the bucketed sync's oracle: for each leaf, one
    collective an axis it is replicated on, in ``mesh_axes`` order
    (:func:`sync_leaf`).  Arguments as :func:`bucketed_sync_grads`.

    A lossy ``codec`` runs :func:`.compressed.compressed_allreduce` on each
    scheduled axis (the sentinel stays the exact dense fold), as the JAX
    ``train.sync_grads`` does; ``return_residual=True`` also returns each
    leaf's residual: the wire's from the leaf's first replication axis
    (a trivial one gives zeros), the only one that sees this rank's own
    data, else :func:`.compressed.local_residual` of the leaf."""
    from ..ops.quantize import get_codec

    codec = get_codec(codec)
    ranks = _Ranks(comm)
    sizes = comm_axis_sizes(comm, mesh_axes)
    trees = list(grads) if ranks.mesh else [grads]
    flat = [tree_leaves(t) for t in trees]
    res = [[None] * len(f) for f in flat]
    for i, spec in enumerate(spec_leaves(trees[0], pspecs)):
        xs = [f[i] for f in flat]
        wire = None
        for k, ax in enumerate(replication_key(spec, mesh_axes)):
            topo = topos[ax]
            on = ranks.along(ax)
            if not codec.lossy or topo is None:
                if sizes[ax] > 1:
                    xs = sync_leaf(on, xs, topo, chunks)
            elif sizes[ax] <= 1:
                if k == 0:  # the JAX collective's route for one rank
                    wire = [torch.zeros_like(x) for x in xs]
            elif k == 0:
                xs, wire = on.run_pair(
                    compressed_allreduce, xs, topo=topo, codec=codec,
                    chunks=chunks, step=step, return_residual=True)
            else:
                xs = on.run(compressed_allreduce, xs, topo=topo,
                            codec=codec, chunks=chunks, step=step)
        for r, (f, x) in enumerate(zip(flat, xs)):
            if return_residual:
                res[r][i] = wire[r] if wire is not None else \
                    local_residual(f[i], codec, step)
            f[i] = x
    out = _unflatten_ranks(trees, flat, ranks)
    if return_residual:
        return out, _unflatten_ranks(trees, res, ranks)
    return out


def _fused_native_psum(ranks: _Ranks, leaves: list) -> list:
    """The sentinel axis on a whole bucket: the leaves packed into one
    buffer a rank and one dense fold (elementwise, so packing keeps the
    bits)."""
    fused = [torch.cat([g.reshape(-1) for g in rl]) for rl in leaves]
    red = ranks.run(dense_allreduce, fused)
    del fused
    sizes = [g.numel() for g in leaves[0]]
    return [[p.view(g.shape) for p, g in zip(r.split(sizes), rl)]
            for r, rl in zip(red, leaves)]


def _fused_axis_allreduce(ranks: _Ranks, leaves: list, topo,
                          chunks: int = 1) -> list:
    """One FlexTree allreduce for a whole bucket: ``leaves[r]`` is local
    rank r's list of the bucket's leaves.  The leaves' divisible heads go
    to one scheduled collective (block-interleaved on the ring), their
    < N-element remainders to one dense fold; see the module docstring for
    why each packing keeps the bits.  Each buffer is packed fresh a rank
    and dropped when its collective is done."""
    n = ranks.size
    if n <= 1:
        return leaves
    topo = Topology.resolve(n, topo)
    count = len(leaves[0])
    if isinstance(topo, LonelyTopology) or count == 1:
        # a lonely shape folds by position: per leaf
        cols = [sync_leaf(ranks, [rl[i] for rl in leaves], topo, chunks)
                for i in range(count)]
        return [[cols[i][r] for i in range(count)] for r in range(len(leaves))]

    numels = [g.numel() for g in leaves[0]]
    mains = [(s // n) * n for s in numels]
    head_ids = [i for i, m in enumerate(mains) if m]
    tail_ids = [i for i, (s, m) in enumerate(zip(numels, mains)) if s > m]
    flats = [[g.reshape(-1) for g in rl] for rl in leaves]
    heads: list[dict] = [{} for _ in leaves]
    tails: list[dict] = [{} for _ in leaves]

    if head_ids:
        if topo.is_ring:
            widths = [mains[i] // n for i in head_ids]
            fused = [torch.cat([f[i][:mains[i]].view(n, -1) for i in head_ids],
                               dim=1).view(-1) for f in flats]
            red = ranks.run(allreduce, fused, topo=topo, op="sum")
            del fused
            for r, out in enumerate(red):
                for i, piece in zip(head_ids, out.view(n, -1).split(widths, 1)):
                    heads[r][i] = piece.reshape(-1)
        else:
            fused = [torch.cat([f[i][:mains[i]] for i in head_ids])
                     for f in flats]
            red = ranks.run(allreduce, fused, topo=topo, op="sum",
                            chunks=chunks)
            del fused
            for r, out in enumerate(red):
                pieces = out.split([mains[i] for i in head_ids])
                heads[r].update(zip(head_ids, pieces))
    if tail_ids:
        fused = [torch.cat([f[i][mains[i]:] for i in tail_ids]) for f in flats]
        red = ranks.run(dense_allreduce, fused)
        del fused
        for r, out in enumerate(red):
            pieces = out.split([numels[i] - mains[i] for i in tail_ids])
            tails[r].update(zip(tail_ids, pieces))

    out = []
    for r, rl in enumerate(leaves):
        row = []
        for i, g in enumerate(rl):
            h, t = heads[r].get(i), tails[r].get(i)
            if h is None and t is None:
                row.append(g)  # a leaf of no elements
            elif t is None:
                row.append(h.view(g.shape))
            elif h is None:
                row.append(t.view(g.shape))
            else:
                row.append(torch.cat([h, t]).view(g.shape))
        out.append(row)
    return out


def _fused_compressed_bucket(ranks: _Ranks, leaves: list, axes, topos,
                             codec, chunks: int, step, name: str, prov,
                             return_residual: bool):
    """A lossy bucket: each rank's leaves packed into one float32 buffer,
    one :func:`.compressed.compressed_allreduce` an axis (the sentinel
    stays the exact dense fold), each under the span ``name(axis)`` with
    ``prov(axis)``, unpacked to the leaves' shapes and dtypes.  Returns
    (leaves, residuals): the residual of the first axis' wire when that
    axis is compressed (the only one that sees this rank's own data), else
    :func:`.compressed.local_residual` of the packed input (None without
    ``return_residual``)."""
    fused = [torch.cat([g.reshape(-1).to(torch.float32) for g in rl])
             for rl in leaves]
    packed, res = fused, None
    for k, ax in enumerate(axes):
        on = ranks.along(ax)
        with comm_span(name(ax), provenance=prov(ax)):
            if topos[ax] is None:
                fused = on.run(dense_allreduce, fused)
            elif k == 0 and return_residual:
                fused, res = on.run_pair(
                    compressed_allreduce, fused, topo=topos[ax], codec=codec,
                    chunks=chunks, step=step, return_residual=True)
            else:
                fused = on.run(compressed_allreduce, fused, topo=topos[ax],
                               codec=codec, chunks=chunks, step=step)
    if return_residual and res is None:
        res = [local_residual(p, codec, step) for p in packed]
    sizes = [g.numel() for g in leaves[0]]

    def unpack(bufs):
        return [[p.view(g.shape).to(g.dtype) for p, g in zip(b.split(sizes), rl)]
                for b, rl in zip(bufs, leaves)]

    return unpack(fused), None if res is None else unpack(res)


def bucketed_sync_grads(grads, pspecs, mesh_axes, topos: Mapping[str, Any],
                        bucket_bytes: int | None = None, chunks: int = 1,
                        *, comm, codec="f32", step=0,
                        return_residual: bool = False):
    """The bucketed FlexTree gradient sync, the fused twin of
    ``train.sync_grads``: each leaf summed over its replication axes,
    bitwise what the per-leaf sync gives, in buckets x stages collectives
    instead of leaves x stages.

    ``comm``: a :class:`Mesh` (``grads`` is the list of its ranks' trees;
    returns a list) or a process group (``grads`` is this rank's tree).
    ``topos``: each axis' topology (``train.resolve_axis_topos``; None =
    the ``"psum"`` sentinel).  ``bucket_bytes=None`` sizes the buckets by
    the planner; ``chunks > 1`` runs each bucket's tree chunk-pipelined.
    Each bucket's collectives on an axis run under one
    :func:`~..utils.profiling.comm_span` named
    ``ft_bucket{i}_{axis}_{k}leaves_{bytes}B``, with the plan's provenance
    when a flight recorder is installed.

    A lossy ``codec`` runs each bucket through
    :func:`.compressed.compressed_allreduce` under spans named
    ``ftq_bucket...`` (no bitwise contract; the planner sizes the buckets
    with the codec), ``step`` keying the rounding;
    ``return_residual=True`` then returns ``(synced, residuals)``, each
    leaf's error-feedback residual (zeros for a leaf no bucket holds)."""
    from ..obs import bucket_provenance
    from ..ops.quantize import get_codec

    codec = get_codec(codec)
    ranks = _Ranks(comm)
    trees = list(grads) if ranks.mesh else [grads]
    flat = [tree_leaves(t) for t in trees]
    specs = spec_leaves(trees[0], pspecs)
    sizes = comm_axis_sizes(comm, mesh_axes)
    buckets = plan_buckets(flat[0], specs, mesh_axes, topos=topos,
                           axis_sizes=sizes, bucket_bytes=bucket_bytes,
                           codec=codec if codec.lossy else None)
    res = [[torch.zeros_like(g) for g in f] for f in flat] \
        if return_residual else None
    for bi, b in enumerate(buckets):
        leaves = [[f[i] for i in b.indices] for f in flat]
        tag = "ftq" if codec.lossy else "ft"

        def name(ax):
            return f"{tag}_bucket{bi}_{ax}_{len(b.indices)}leaves_{b.nbytes}B"

        def prov(ax):
            return bucket_provenance((ax,), topos, b.nbytes,
                                     n_leaves=len(b.indices), dtype=b.dtype,
                                     codec=codec, chunks=chunks)

        if codec.lossy:
            leaves, got = _fused_compressed_bucket(
                ranks, leaves, b.axes, topos, codec, chunks, step, name,
                prov, return_residual)
            for r, rl in enumerate(got or []):
                for i, g in zip(b.indices, rl):
                    res[r][i] = g
        else:
            for ax in b.axes:
                on = ranks.along(ax)
                with comm_span(name(ax), provenance=prov(ax)):
                    if topos[ax] is None:
                        leaves = _fused_native_psum(on, leaves)
                    else:
                        leaves = _fused_axis_allreduce(on, leaves,
                                                       topos[ax], chunks)
        for f, rl in zip(flat, leaves):
            for i, g in zip(b.indices, rl):
                f[i] = g
    out = _unflatten_ranks(trees, flat, ranks)
    if return_residual:
        return out, _unflatten_ranks(trees, res, ranks)
    return out


def _allreduce_folds(n: int, topo, count: int, chunks: int) -> list:
    """The fold stages of one ``allreduce`` of ``count`` elements a rank:
    :func:`.allreduce.call_shape`'s, a tree's head once a chunk."""
    if topo is None:
        return [(n, n, count)] if count else []
    if topo.is_ring or isinstance(topo, LonelyTopology) or chunks <= 1:
        return call_shape(n, topo, count).folds
    head = (count // n) * n
    folds = [f for size in (chunk_sizes(head, n, chunks) if head else [])
             for f in call_shape(n, topo, size).folds]
    return folds + ([(n, n, count - head)] if count > head else [])


def sync_fold_stages(numels: Sequence[int], n: int, topo, buckets=None,
                     chunks: int = 1, codec=None, sharded: bool = False,
                     shard_n: int | None = None) -> list:
    """The fold stages, in order, of one sync over one axis of ``n`` ranks
    that share a device, each ``(R folds, W sources, L elements)``: one
    :func:`~..ops.reduce_stacked.reduce_sources` call (the count
    ``allreduce.call_shape`` derives for one allreduce, over a sync).
    ``numels``: the leaves' element counts; ``topo``: the axis' resolved
    topology (None: the sentinel's dense fold); ``buckets``: a plan of
    :func:`plan_buckets` (None: the per-leaf sync); ``codec``: the sync's
    wire codec (a lossy one folds each bucket, packed, as one
    :func:`.compressed.compressed_allreduce`).

    ``sharded``: the ZeRO-1 sync (:func:`.zero.zero_reduce_scatter_grads`
    over a ``plan_buckets(sharded=True)`` plan): each bucket's heads, packed,
    fold as one reduce-scatter on the shard topology
    (:func:`.zero.shard_topo`; ``chunks`` does not apply), its tails as one
    dense fold.  The parameters' all-gather folds nothing.

    ``shard_n``: one secondary axis of that sync (``n`` its ranks), whose
    buckets are sharded over an axis of ``shard_n`` ranks: each bucket's
    owned blocks, packed, fold as one allreduce on ``topo`` (the
    compressed one under a lossy codec; the dense fold for the sentinel),
    its tails as one dense fold."""
    from ..ops.quantize import get_codec

    codec = get_codec(codec)
    if n <= 1:
        return []
    groups = [[i] for i in range(len(numels))] if buckets is None else \
        [list(b.indices) for b in buckets]
    folds: list = []
    for idxs in groups:
        sizes = [int(numels[i]) for i in idxs]
        if shard_n is not None:
            folds += _secondary_folds(n, topo, sizes, shard_n, codec)
        elif sharded:
            folds += _reduce_scatter_folds(n, topo, sizes, codec)
        elif codec.name == "int8" and topo is not None:
            folds += int8_fold_stages(n, topo, sum(sizes), chunks)
        elif codec.lossy or topo is None:
            folds += _allreduce_folds(n, topo, sum(sizes), chunks)
        elif len(sizes) == 1 or isinstance(topo, LonelyTopology):
            for size in sizes:
                folds += _allreduce_folds(n, topo, size, chunks)
        else:
            heads = sum((s // n) * n for s in sizes)
            tails = sum(sizes) - heads
            if heads:
                folds += _allreduce_folds(n, topo, heads, chunks)
            if tails:
                folds.append((n, n, tails))
    return folds


def _reduce_scatter_folds(n: int, topo, sizes, codec) -> list:
    """The fold stages of one ZeRO-1 bucket's reduce-scatter (leaves of
    ``sizes`` elements): the block-interleaved heads' phase 1 on the shard
    topology, then the tails' dense fold."""
    from .zero import shard_topo

    heads = sum((s // n) * n for s in sizes)
    tails = sum(sizes) - heads
    folds: list = []
    if heads:
        t = shard_topo(topo, n)
        if codec.name == "int8":
            folds += int8_fold_stages(n, t, heads)
        else:
            folds += call_shape(n, t, heads).folds
    if tails:
        folds.append((n, n, tails))
    return folds


def _secondary_folds(n: int, topo, sizes, shard_n: int, codec) -> list:
    """The fold stages of one ZeRO-1 bucket on a secondary axis of ``n``
    ranks (:func:`.zero._secondary_sync`): its owned blocks (``size //
    shard_n`` of each leaf), packed, allreduced on ``topo``, and its tails
    in one dense fold."""
    tile = sum(s // shard_n for s in sizes)
    tails = sum(s - (s // shard_n) * shard_n for s in sizes)
    folds: list = []
    if tile:
        if topo is None:
            folds.append((n, n, tile))
        elif codec.name == "int8":
            folds += int8_fold_stages(n, Topology.resolve(n, topo), tile)
        else:
            folds += _allreduce_folds(n, Topology.resolve(n, topo), tile, 1)
    if tails:
        folds.append((n, n, tails))
    return folds


def mesh_fold_launches(leaves, specs, mesh_axes, axis_sizes, topos,
                       bucket_bytes: int | None = None, codec=None,
                       sharded: bool = False) -> int:
    """The fold kernel's launches of one sync over an in-process mesh of
    ``axis_sizes``, from the code: each bucket of :func:`plan_buckets` (on
    one rank's ``leaves``) on each of its axes, once a group along the
    axis (:func:`sync_fold_stages`, one launch a ``MAX_POINTERS // (W +
    1)`` folds of a stage); ``sharded``, ZeRO-1's: the shard axis'
    reduce-scatter and each secondary axis' allreduce of the owned blocks
    (``sync_fold_stages(sharded=True)`` and ``(shard_n=)``).  The count a
    run on the card is held to."""
    from ..ops.quantize import get_codec
    from ..ops.reduce_stacked import MAX_POINTERS

    codec = get_codec(codec)
    world = math.prod(int(axis_sizes.get(a, 1)) for a in mesh_axes)
    plan = plan_buckets(leaves, specs, mesh_axes, topos=topos,
                        axis_sizes=axis_sizes, bucket_bytes=bucket_bytes,
                        codec=codec if codec.lossy else None,
                        sharded=sharded)
    numels = [g.numel() for g in leaves]
    total = 0
    for b in plan:
        for k, ax in enumerate(b.axes):
            n = int(axis_sizes[ax])
            kw = {}
            if sharded:
                kw = dict(sharded=True) if k == 0 else \
                    dict(shard_n=int(axis_sizes[b.axes[0]]))
            stages = sync_fold_stages(numels, n, topos.get(ax), [b],
                                      codec=codec, **kw)
            total += world // n * sum(-(-r // (MAX_POINTERS // (w + 1)))
                                      for r, w, _ in stages)
    return total
