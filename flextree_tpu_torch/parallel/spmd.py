"""Named axes of an in-process mesh, and the collectives over them.

The port's counterpart of what ``shard_map`` gives the JAX package: a
function there runs once a device with the mesh's axes bound by name, and
``lax.ppermute``, ``lax.all_to_all`` and ``lax.psum`` move data along one
of them.  Here one process runs every rank of a :class:`~.mesh.Mesh` in
lock-step: a value that differs by rank is a list with one tensor a rank
(in the mesh's rank order), and an :class:`Axis` names one mesh axis.  Its
groups are the sets of ranks that differ only in their coordinate along
that axis, each in axis-index order; every collective acts on each group
on its own, as the JAX collective acts on each set of devices that share
the other axes' coordinates.

The collectives are differentiable, and each backward is the JAX
transpose: :meth:`Axis.ppermute` and :meth:`Axis.all_to_all` only move
tensors (a message is a device copy, none between ranks on one device),
so autograd sends each cotangent back along the inverse permutation or
the inverse all-to-all; :meth:`Axis.allreduce`, the FlexTree sum on the
fold kernel (:func:`.allreduce.allreduce`), runs the same sum over the
cotangents in its backward, which is what JAX's autodiff of the
ppermute-built walk computes.  One ``torch.autograd.grad`` over the sum of
every rank's loss then gives each rank's leaves the gradient of the summed
loss with respect to that rank's own copy, as JAX's autodiff under
``shard_map`` does (``flextree_tpu/parallel/train.py:19-27``).
"""

from __future__ import annotations

import functools
import itertools

import torch

from .mesh import Mesh

__all__ = ["Axis", "axis", "coords", "rank_coords", "block_index",
           "shard_tree", "rank_slices", "rank_trees", "gather_leaf",
           "gather_tree", "shard_batch"]


def rank_coords(mesh: Mesh) -> list[tuple[int, ...]]:
    """Each rank's coordinates on ``mesh``: row-major, the last axis
    fastest, as a JAX mesh lays its devices out."""
    return list(itertools.product(*(range(s) for s in mesh.shape)))


class _Allreduce(torch.autograd.Function):
    """The FlexTree sum of one group's tensors; its backward is the same
    sum of the cotangents."""

    @staticmethod
    def forward(ctx, group_mesh, topo, *xs):
        from .allreduce import allreduce

        ctx.group_mesh, ctx.topo = group_mesh, topo
        return tuple(allreduce(list(xs), group_mesh, topo=topo, op="sum"))

    @staticmethod
    def backward(ctx, *gs):
        from .allreduce import allreduce

        got = allreduce([g.contiguous() for g in gs], ctx.group_mesh,
                        topo=ctx.topo, op="sum")
        return (None, None, *got)


class Axis:
    """One named axis of an in-process :class:`~.mesh.Mesh`: the handle the
    port passes as ``sp_axis``/``tp_axis`` where the JAX package passes an
    axis name.  ``size`` is the axis' length, ``index[r]`` rank r's
    coordinate along it, ``groups`` the tuples of ranks that differ only
    along it (each in axis-index order) and ``meshes`` each group as a
    one-axis mesh of its ranks' devices."""

    def __init__(self, mesh: Mesh, name: str):
        if name not in mesh.axis_names:
            raise ValueError(f"mesh axes {mesh.axis_names} have no {name!r}")
        k = mesh.axis_names.index(name)
        self.mesh, self.name = mesh, name
        self.size = int(mesh.shape[k])
        coords = rank_coords(mesh)
        self.index = tuple(c[k] for c in coords)
        groups: dict = {}
        for r, c in enumerate(coords):
            groups.setdefault(c[:k] + c[k + 1:], []).append(r)
        self.groups = tuple(tuple(g) for g in groups.values())
        self.meshes = tuple(Mesh(tuple(mesh.devices[r] for r in g), (name,))
                            for g in self.groups)

    def __repr__(self) -> str:
        return f"Axis({self.name!r}, size={self.size})"

    def _check(self, xs) -> list:
        xs = list(xs)
        if len(xs) != self.mesh.size:
            raise ValueError(f"{len(xs)} tensors for the {self.mesh.size} "
                             f"ranks of axis {self.name!r}'s mesh")
        return xs

    def run(self, fn, xs, **kw) -> list:
        """A collective of the :mod:`.allreduce` family (``fn(list, mesh,
        **kw) -> list``) on each group, results back in rank order."""
        xs = self._check(xs)
        out: list = [None] * len(xs)
        for g, m in zip(self.groups, self.meshes):
            for r, y in zip(g, fn([xs[r] for r in g], m, **kw)):
                out[r] = y
        return out

    def ppermute(self, xs, perm) -> list:
        """``lax.ppermute``: ``perm`` is ``(source, destination)`` pairs of
        axis indices; in each group the destination gets the source's
        tensor and a rank no pair names gets zeros."""
        xs = self._check(xs)
        out: list = [None] * len(xs)
        for g in self.groups:
            for src, dst in perm:
                out[g[dst]] = xs[g[src]].to(self.mesh.devices[g[dst]])
            for r in g:
                if out[r] is None:
                    out[r] = torch.zeros_like(xs[r])
        return out

    def all_to_all(self, xs, split_axis: int, concat_axis: int) -> list:
        """The tiled ``lax.all_to_all``: each rank's tensor splits into
        ``size`` pieces along ``split_axis``, piece i goes to the group's
        i-th rank, which concatenates what it gets along ``concat_axis`` in
        source order."""
        xs = self._check(xs)
        n = self.size
        if xs[0].shape[split_axis] % n:
            raise ValueError(f"all_to_all over {self.name!r}: dimension "
                             f"{split_axis} of {tuple(xs[0].shape)} does not "
                             f"split into {n}")
        out: list = [None] * len(xs)
        for g in self.groups:
            pieces = [xs[r].chunk(n, dim=split_axis) for r in g]
            for i, r in enumerate(g):
                dev = self.mesh.devices[r]
                out[r] = torch.cat([p[i].to(dev) for p in pieces],
                                   dim=concat_axis)
        return out

    def psum(self, xs) -> list:
        """``lax.psum`` of small values (the loss, the norm's square-sums):
        each group's tensors added in axis-index order, the sum on every
        member."""
        xs = self._check(xs)
        out: list = [None] * len(xs)
        for g in self.groups:
            total = xs[g[0]]
            for r in g[1:]:
                total = total + xs[r].to(total.device)
            for r in g:
                out[r] = total.to(self.mesh.devices[r])
        return out

    def allreduce(self, xs, topo=None) -> list:
        """The FlexTree allreduce (sum) of each group's tensors on ``topo``
        (None: ``FT_TOPO`` or flat), every fold on the fold kernel;
        differentiable, its backward the same allreduce of the cotangents.
        An axis of size 1 returns the tensors themselves, as the JAX
        allreduce does."""
        xs = self._check(xs)
        if self.size == 1:
            return xs
        out: list = [None] * len(xs)
        for g, m in zip(self.groups, self.meshes):
            for r, y in zip(g, _Allreduce.apply(m, topo, *(xs[r] for r in g))):
                out[r] = y
        return out


@functools.lru_cache(maxsize=64)
def axis(mesh: Mesh, name: str) -> Axis:
    """The :class:`Axis` ``name`` of ``mesh``, built once a mesh and
    name."""
    return Axis(mesh, name)


def coords(mesh: Mesh, name: str) -> tuple:
    """Each rank's index along mesh axis ``name`` (0 where the mesh has no
    such axis)."""
    if name in mesh.axis_names:
        return axis(mesh, name).index
    return (0,) * mesh.size


def block_index(mesh: Mesh, names, r: int) -> tuple[int, int]:
    """``(index, count)`` of rank ``r``'s block along the mesh axes
    ``names`` (row-major over them, as ``PartitionSpec`` lays a dimension
    over several axes); axes the mesh lacks have size 1."""
    idx, count = 0, 1
    for name in names:
        size = dict(zip(mesh.axis_names, mesh.shape)).get(name, 1)
        idx, count = idx * size + coords(mesh, name)[r], count * size
    return idx, count


def _spec_names(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def shard_tree(tree, pspecs, mesh: Mesh) -> list:
    """Every rank's slice of a full tree: each leaf cut along each
    dimension its spec names (``param_specs``), the rank's block kept as a
    contiguous tensor of its own; a replicated leaf is the tensor itself.
    Returns one tree a rank, in rank order."""
    from ..utils.tree import tree_leaves, tree_unflatten
    from .bucketing import spec_leaves

    leaves = tree_leaves(tree)
    specs = spec_leaves(tree, pspecs)
    out = []
    for r in range(mesh.size):
        mine = []
        for leaf, spec in zip(leaves, specs):
            for d, entry in enumerate(tuple(spec) if spec is not None else ()):
                idx, count = block_index(mesh, _spec_names(entry), r)
                if count > 1:
                    w = leaf.shape[d] // count
                    leaf = leaf.narrow(d, idx * w, w).contiguous()
            mine.append(leaf)
        out.append(tree_unflatten(tree, mine))
    return out


def shard_batch(x, spec, mesh: Mesh) -> list:
    """Every rank's block of a batch tensor laid out by ``spec`` (a spec
    as :func:`shard_tree` reads it, e.g. ``(("dp", "ep"), "sp")``: the rows
    over dp and ep jointly, row-major as ``PartitionSpec`` lays them, the
    columns over sp), as views of ``x``, in rank order."""
    out = []
    for r in range(mesh.size):
        block = x
        for d, entry in enumerate(spec):
            idx, count = block_index(mesh, _spec_names(entry), r)
            if x.shape[d] % count:
                raise ValueError(f"dimension {d} of {tuple(x.shape)} does "
                                 f"not split over {entry} ({count} blocks)")
            w = x.shape[d] // count
            block = block.narrow(d, idx * w, w)
        out.append(block)
    return out


def rank_slices(tree, pspecs, comm, n: int = 1) -> list:
    """Each local rank's tree of a full tree: its slices on a mesh
    (:func:`shard_tree`), the tree itself for each of ``n`` local ranks
    otherwise (a process group's rank, or a DP mesh's)."""
    if isinstance(comm, Mesh):
        return shard_tree(tree, pspecs, comm)
    return [tree] * n


def rank_trees(tree, pspecs, mesh: Mesh) -> list:
    """Every rank's tree: ``tree`` itself when it is already the list of
    the ranks' trees, else one full tree cut for every rank
    (:func:`shard_tree`), as a fresh or restored state carries a per-rank
    buffer such as the error-feedback residual."""
    if isinstance(tree, list):
        return tree
    return shard_tree(tree, pspecs, mesh)


def gather_leaf(xs: list, spec, mesh: Mesh):
    """One leaf of :func:`gather_tree`: every rank's block ``xs`` (in rank
    order) put back in place along each dimension ``spec`` shards, each
    block the first rank's that holds it; a replicated leaf is the first
    rank's."""
    dims = [(d, _spec_names(e)) for d, e in
            enumerate(tuple(spec) if spec is not None else ())
            if block_index(mesh, _spec_names(e), 0)[1] > 1]
    if not dims:
        return xs[0]
    first = xs[0]
    shape = list(first.shape)
    for d, names in dims:
        shape[d] *= block_index(mesh, names, 0)[1]
    full = first.new_empty(shape)
    placed = set()
    for r in range(mesh.size):
        at = tuple(block_index(mesh, names, r)[0] for _, names in dims)
        if at in placed:
            continue
        placed.add(at)
        view = full
        for (d, _), idx in zip(dims, at):
            w = first.shape[d]
            view = view.narrow(d, idx * w, w)
        view.copy_(xs[r])
    return full


def gather_tree(trees, pspecs, mesh: Mesh):
    """The inverse of :func:`shard_tree` for trees that agree across the
    axes a leaf is replicated on: each leaf's blocks put back in place
    along every dimension its spec shards (a stacked pipeline leaf ``(pp,
    None, tp)`` or an expert leaf ``(ep, None, tp)`` along two), each
    block the first rank's that holds it (:func:`gather_leaf`); a
    replicated leaf is the first rank's."""
    from ..utils.tree import tree_leaves, tree_unflatten
    from .bucketing import spec_leaves

    flat = [tree_leaves(t) for t in trees]
    specs = spec_leaves(trees[0], pspecs)
    return tree_unflatten(trees[0], [gather_leaf([f[i] for f in flat], spec,
                                                 mesh)
                                     for i, spec in enumerate(specs)])
