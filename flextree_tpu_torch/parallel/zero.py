"""ZeRO-1, the sharded optimizer: the FlexTree split collectives on the
gradient-sync seam.

The port's copy of ``flextree_tpu/parallel/zero.py``.  The replicated step
keeps the whole AdamW state on every data-parallel rank and syncs each
gradient with a full allreduce.  But FlexTree's phase 1 already is a
reduce-scatter and its phase 2 an all-gather
(:func:`.allreduce.reduce_scatter`, :func:`.allreduce.all_gather`), so the
step splits at that seam:

1. each gradient bucket **reduce-scatters** over its shard axis, the
   first of its replication axes above size 1 (dp on the data-parallel
   and dense meshes; pp or ep for the embedding of the pipeline and MoE
   meshes, sp for their layers), its folds on the fold kernel, compressed
   hop by hop under a lossy codec;
2. each further replication axis (a **secondary** axis) allreduces only
   the owned block (the FlexTree allreduce, compressed under a lossy
   codec) and the tails (a dense fold), so every rank of a secondary
   group holds the same block;
3. AdamW runs on the block each rank **owns**, against moments of that
   block alone;
4. the updated blocks are **all-gathered** back into the parameters over
   the shard axis alone (the secondary axes already hold the same block),
   one gather a bucket.

Shard layout (the JAX package's contract): each leaf's divisible head
splits into ``N`` blocks, and the rank at shard-axis position ``r`` owns
block ``shard_layout(shard_topo(topo, N))[r]``
(:func:`..schedule.blocks.owned_block`; not the identity for ``2,2,2`` or
``4,2``).  The ``< N``-element tail of each leaf goes through one dense
fold a bucket (:func:`.allreduce.dense_allreduce`, the port's stand-in for
the JAX package's native ``psum``) and is updated replicated on every
rank.  A bucket packs its leaves' heads **block-interleaved** (fused block
``b`` is every leaf's block ``b``), so one collective a bucket yields each
leaf's shard and every element keeps the ring block it has in the
replicated fused sync: the sharded step is **bitwise** the replicated one
for the identity codec, with clipping off, on flat, tree and ring shard
topologies (and, on a wide mesh, where the secondary axes fold each
element in the order the replicated sync does).  Lonely shapes and the ``"psum"`` sentinel shard over the flat
tree (:func:`shard_topo`).

State: ``mu_shard``/``nu_shard`` hold the owned blocks, ``*_tail`` the
replicated tails, ``*_rep`` the whole leaf of a leaf no axis syncs (every
leaf on one rank); a lossy codec adds the float32 master copy
``master_shard``/``master_tail``, zeros until the first update, when the
(still exact) working parameters stand in for it.  On an in-process
:class:`~.mesh.Mesh` a ``*_shard`` leaf is the JAX package's host-global
buffer: ``(N·M·tile,)`` float32 laid out as ``P((shard_ax, *model
axes))``, the block of the rank at shard position ``s`` and model
position ``m`` (its row-major index over the leaf's own spec axes, ``M``
of them) at slot ``s·M + m``; a ``*_tail`` leaf is ``(M·tail,)``, slot
``m``.  On the data-parallel mesh ``M`` is 1 and rank ``r``'s block sits
at ``[r·tile, (r+1)·tile)``.  Ranks that differ only along a secondary
axis hold the same block; the buffer keeps the first's, as the JAX
package's ``device_get`` reads it.  On a ``torch.distributed`` group (one
data-parallel axis) each rank holds its own ``(tile,)``, as each JAX
device does.

Checkpoints are consolidated (:func:`make_consolidate_fn`): every leaf's
moment shards are all-gathered back to the replicated layout
``{"params", "mu", "nu", "step"[, "ef"]}``, which does not depend on the
world size, which the replicated step resumes from and which
:func:`make_reshard_fn` carves into any world's shards.  The error-feedback
residual is written as it stands: the first rank's tree, as the JAX
package's ``device_get`` reads the first device's.

On a wide mesh the error-feedback residual is each rank's tree of its
own slices; the checkpoint holds, slice by slice, the first rank's that
holds it (:func:`..spmd.gather_tree`).  ``zero_state_specs`` has no
counterpart: the port keeps no PartitionSpecs of state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import torch

from ..schedule.blocks import shard_layout
from ..schedule.stages import LonelyTopology, Topology
from ..utils.profiling import comm_span
from ..utils.tree import tree_leaves, tree_map, tree_unflatten
from .allreduce import all_gather, allreduce, dense_allreduce, reduce_scatter
from .bucketing import (
    _Ranks,
    comm_axis_sizes,
    plan_buckets,
    replication_key,
    spec_axes,
    spec_leaves,
)
from .compressed import compressed_allreduce, compressed_reduce_scatter
from .mesh import Mesh
from .spmd import axis, block_index, gather_leaf, rank_slices, rank_trees

__all__ = [
    "ZeroShard",
    "ZeroLeafPlan",
    "ZeroLayout",
    "shard_topo",
    "build_zero_layout",
    "init_zero_entries",
    "zero_reduce_scatter_grads",
    "zero_apply_and_gather",
    "zero_sync_and_update",
    "sharded_grad_norm",
    "maybe_clip_shards",
    "checkpoint_ef",
    "make_consolidate_fn",
    "make_reshard_fn",
    "zero_shard_bytes",
]


class ZeroShard:
    """One leaf's reduce-scattered gradient: the owned head block ``tile``
    and the replicated ``tail``.  Not a dict, list or tuple, so the tree
    helpers treat it as a leaf and the overlap engine carries shard trees
    through its per-segment machinery unchanged."""

    __slots__ = ("tile", "tail")

    def __init__(self, tile, tail):
        self.tile = tile
        self.tail = tail


@dataclasses.dataclass(frozen=True)
class ZeroLeafPlan:
    """The sharding plan of one leaf, the JAX ``ZeroLeafPlan`` field for
    field.  Sizes are per rank (a model-parallel axis of the leaf's spec
    has carved it first)."""

    index: int
    axes: tuple[str, ...]  # replication axes (size > 1), mesh order
    model_axes: tuple[str, ...]  # axes the leaf's spec names, mesh order
    shard_ax: str | None  # axes[0], or None for a leaf no axis syncs
    n: int  # shard-axis size (1 when unsharded)
    size: int  # local element count
    head: int  # (size // n) * n
    tile: int  # head // n: the owned elements
    tail: int  # size - head: the replicated elements

    @property
    def sharded(self) -> bool:
        return self.shard_ax is not None


@dataclasses.dataclass(frozen=True)
class ZeroLayout:
    """The whole tree's sharding plan, built from parameter shapes, specs
    and axis sizes alone: only the block permutation (:meth:`perm_for`)
    reads the topology."""

    mesh_axes: tuple[str, ...]
    axis_sizes: Mapping[str, int]
    leaves: tuple[ZeroLeafPlan, ...]

    @property
    def n_sharded(self) -> int:
        return sum(1 for leaf in self.leaves if leaf.sharded)

    def perm_for(self, topos: Mapping[str, Any], ax: str) -> tuple[int, ...]:
        """The block owned by each shard-axis position of ``ax`` under the
        resolved ``topos``."""
        n = int(self.axis_sizes[ax])
        return shard_layout(shard_topo(topos.get(ax), n))


def shard_topo(topo, n: int):
    """The topology the sharded collectives run on an axis of ``n`` ranks
    (the JAX ``_shard_topo``): ``topo`` resolved, except that the
    ``"psum"`` sentinel (None) and a lonely shape take the flat tree (a
    lonely rank owns no block)."""
    if topo is None:
        return Topology.flat(n)
    topo = Topology.resolve(n, topo)
    if isinstance(topo, LonelyTopology):
        return Topology.flat(n)
    return topo


def _local_size(shape, spec, axis_sizes: Mapping[str, int]) -> int:
    """Per-rank element count of a leaf of global ``shape`` under
    ``spec``."""
    total = 1
    for d in shape:
        total *= int(d)
    denom = 1
    for a in spec_axes(spec):
        denom *= int(axis_sizes.get(a, 1))
    return total // denom


def build_zero_layout(params_shapes, pspecs, mesh_axes,
                      axis_sizes: Mapping[str, int],
                      local: bool = False) -> ZeroLayout:
    """The sharding plan of a parameter tree (tensors of any device,
    ``"meta"`` included, or a flat list of them with a list of specs): each
    leaf shards over the first mesh axis above size 1 it is replicated on;
    a leaf replicated on none stays unsharded.  ``local=False`` divides
    each shape by the sizes of the axes its spec names, ``local=True``
    takes the sizes as per-rank ones."""
    flat_p = tree_leaves(params_shapes)
    flat_s = spec_leaves(params_shapes, pspecs)
    leaves = []
    for i, (p, spec) in enumerate(zip(flat_p, flat_s)):
        axes = tuple(a for a in replication_key(spec, mesh_axes)
                     if int(axis_sizes.get(a, 1)) > 1)
        named = set(spec_axes(spec))
        model_axes = tuple(a for a in mesh_axes if a in named)
        size = p.numel() if local else _local_size(p.shape, spec, axis_sizes)
        shard_ax, n = (axes[0], int(axis_sizes[axes[0]])) if axes else \
            (None, 1)
        tile = size // n
        leaves.append(ZeroLeafPlan(i, axes, model_axes, shard_ax, n, size,
                                   tile * n, tile, size - tile * n))
    return ZeroLayout(tuple(mesh_axes), dict(axis_sizes), tuple(leaves))


# ------------------------------------------------------------ state layout


def init_zero_entries(params, layout: ZeroLayout, lossy: bool, *,
                      local: bool = False) -> dict:
    """The sharded optimizer's state entries around ``params`` (zeros, on
    the params' device): ``*_shard`` the owned blocks, ``*_tail`` the
    tails, ``*_rep`` the whole leaf of an unsharded leaf; a lossy codec
    adds ``master_shard``/``master_tail`` (zeros: the first update takes
    the working params, when it knows which block a rank owns).  Empty
    slots are ``(0,)`` float32, so every entry has the params' structure.
    ``local=False``: a ``*_shard`` leaf holds every rank's block, the JAX
    package's host-global ``(N·tile,)`` (an in-process mesh); ``True``:
    this rank's own ``(tile,)`` (a process group).  On a wide mesh the
    global buffers have a slot for each model position too (the module
    docstring)."""
    flat_p = tree_leaves(params)
    dev = flat_p[0].device

    def zeros(n):
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    def build(part):
        out = []
        for plan, p in zip(layout.leaves, flat_p):
            if part == "rep":
                out.append(torch.zeros_like(p) if not plan.sharded
                           else zeros(0))
            elif not plan.sharded:
                out.append(zeros(0))
            elif part == "shard":
                out.append(zeros(plan.tile * (1 if local else plan.n *
                                              _n_model(layout, plan))))
            else:
                out.append(zeros(plan.tail * (1 if local else
                                              _n_model(layout, plan))))
        return tree_unflatten(params, out)

    entries = {}
    for key in ("mu", "nu") + (("master",) if lossy else ()):
        for part in ("shard", "tail", "rep"):
            if key != "master" or part != "rep":
                entries[f"{key}_{part}"] = build(part)
    return entries


def _n_model(layout: ZeroLayout, plan: ZeroLeafPlan) -> int:
    """``M``, the model positions of a leaf: the product of the sizes of
    the mesh axes its own spec names."""
    m = 1
    for a in plan.model_axes:
        m *= int(layout.axis_sizes.get(a, 1))
    return m


class _Slots:
    """Where a leaf's blocks sit, for the local ranks of ``comm``:
    ``slot[r]`` is local rank ``r``'s slot of the ``*_shard`` buffer,
    ``model[r]`` its model position (its slot of ``*_tail``, and which
    slice of the parameter it holds), ``holder[c]`` the first local rank
    of slot ``c`` and ``model_holder[m]`` of model position ``m``.  On a
    process group the buffer has one slot, this rank's."""

    def __init__(self, comm, plan: ZeroLeafPlan):
        if isinstance(comm, Mesh):
            ranks = range(comm.size)
            self.slot = [block_index(comm, (plan.shard_ax,) + plan.model_axes,
                                     r)[0] for r in ranks]
            self.model = [block_index(comm, plan.model_axes, r)[0]
                          for r in ranks]
            self.n_model = block_index(comm, plan.model_axes, 0)[1]
        else:
            self.slot, self.model, self.n_model = [0], [0], 1
        self.holder = _firsts(self.slot)
        self.model_holder = _firsts(self.model)


def _firsts(keys: list) -> list:
    """The first index holding each of the values ``0 .. max(keys)``."""
    first: dict = {}
    for r, k in enumerate(keys):
        first.setdefault(k, r)
    return [first[k] for k in range(len(first))]


def _local_ranks(comm) -> list[int]:
    """The shard-axis positions this process holds: every rank of a mesh,
    this rank of a process group, rank 0 alone without a ``comm``."""
    if comm is None:
        return [0]
    if isinstance(comm, Mesh):
        return list(range(comm.size))
    import torch.distributed as dist

    return [dist.get_rank(comm)]


# -------------------------------------------------------- collective layer


def _interleave_pack(heads: Sequence[torch.Tensor], n: int) -> torch.Tensor:
    """Block-interleaved bucket packing: fused block ``b`` is every leaf's
    block ``b``, one after another, so one collective yields each leaf's
    shard and each element keeps its leaf's block index (the packing the
    replicated fused sync gives the ring)."""
    cols = [h.view(n, -1) for h in heads]
    fused = cols[0] if len(cols) == 1 else torch.cat(cols, dim=1)
    return fused.reshape(-1)


def _uninterleave(flat: torch.Tensor, n: int,
                  widths: Sequence[int]) -> list[torch.Tensor]:
    """The inverse of :func:`_interleave_pack` on a whole (n-block)
    buffer."""
    return [piece.reshape(-1) for piece in flat.view(n, -1).split(widths, 1)]


def _rs_wire(ranks: _Ranks, fused: list, topo, codec, step):
    """Phase 1 of one packed bucket on every local rank: the owned blocks
    and, under a lossy codec, each rank's residual of the wire's input
    quantization.  The split collectives are the one wire implementation;
    the packed bucket divides into blocks, so their tail path never
    runs."""
    if not codec.lossy:
        return ranks.run(reduce_scatter, fused, topo=topo), None
    return ranks.run_pair(compressed_reduce_scatter, fused, topo=topo,
                          codec=codec, step=step, return_residual=True)


def _empty(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros((0,), dtype=torch.float32, device=like.device)


def zero_reduce_scatter_grads(grads, pspecs, mesh_axes,
                              topos: Mapping[str, Any], *, comm,
                              layout: ZeroLayout | None = None,
                              bucket_bytes: int | None = None, codec="f32",
                              step=0, return_residual: bool = False):
    """The sharded gradient sync, phase 1: one reduce-scatter a bucket of
    ``plan_buckets(sharded=True)`` over the shard axis (block-interleaved,
    compressed under a lossy ``codec``, ``step`` keying its rounding) and
    one dense fold a bucket for the tails; then, over each secondary
    replication axis of the bucket, the owned block allreduced (the
    FlexTree allreduce on the axis' topology, compressed under a lossy
    codec; the dense fold for the ``"psum"`` sentinel) and the tails
    folded dense (the JAX package's shard allreduce).

    ``comm``: a :class:`~.mesh.Mesh` (``grads`` is the list of its ranks'
    trees; returns a list) or a process group (``grads`` is this rank's
    tree).  Each synced leaf comes back as a :class:`ZeroShard` of this
    rank's block and the tail; a leaf no bucket holds passes through.
    ``layout=None`` builds it from the gradients (their sizes are per
    rank).  Each bucket runs under the span
    ``ftz_rs_bucket{i}_{axis}_{k}leaves_{bytes}B``.
    ``return_residual=True`` returns ``(shards, residuals)``: each leaf's
    error-feedback residual, the wire's first-hop loss on its head (the
    shard axis' reduce-scatter, the only one that sees this rank's own
    data) and zeros on its exact tail (zeros for a leaf no bucket
    holds)."""
    from ..ops.quantize import get_codec

    codec = get_codec(codec)
    mesh = isinstance(comm, Mesh)
    trees = list(grads) if mesh else [grads]
    flat = [tree_leaves(t) for t in trees]
    specs = spec_leaves(trees[0], pspecs)
    sizes = comm_axis_sizes(comm, mesh_axes)
    if layout is None:
        layout = build_zero_layout(flat[0], specs, mesh_axes, sizes,
                                   local=True)
    buckets = plan_buckets(flat[0], specs, mesh_axes, topos=topos,
                           axis_sizes=sizes, bucket_bytes=bucket_bytes,
                           codec=codec if codec.lossy else None, sharded=True)
    out = [list(f) for f in flat]
    res = [[torch.zeros_like(g) for g in f] for f in flat] \
        if return_residual else None
    ranks = _Ranks(comm) if buckets else None
    for bi, b in enumerate(buckets):
        plans = [layout.leaves[i] for i in b.indices]
        shard_ax = b.axes[0]
        n = int(sizes[shard_ax])
        topo = shard_topo(topos.get(shard_ax), n)
        on = ranks.along(shard_ax)
        heads = [p for p in plans if p.tile]
        tails = [p for p in plans if p.tail]
        widths = [p.tile for p in heads]
        name = f"ftz_rs_bucket{bi}_{shard_ax}_{len(b.indices)}leaves_" \
               f"{b.nbytes}B"
        tiles = red_tails = None
        with comm_span(name):
            if heads:
                fused = [_interleave_pack(
                    [f[p.index].reshape(-1).to(torch.float32)[:p.head]
                     for p in heads], n) for f in flat]
                tiles, wire = _rs_wire(on, fused, topo, codec, step)
                del fused
                for r, w in enumerate(wire if return_residual and wire
                                      else []):
                    for p, piece in zip(heads, _uninterleave(w, n, widths)):
                        g = flat[r][p.index]
                        full = torch.zeros(p.size, dtype=torch.float32,
                                           device=g.device)
                        full[:p.head] = piece
                        res[r][p.index] = full.view(g.shape).to(g.dtype)
            if tails:
                red_tails = on.run(dense_allreduce, [torch.cat(
                    [f[p.index].reshape(-1).to(torch.float32)[p.head:]
                     for p in tails]) for f in flat])
            for ax in b.axes[1:]:
                tiles, red_tails = _secondary_sync(
                    ranks.along(ax), tiles, red_tails, topos.get(ax),
                    int(sizes[ax]), codec, step)
        for r, f in enumerate(flat):
            by_tile = dict(zip([p.index for p in heads],
                               tiles[r].split(widths))) if heads else {}
            by_tail = dict(zip([p.index for p in tails], red_tails[r].split(
                [p.tail for p in tails]))) if tails else {}
            for i in b.indices:
                out[r][i] = ZeroShard(by_tile.get(i, _empty(f[i])),
                                      by_tail.get(i, _empty(f[i])))
    got = [tree_unflatten(t, o) for t, o in zip(trees, out)]
    got = got if mesh else got[0]
    if not return_residual:
        return got
    back = [tree_unflatten(t, o) for t, o in zip(trees, res)]
    return got, back if mesh else back[0]


def _secondary_sync(on: _Ranks, tiles, tails, topo, n: int, codec, step):
    """One secondary replication axis of a sharded bucket: every rank's
    owned block summed over its group on the axis (the FlexTree allreduce
    on ``topo``, compressed under a lossy codec; the dense fold for the
    ``"psum"`` sentinel, None) and its tails by the dense fold.  Either
    may be None (no heads, no tails)."""
    if tiles is not None:
        if topo is None:
            tiles = on.run(dense_allreduce, tiles)
        elif codec.lossy:
            tiles = on.run(compressed_allreduce, tiles,
                           topo=Topology.resolve(n, topo), codec=codec,
                           step=step)
        else:
            tiles = on.run(allreduce, tiles, topo=Topology.resolve(n, topo),
                           op="sum")
    if tails is not None:
        tails = on.run(dense_allreduce, tails)
    return tiles, tails


# ----------------------------------------------------------- update + AG


def _bias_corrections(train_cfg, t):
    """AdamW's ``1 - b1^t`` and ``1 - b2^t`` at the 1-based float step."""
    return 1.0 - train_cfg.b1 ** t, 1.0 - train_cfg.b2 ** t


def _adamw_elem(p, g, mu, nu, c1, c2, train_cfg):
    """AdamW's element math, ``(delta, mu, nu)``; ``p - lr * delta`` is the
    update.  :func:`.train.adamw_apply` runs it on whole leaves and
    :func:`zero_apply_and_gather` on owned blocks, so the two cannot drift
    (in float32 the same inputs through the same expression give the same
    bits)."""
    b1, b2 = train_cfg.b1, train_cfg.b2
    mu = b1 * mu + (1.0 - b1) * g
    nu = b2 * nu + (1.0 - b2) * (g * g)
    delta = (mu / c1) / (torch.sqrt(nu / c2) + train_cfg.eps)
    if train_cfg.weight_decay:
        delta = delta + train_cfg.weight_decay * p
    return delta, mu, nu


def _rank_sum(parts: list, comm):
    """Per-rank partial sums summed in rank order, on every rank (the JAX
    ``psum`` of a scalar over a process group's one data-parallel
    axis)."""
    from .train import _global_loss

    return _global_loss(parts, comm)


def _square_sum(x) -> torch.Tensor:
    return torch.sum(torch.square(x.float()))


def sharded_grad_norm(shard_trees, pspecs, layout: ZeroLayout, *, comm):
    """The true global L2 norm of a sharded gradient (``shard_trees`` in
    :func:`zero_reduce_scatter_grads`' form), the JAX function's: each
    rank's squares grouped by the axes they are summed over, an owned
    block's by the shard axis and the axes of the leaf's spec (the blocks
    partition the head over the shard axis), a tail's and an unsharded
    leaf's by the leaf's spec axes alone (whole on every rank of the shard
    axis); each group summed over its axes in turn
    (:meth:`.spmd.Axis.psum` on a mesh; a process group's partials in rank
    order) and the groups added in the order they first appear.  A tensor
    parallel slice joins once: its group sums over tp."""
    mesh = isinstance(comm, Mesh)
    trees = list(shard_trees) if mesh else [shard_trees]
    flat = [tree_leaves(t) for t in trees]
    specs = spec_leaves(trees[0], pspecs)
    by_key: list[dict] = [{} for _ in flat]

    def add(groups, key, val):
        groups[key] = val if key not in groups else groups[key] + val

    for f, groups in zip(flat, by_key):
        for plan, spec in zip(layout.leaves, specs):
            g, leaf_axes = f[plan.index], spec_axes(spec)
            if isinstance(g, ZeroShard):
                if plan.tile:
                    add(groups, (plan.shard_ax,) + leaf_axes,
                        _square_sum(g.tile))
                if plan.tail:
                    add(groups, leaf_axes, _square_sum(g.tail))
            else:
                add(groups, leaf_axes, _square_sum(g))
    total = None
    for key in by_key[0]:
        sq = [groups[key] for groups in by_key]
        for ax in key:
            if mesh and ax in comm.axis_names:
                sq = axis(comm, ax).psum(sq)
            elif not mesh and int(layout.axis_sizes.get(ax, 1)) > 1:
                sq = [_rank_sum(sq, comm)]
        total = sq if total is None else [t + s_ for t, s_ in zip(total, sq)]
    return torch.sqrt(total[0])


def maybe_clip_shards(shard_trees, pspecs, train_cfg, layout: ZeroLayout,
                      metrics: dict | None, *, comm):
    """The sharded twin of ``train.maybe_clip_grads``: the global norm from
    the owned blocks (:func:`sharded_grad_norm`), recorded in
    ``metrics["grad_norm"]`` and applied.  It sums in another order than
    the replicated norm, so the sharded step is bitwise the replicated one
    only with clipping off."""
    if not train_cfg.grad_clip_norm:
        return shard_trees
    if train_cfg.grad_clip_norm < 0:
        raise ValueError(
            f"grad_clip_norm must be positive, got {train_cfg.grad_clip_norm}")
    norm = sharded_grad_norm(shard_trees, pspecs, layout, comm=comm)
    if metrics is not None:
        metrics["grad_norm"] = norm
    scale = torch.clamp(train_cfg.grad_clip_norm
                        / torch.clamp(norm, min=1e-12), max=1.0)

    def scl(g):
        if isinstance(g, ZeroShard):
            return ZeroShard(g.tile * scale, g.tail * scale)
        return g * scale.to(g.dtype)

    if isinstance(comm, Mesh):
        return [tree_map(scl, t) for t in shard_trees]
    return tree_map(scl, shard_trees)


_MOMENT_KEYS = ("mu_shard", "mu_tail", "mu_rep", "nu_shard", "nu_tail",
                "nu_rep")


def _own_blocks(by_model: list, plan: ZeroLeafPlan, perm, comm):
    """A leaf's ``*_shard`` buffer from its flat float32 slices by model
    position: each slot's owned block (the block ``perm`` gives its shard
    position), in the buffer's order."""
    n, tile = plan.n, plan.tile
    if isinstance(comm, Mesh):
        rows = [p[:plan.head].view(n, tile)[list(perm)] for p in by_model]
        return torch.stack(rows, 1).reshape(-1)
    own = [perm[r] for r in _local_ranks(comm)]
    return by_model[0][:plan.head].view(n, tile)[own].reshape(-1)


def _part(buf, k: int, width: int):
    """Slot ``k`` of a buffer of ``width``-element slots."""
    return buf[k * width:(k + 1) * width]


def zero_apply_and_gather(state, shard_trees, pspecs, mesh_axes,
                          topos: Mapping[str, Any], train_cfg,
                          layout: ZeroLayout, *, comm):
    """Phase 2 of the sharded step: AdamW on the owned blocks and the
    tails, then one parameter all-gather a bucket over its shard axis (the
    gradient's buckets, compressed under the step's codec with rounding
    key ``step + 1``; every rank decodes the same bytes, and a lossy codec
    updates the float32 master, which takes the working params while
    ``state["step"]`` is 0).  Returns the new state, the params whole.

    On a mesh every slot's block updates as one buffer (the state's own
    layout; elementwise, so the bits are each rank's), each slot from the
    first rank that holds it (the ranks of a secondary group hold the same
    block); the gather's results of one model position are bitwise equal,
    and the first's is put back into the parameter
    (:func:`..spmd.gather_leaf`).  The update reads no scalar on the host,
    except a lossy codec's rounding key."""
    from ..ops.quantize import get_codec
    from .train import schedule_lr

    codec = get_codec(train_cfg.codec)
    lossy = codec.lossy
    mesh = isinstance(comm, Mesh)
    local = _local_ranks(comm)
    step = state["step"] + 1
    c1, c2 = _bias_corrections(train_cfg, step.to(torch.float32))
    lr = schedule_lr(train_cfg, step)
    bootstrap = state["step"] == 0  # the master holds zeros before step 1
    params = state["params"]
    flat_p = tree_leaves(params)
    slices = [tree_leaves(t) for t in rank_slices(params, pspecs, comm)]
    flat_g = [tree_leaves(t) for t in (shard_trees if mesh
                                       else [shard_trees])]
    specs = spec_leaves(params, pspecs)
    sizes = comm_axis_sizes(comm, mesh_axes)
    old = {k: tree_leaves(state[k]) for k in _MOMENT_KEYS
           + (("master_shard", "master_tail") if lossy else ())}
    new = {k: list(v) for k, v in old.items()}
    new_p: list = list(flat_p)
    buckets = plan_buckets(slices[0], specs, mesh_axes, topos=topos,
                           axis_sizes=sizes,
                           bucket_bytes=train_cfg.bucket_bytes,
                           codec=codec if lossy else None, sharded=True)
    bucketed = {i for b in buckets for i in b.indices}

    # leaves no axis syncs: the replicated update on the whole leaf
    for i in range(len(flat_p)):
        if i in bucketed:
            continue
        p = flat_p[i]
        g = gather_leaf([f[i] for f in flat_g], specs[i], comm) if mesh \
            else flat_g[0][i]
        d, new["mu_rep"][i], new["nu_rep"][i] = _adamw_elem(
            p, g.to(p.dtype), old["mu_rep"][i], old["nu_rep"][i], c1, c2,
            train_cfg)
        new_p[i] = p - lr * d

    ag_step = int(state["step"]) + 1 if lossy else 0
    ranks = _Ranks(comm) if buckets else None
    for bi, b in enumerate(buckets):
        shard_ax = b.axes[0]
        n = int(sizes[shard_ax])
        topo = shard_topo(topos.get(shard_ax), n)
        perm = layout.perm_for(topos, shard_ax)
        heads, new_tiles, new_tails, slots = [], {}, {}, {}
        for i in b.indices:
            plan = layout.leaves[i]
            at = slots[i] = _Slots(comm, plan)
            by_model = [slices[r][i].reshape(-1).to(torch.float32)
                        for r in at.model_holder]
            if plan.tile:
                own_block = _own_blocks(by_model, plan, perm, comm)
                p_tile = torch.where(bootstrap, own_block,
                                     old["master_shard"][i]) \
                    if lossy else own_block
                g_tile = torch.cat([flat_g[r][i].tile for r in at.holder]) \
                    if len(at.holder) > 1 else flat_g[at.holder[0]][i].tile
                d, new["mu_shard"][i], new["nu_shard"][i] = _adamw_elem(
                    p_tile, g_tile, old["mu_shard"][i], old["nu_shard"][i],
                    c1, c2, train_cfg)
                new_tiles[i] = p_tile - lr * d
                if lossy:
                    new["master_shard"][i] = new_tiles[i]
                heads.append(plan)
            if plan.tail:
                p_tail = torch.cat([p[plan.head:] for p in by_model])
                if lossy:
                    p_tail = torch.where(bootstrap, p_tail,
                                         old["master_tail"][i])
                g_tail = torch.cat([flat_g[r][i].tail
                                    for r in at.model_holder])
                d, new["mu_tail"][i], new["nu_tail"][i] = _adamw_elem(
                    p_tail, g_tail, old["mu_tail"][i], old["nu_tail"][i],
                    c1, c2, train_cfg)
                # every rank computed the same exact tail: it needs no wire
                new_tails[i] = p_tail - lr * d
                if lossy:
                    new["master_tail"][i] = new_tails[i]
        full_by = {}
        if heads:
            at = slots[heads[0].index]
            packed = [torch.cat([_part(new_tiles[p.index], at.slot[r],
                                       p.tile) for p in heads])
                      for r in range(len(local))]
            name = f"ftz_ag_bucket{bi}_{shard_ax}_{len(b.indices)}leaves_" \
                   f"{b.nbytes}B"
            with comm_span(name):  # compressed under a lossy codec
                full = ranks.along(shard_ax).run(
                    all_gather, packed, topo=topo, codec=codec, step=ag_step)
            del packed
            for m, r in enumerate(at.model_holder):
                for p, piece in zip(heads, _uninterleave(
                        full[r], n, [p.tile for p in heads])):
                    full_by[p.index, m] = piece
            del full
        for i in b.indices:
            plan, at = layout.leaves[i], slots[i]
            pieces = []
            for m, r in enumerate(at.model_holder):
                parts = [x for x in (full_by.get((i, m)), _part(
                    new_tails[i], m, plan.tail) if plan.tail else None)
                    if x is not None]
                pieces.append((parts[0] if len(parts) == 1 else
                               torch.cat(parts)).view(slices[r][i].shape))
            whole = gather_leaf([pieces[m] for m in at.model], specs[i],
                                comm) if mesh else pieces[0]
            new_p[i] = whole.view(flat_p[i].shape).to(flat_p[i].dtype)
    out = {"params": tree_unflatten(params, new_p), "step": step}
    for k, vals in new.items():
        out[k] = tree_unflatten(params, vals)
    return out


def zero_sync_and_update(state, grads, pspecs, mesh_axes, topos, train_cfg,
                         layout: ZeroLayout, metrics: dict | None = None, *,
                         comm):
    """The whole sharded optimizer step: the error-feedback merge, each
    bucket's reduce-scatter, clipping from the shards, sharded AdamW and
    each bucket's parameter all-gather; returns the new state.  The twin
    of ``train.sync_with_feedback`` + ``maybe_clip_grads`` +
    ``adamw_apply``, bitwise for the identity codec with clipping off.
    ``grads`` in ``comm``'s form (a list of the ranks' trees on a mesh).
    A lossy codec syncs ``grad + ef`` keyed by ``state["step"]`` and keeps
    each rank's residual in ``"ef"`` (on a mesh the list of the ranks'
    trees; one tree, fresh or restored, is cut for every rank)."""
    from ..ops.quantize import get_codec

    codec = get_codec(train_cfg.codec)
    new_ef = None
    kw = dict(comm=comm, layout=layout, bucket_bytes=train_cfg.bucket_bytes)
    if codec.lossy:
        ef = state["ef"]
        if isinstance(comm, Mesh):
            v = [tree_map(lambda g, e: g + e.to(g.dtype), g, e)
                 for g, e in zip(grads, rank_trees(ef, pspecs, comm))]
        else:
            v = tree_map(lambda g, e: g + e.to(g.dtype), grads, ef)
        shards, new_ef = zero_reduce_scatter_grads(
            v, pspecs, mesh_axes, topos, codec=codec,
            step=int(state["step"]), return_residual=True, **kw)
    else:
        shards = zero_reduce_scatter_grads(grads, pspecs, mesh_axes, topos,
                                           **kw)
    shards = maybe_clip_shards(shards, pspecs, train_cfg, layout, metrics,
                               comm=comm)
    new = zero_apply_and_gather(state, shards, pspecs, mesh_axes, topos,
                                train_cfg, layout, comm=comm)
    if new_ef is not None:
        new["ef"] = new_ef
    return new


# -------------------------------------------------- consolidate / reshard


def checkpoint_ef(ef, pspecs, comm):
    """The residual a checkpoint holds: one tree as it stands; on a mesh
    the ranks' list assembled slice by slice from the first rank that
    holds each (:func:`..spmd.gather_tree`), what the JAX package's
    ``device_get`` reads."""
    from .spmd import gather_tree

    if isinstance(ef, list):
        return gather_tree(ef, pspecs, comm) if isinstance(comm, Mesh) \
            else ef[0]
    return ef


def make_consolidate_fn(comm, pspecs, layout: ZeroLayout, grad_topo,
                        lossy: bool):
    """``sharded state -> consolidated checkpoint state``.

    Each leaf's moment (and master) shards are all-gathered back to the
    replicated layout through the step's own ``all_gather`` on the shard
    topology, over the shard axis (each model position's slice, put back
    into the whole leaf on a wide mesh): ``{"params", "mu", "nu",
    "step"[, "ef"]}``, the same for any world size and what the replicated
    step resumes from.  Under a lossy codec ``params`` are the float32
    master (the authoritative copy), except at step 0, when the master
    still holds zeros and the working params stand in; ``ef`` is
    :func:`checkpoint_ef`'s."""
    from .train import resolve_axis_topos

    topos = resolve_axis_topos(comm_axis_sizes(comm, layout.mesh_axes),
                               layout.mesh_axes, grad_topo)
    mesh = isinstance(comm, Mesh)
    local = _local_ranks(comm)

    def consolidate(state):
        params = state["params"]
        flat_p = tree_leaves(params)
        specs = spec_leaves(params, pspecs)
        slices = [tree_leaves(t) for t in rank_slices(params, pspecs, comm)]
        ranks = _Ranks(comm) if layout.n_sharded else None

        def gather(shard_key, tail_key, rep_key):
            sh, tl, rp = (tree_leaves(state[k]) for k in
                          (shard_key, tail_key, rep_key))
            out = []
            for plan, base, spec in zip(layout.leaves, flat_p, specs):
                i = plan.index
                if not plan.sharded:
                    out.append(rp[i].to(base.dtype))
                    continue
                at = _Slots(comm, plan)
                shards = [torch.cat([_part(sh[i], at.slot[r], plan.tile),
                                     _part(tl[i], at.model[r], plan.tail)])
                          for r in range(len(local))]
                full = ranks.along(plan.shard_ax).run(
                    all_gather, shards,
                    topo=shard_topo(topos.get(plan.shard_ax), plan.n),
                    out_shape=slices[0][i].shape)
                whole = gather_leaf(full, spec, comm) if mesh else full[0]
                out.append(whole.to(base.dtype))
            return tree_unflatten(params, out)

        out = {"params": params,
               "mu": gather("mu_shard", "mu_tail", "mu_rep"),
               "nu": gather("nu_shard", "nu_tail", "nu_rep"),
               "step": state["step"]}
        if lossy:
            first = state["step"] == 0
            out["params"] = tree_map(
                lambda m, p: torch.where(first, p, m),
                gather("master_shard", "master_tail", "params"), params)
            out["ef"] = checkpoint_ef(state["ef"], pspecs, comm)
        return out

    return consolidate


def make_reshard_fn(comm, pspecs, layout: ZeroLayout, grad_topo,
                    lossy: bool):
    """``consolidated state -> sharded state`` for ``layout``'s world (any
    world size): each slot takes its owned blocks of every leaf's moments
    (and, lossy, of the params as the master), and each model position
    its tails whole (:func:`make_consolidate_fn`'s inverse)."""
    from .train import resolve_axis_topos

    topos = resolve_axis_topos(comm_axis_sizes(comm, layout.mesh_axes),
                               layout.mesh_axes, grad_topo)

    def reshard(state):
        params = state["params"]

        def split(tree):
            sl = [tree_leaves(t) for t in rank_slices(tree, pspecs, comm)]
            shards, tails, reps = [], [], []
            for plan, v in zip(layout.leaves, tree_leaves(tree)):
                if not plan.sharded:
                    shards.append(_empty(v))
                    tails.append(_empty(v))
                    reps.append(v)
                    continue
                by_model = [sl[r][plan.index].reshape(-1).to(torch.float32)
                            for r in _Slots(comm, plan).model_holder]
                shards.append(_own_blocks(
                    by_model, plan, layout.perm_for(topos, plan.shard_ax),
                    comm) if plan.tile else _empty(v))
                tails.append(torch.cat([p[plan.head:] for p in by_model]))
                reps.append(_empty(v))
            return tuple(tree_unflatten(params, x)
                         for x in (shards, tails, reps))

        out = {"params": params, "step": state["step"]}
        for key in ("mu", "nu"):
            out[f"{key}_shard"], out[f"{key}_tail"], out[f"{key}_rep"] = \
                split(state[key])
        if lossy:
            out["master_shard"], out["master_tail"], _ = split(params)
            out["ef"] = state["ef"]
        return out

    return reshard


def zero_shard_bytes(layout: ZeroLayout, lossy: bool = False) -> dict:
    """The optimizer state's bytes a rank under ``layout`` against the
    replicated layout's: ``mu`` and ``nu`` (and, lossy, the sharded
    master) in float32; the working params, whole on both sides, are left
    out."""
    sharded = replicated = 0
    for leaf in layout.leaves:
        leaf_rep = 2 * 4 * leaf.size
        replicated += leaf_rep
        if leaf.sharded:
            per_rank = 2 * 4 * (leaf.tile + leaf.tail)
            if lossy:
                per_rank += 4 * (leaf.tile + leaf.tail)
            sharded += per_rank
        else:
            sharded += leaf_rep
    return {
        "replicated_bytes": replicated,
        "sharded_bytes_per_rank": sharded,
        "ratio": (sharded / replicated) if replicated else 1.0,
    }
