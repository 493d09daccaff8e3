"""The dense train step, on one card or data-parallel over N ranks.

The dense branch of ``flextree_tpu/parallel/train.py``'s
``make_train_step``: forward, the summed cross entropy over the global
token count, backward, the gradient sync, global-norm clipping and an
inline AdamW (decoupled weight decay), all in float32 on the state.

The train state is the JAX package's pytree in the port's types —
``{"params", "mu", "nu", "step"}``, the moments param-shaped float32,
``step`` a 0-d int32 tensor, and for a lossy ``codec`` the error-feedback
residual ``"ef"`` — so it converts to and from the JAX state by copy
(:mod:`..convert`) and checkpoints in the same file format
(:mod:`..utils.checkpoint`).

Data parallelism: ``comm`` is an in-process :class:`~.mesh.Mesh` with a
``"dp"`` axis (every rank in this process, on one device) or a
``torch.distributed`` process group (this process is one rank).  As the
JAX ``shard_map`` does, the global batch splits into contiguous row blocks
over dp; each rank runs its own forward and backward with its loss
divided by the global token count; the global loss is the ranks' losses
summed in rank order; the ranks' gradient trees go through
:func:`sync_grads`, the FlexTree sync (bucketed by default,
:mod:`.bucketing`; every fold on the fold kernel); then clipping and
AdamW.  On a mesh the synced trees are bitwise equal, so the step applies
one update; on a process group each rank updates its own replica.  With
no ``comm`` the step runs on one rank and the sync is the identity, as the
JAX sync is on a mesh of one device.

A lossy ``codec`` (``"bf16"``, ``"int8"``) syncs ``grad + ef`` on the
compressed collectives with ``step`` the counter before the update
(:func:`sync_with_feedback`) and keeps the new residual.  As in the JAX
step, whose ``shard_map`` gives each device its own ``ef`` buffer, the
residual is each rank's own: on a mesh ``state["ef"]`` becomes the list
of the ranks' trees after the first step; one tree (a fresh state, a
restored checkpoint) stands for every rank's.  A checkpoint holds the
first rank's tree, what the JAX package's ``device_get`` reads.

With ``overlap`` the step runs :func:`.overlap.dense_overlap_step_grads`
in place of the whole backward and the sync: each rank's backward split
into readiness segments, run on every rank in lock-step, each gradient
bucket synced as its last segment finishes (on a card, on a side stream);
``serialize_overlap`` builds its serialized twin.  Without it the program
is the one described above.

With ``shard_optimizer`` (ZeRO-1, :mod:`.zero`) the state holds each
rank's block of the moments (``mu_shard``, ``nu_shard``; the tails in
``*_tail``; a leaf no axis syncs, every leaf on one rank, in ``*_rep``;
a lossy codec's float32 master in ``master_*``) and the sync, clipping and
AdamW become :func:`.zero.zero_sync_and_update`: each gradient bucket
reduce-scattered on the FlexTree walker, AdamW on the owned blocks, the
parameters all-gathered; with ``overlap`` each fired bucket
reduce-scatters and the update and gather follow the backward.  For the
identity codec with clipping off it is bitwise the replicated step.
Build its state with :func:`init_train_state` ``(comm=)``, or
:func:`make_train_state` with :func:`zero_layout_for`'s layout.

Sequence and tensor parallelism: ``comm`` a :class:`~.mesh.Mesh` whose
``"sp"`` or ``"tp"`` axis is above size 1 runs the JAX step over the full
``(dp, sp, tp)`` mesh (:func:`make_train_step`).  The global batch splits
into rows over dp and columns over sp (JAX's ``P(dp, sp)``); each rank
gets its slices of the tp-sharded leaves (:func:`..models.transformer.
param_specs`, :func:`.spmd.shard_tree`), each a leaf of its own; every
rank's forward runs in lock-step, layer by layer, with the ring, zigzag
or Ulysses attention over its sp group and the row-parallel partials
summed over its tp group by the FlexTree allreduce (:mod:`.spmd`); one
``torch.autograd.grad`` over every rank's loss (its cross entropy over
the global token count times tp, the tp-fold redundancy JAX counts) gives
each rank's copy its gradient; each leaf is synced over its replication
axes, one walk an axis over each group of the mesh (:func:`sync_grads`);
clipping takes the norm by axis group (:func:`global_grad_norm`); the
synced tp slices go back into the state's full tree
(:func:`.spmd.gather_tree`), and AdamW, elementwise, updates it as on one
rank.  The state and its checkpoints are the same at every mesh shape.

The pipeline and MoE steps (:mod:`.pipeline`, :mod:`.moe_train`) share
this path's lock-step backward and sync (:func:`spmd_grads`) and its
clipping and update (:func:`spmd_update`) over their 4-axis meshes.

The wide meshes take every option the data-parallel one does.  A lossy
``codec`` syncs each rank's ``grad + ef`` over each replication axis
(:func:`sync_with_feedback`); the residual is each rank's tree of its own
slices (one tree, fresh or restored, is cut for every rank by
:func:`.spmd.rank_trees`), the wire's of the leaf's first replication
axis above size 1; a checkpoint holds, slice by slice, the first rank's
(:func:`.zero.checkpoint_ef`).  ``shard_optimizer`` reduce-scatters each
bucket over its shard axis and allreduces the owned block over the
secondary axes (:mod:`.zero`); ``overlap`` cuts every rank's backward into
readiness segments at once, across the ranks the ring hops and the
combine couple (:func:`.overlap.dense_overlap_step_grads`).

What needs an unported module raises, naming its ROADMAP item:
``autotune``, and a pipeline or MoE step over a ``torch.distributed``
group (:func:`.pipeline.step_mesh`): a process group is one data-parallel
axis (:func:`.bucketing.comm_axis_sizes`).  An IR-family ``grad_topo``
(swing, generalized) raises ``TopologyError``, as the JAX train seam
does.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import operator
from typing import Any, Mapping

import torch

from ..models.transformer import (
    TransformerConfig,
    cross_entropy_loss,
    forward,
    init_params,
    param_specs,
)
from ..ops.quantize import get_codec
from ..schedule.stages import Topology, TopologyError
from ..utils.tree import tree_leaves, tree_map, tree_unflatten
from .bucketing import (
    bucketed_sync_grads,
    comm_axis_sizes,
    per_leaf_sync_grads,
)
from .mesh import Mesh
from .spmd import axis, gather_tree, rank_trees, shard_batch, shard_tree
from .zero import (
    _adamw_elem,
    _bias_corrections,
    build_zero_layout,
    init_zero_entries,
    maybe_clip_shards,
    zero_apply_and_gather,
    zero_sync_and_update,
)

__all__ = [
    "TrainConfig",
    "AXIS_NAMES",
    "make_train_state",
    "init_train_state",
    "zero_layout_for",
    "make_loss_and_grads",
    "make_train_step",
    "factor_devices",
    "spread_factors",
    "make_mesh_nd",
    "validate_tp",
    "spmd_grads",
    "spmd_update",
    "spmd_step",
    "step_layout",
    "mesh_overlap_plan",
    "step_sync_fold_launches",
    "overlap_stream",
    "psum_all",
    "resolve_axis_topos",
    "sync_grads",
    "sync_with_feedback",
    "schedule_lr",
    "global_grad_norm",
    "clip_by_global_norm",
    "maybe_clip_grads",
    "adamw_apply",
    "tree_map",
    "tree_leaves",
    "tree_unflatten",
]

#: the JAX train step's mesh axes: data, sequence and tensor parallelism
AXIS_NAMES = ("dp", "sp", "tp")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX ``TrainConfig``, field for field (see its comments)."""

    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_topo: Any = None
    grad_clip_norm: float = 0.0
    schedule: str = "constant"
    warmup_steps: int = 0
    total_steps: int = 0
    min_lr_frac: float = 0.1
    bucket_bytes: int | None = None
    grad_chunks: int = 1
    codec: str = "f32"
    autotune: bool = False
    overlap: bool = False
    shard_optimizer: bool = False


def _refuse_unported(train_cfg: TrainConfig) -> None:
    """Raise for a config that needs a module the port does not have yet,
    naming the ROADMAP item it waits on (and ``ValueError`` for an unknown
    codec)."""
    get_codec(train_cfg.codec)
    refusals = (
        (train_cfg.autotune, "autotune=True",
         "'Checkpoint, supervision and feedback plumbing' (autotune)"),
    )
    for bad, what, item in refusals:
        if bad:
            raise NotImplementedError(
                f"TrainConfig {what} is not ported yet (ROADMAP.md, "
                f"Queue 1: {item})"
            )


# ------------------------------------------------------------------- state


def zero_layout_for(comm, params_shapes, pspecs, axis_names=AXIS_NAMES):
    """The :class:`~.zero.ZeroLayout` of a parameter tree over ``comm`` (a
    :class:`~.mesh.Mesh`, a process group, or None: one rank, where every
    leaf is unsharded): the one plan the state, the step and the
    checkpoint converters share, so they cannot disagree on who owns which
    block."""
    return build_zero_layout(params_shapes, pspecs, tuple(axis_names),
                             comm_axis_sizes(comm, axis_names))


def make_train_state(params: dict, train_cfg: TrainConfig | None = None, *,
                     layout=None, local: bool = False) -> dict:
    """Fresh AdamW state around ``params``: zero moments and step 0 on
    the params' device, and a zero ``"ef"`` residual only for a lossy
    codec (the identity keeps the JAX package's layout).

    ``train_cfg.shard_optimizer`` puts the sharded entries of
    :func:`.zero.init_zero_entries` in place of ``mu``/``nu``, under
    ``layout`` (:func:`zero_layout_for`; None: one rank's, every leaf
    ``*_rep``); ``local``: each ``*_shard`` leaf is this rank's block
    alone (a process group) rather than every rank's (a mesh)."""
    if train_cfg is not None:
        _refuse_unported(train_cfg)
    dev = params["embed"].device
    lossy = train_cfg is not None and get_codec(train_cfg.codec).lossy
    step = torch.zeros((), dtype=torch.int32, device=dev)
    if train_cfg is not None and train_cfg.shard_optimizer:
        if layout is None:
            layout = zero_layout_for(None, params, None)
        state = {"params": params, "step": step}
        state.update(init_zero_entries(params, layout, lossy, local=local))
    else:
        state = {
            "params": params,
            "mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params),
            "step": step,
        }
    if lossy:
        state["ef"] = tree_map(torch.zeros_like, params)
    return state


def init_train_state(cfg: TransformerConfig, generator: torch.Generator,
                     train_cfg: TrainConfig | None = None,
                     device=None, comm=None) -> dict:
    """Parameters from ``init_params(cfg, generator, device)`` (default
    device ``cuda``) in a fresh AdamW state; under ``shard_optimizer`` its
    moments are sharded over ``comm``, the step's (the JAX
    ``init_train_state(mesh=)``; None: one rank, every leaf ``*_rep``)."""
    params = init_params(cfg, generator, device=device)
    layout = None
    if train_cfg is not None and train_cfg.shard_optimizer:
        layout = zero_layout_for(comm, params,
                                 param_specs(cfg, AXIS_NAMES[-1]))
    return make_train_state(params, train_cfg, layout=layout,
                            local=comm is not None
                            and not isinstance(comm, Mesh))


# ---------------------------------------------------------------- the step


def spread_factors(n: int, n_dims: int, order=None) -> tuple:
    """The JAX ``spread_factors``: ``n``'s prime factors, largest first,
    dealt round-robin over the dimensions in ``order`` (default 0 ..
    n_dims - 1)."""
    from ..planner.factorize import prime_factors

    order = list(range(n_dims)) if order is None else list(order)
    dims = [1] * n_dims
    for i, f in enumerate(sorted(prime_factors(n), reverse=True)):
        dims[order[i % n_dims]] *= f
    return tuple(dims)


def factor_devices(n: int) -> tuple[int, int, int]:
    """Split ``n`` devices into a (dp, sp, tp) shape, the JAX
    ``factor_devices``: prime factors, largest first, dealt round-robin to
    dp, sp, tp (8 -> (2, 2, 2), 4 -> (2, 2, 1), 7 -> (7, 1, 1))."""
    return spread_factors(n, 3)


def make_mesh_nd(n_devices: int | None, shape, axis_names,
                 device=None) -> Mesh:
    """The JAX ``make_mesh_nd`` on one device: a :class:`~.mesh.Mesh` of
    ``shape`` x ``axis_names`` whose ranks all run on ``device`` (default
    ``cuda``) in this process; ``n_devices`` (None: the shape's product)
    must be the shape's product."""
    from ..device import resolve_device

    n = math.prod(shape) if n_devices is None else n_devices
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {tuple(shape)} does not cover {n} "
                         f"devices")
    return Mesh((resolve_device(device),) * n, tuple(axis_names),
                tuple(shape))


def validate_tp(model_cfg: TransformerConfig, tp_size: int) -> None:
    """The JAX ``validate_tp``: ``n_heads`` divides ``d_model`` and is
    divisible by tp, and so is ``d_ff``."""
    if model_cfg.d_model % model_cfg.n_heads or model_cfg.n_heads % tp_size:
        raise ValueError(
            f"n_heads={model_cfg.n_heads} must divide d_model="
            f"{model_cfg.d_model} and be divisible by tp={tp_size}"
        )
    if model_cfg.d_ff % tp_size:
        raise ValueError(
            f"d_ff={model_cfg.d_ff} must be divisible by tp={tp_size}"
        )


def resolve_axis_topos(mesh, mesh_axes, grad_topo) -> dict:
    """Each axis' FlexTree topology for the gradient sync.

    ``mesh``: a :class:`~.mesh.Mesh`, a process group (see
    :func:`.bucketing.comm_axis_sizes`) or a mapping of axis sizes.
    ``grad_topo``: one spec (used on each axis whose size its product
    matches, flat elsewhere) or a dict ``{axis_name: spec}``; ``"psum"``
    selects the dense fold of every rank (None in the result).  An IR
    family raises ``TopologyError``, as the JAX train seam does."""
    from ..schedule.ir import is_ir_family_spec

    sizes = mesh if isinstance(mesh, Mapping) else \
        comm_axis_sizes(mesh, mesh_axes)

    def axis_topo(ax):
        spec = grad_topo.get(ax) if isinstance(grad_topo, dict) else grad_topo
        if spec == "psum":
            return None
        if is_ir_family_spec(spec):
            raise TopologyError(
                f"grad_topo {spec!r} on axis {ax!r}: IR families "
                f"(swing/generalized) are not supported on the train sync "
                f"seam yet — use a widths-vector spec or 'psum'")
        n = int(sizes.get(ax, 1))
        try:
            return Topology.resolve(n, spec)
        except TopologyError:
            return Topology.flat(n)

    return {ax: axis_topo(ax) for ax in mesh_axes}


def sync_grads(grads, pspecs=None, mesh_axes=AXIS_NAMES, topos=None,
               bucket_bytes: int | None = 0, chunks: int = 1, codec="f32",
               step=0, return_residual: bool = False, *, comm=None):
    """The FlexTree gradient sync: each leaf summed over the axes it is
    replicated on (``pspecs``, the spec tree of :func:`param_specs`; None:
    every leaf replicated).

    ``comm``: None (one rank: ``grads`` comes back as it is), a
    :class:`~.mesh.Mesh` (``grads`` is the list of its ranks' trees; returns
    a list) or a process group (``grads`` is this rank's tree).  ``topos``:
    each axis' topology (:func:`resolve_axis_topos`; None: resolved from
    ``FT_TOPO`` or flat).  ``bucket_bytes=0`` syncs leaf by leaf, one
    ``allreduce`` a leaf and axis (the dense fold for the ``"psum"``
    sentinel): the oracle.  Any other value runs the bucketed sync
    (:func:`.bucketing.bucketed_sync_grads`; None sizes the buckets by the
    planner), bitwise equal to it.  ``chunks > 1`` runs tree collectives
    chunk-pipelined (the bits do not change).

    ``codec``: the wire format (``ops/quantize.py``); a lossy one runs the
    scheduled axes on the compressed collectives, ``step`` keying the
    rounding (the sentinel stays exact).  ``return_residual=True`` returns
    ``(synced, residuals)``: each leaf's error-feedback residual, the wire's
    of its first replication axis when that axis is compressed, else the
    canonical ``x - C(x)`` (zeros on one rank)."""
    get_codec(codec)
    if comm is None:
        if return_residual:
            return grads, tree_map(torch.zeros_like, grads)
        return grads
    sizes = comm_axis_sizes(comm, mesh_axes)
    if topos is None:
        topos = resolve_axis_topos(sizes, mesh_axes, None)
    kw = dict(comm=comm, codec=codec, step=step,
              return_residual=return_residual)
    if bucket_bytes != 0:
        return bucketed_sync_grads(grads, pspecs, mesh_axes, topos,
                                   bucket_bytes=bucket_bytes, chunks=chunks,
                                   **kw)
    return per_leaf_sync_grads(grads, pspecs, mesh_axes, topos, chunks, **kw)


def sync_with_feedback(state: dict, grads, pspecs, mesh_axes, topos,
                       train_cfg: TrainConfig, *, comm=None):
    """The train step's gradient sync under ``train_cfg``: the identity
    codec gives the plain (bitwise) sync and None; a lossy one adds each
    rank's carried residual ``state["ef"]`` (one tree: every rank's; on a
    mesh, a list: each rank's own), syncs ``grad + ef`` compressed with
    ``step=state["step"]`` (the counter before the update) and returns the
    new residuals too, in ``grads``' form (a list on a mesh).  On a wide
    mesh ``grads`` are the ranks' slice trees, and one ``ef`` tree is cut
    for every rank (:func:`.spmd.rank_trees`)."""
    codec = get_codec(train_cfg.codec)
    kw = dict(bucket_bytes=train_cfg.bucket_bytes,
              chunks=train_cfg.grad_chunks, comm=comm)
    if not codec.lossy:
        return sync_grads(grads, pspecs, mesh_axes, topos, **kw), None
    ef = state["ef"]
    if isinstance(comm, Mesh):
        v = [tree_map(lambda g, e: g + e.to(g.dtype), g, e)
             for g, e in zip(grads, rank_trees(ef, pspecs, comm))]
    else:
        v = tree_map(lambda g, e: g + e.to(g.dtype), grads, ef)
    return sync_grads(v, pspecs, mesh_axes, topos, codec=codec,
                      step=int(state["step"]), return_residual=True, **kw)


def schedule_lr(train_cfg: TrainConfig, step):
    """Learning rate at (1-based) ``step`` as a 0-d float32 tensor (on
    ``step``'s device when it is a tensor).  "constant": ``lr``.
    "warmup_cosine": linear 0 -> lr over ``warmup_steps``, then cosine
    down to ``min_lr_frac * lr`` at ``total_steps`` (flat beyond)."""
    dev = step.device if isinstance(step, torch.Tensor) else None
    if train_cfg.schedule == "constant":
        return torch.tensor(train_cfg.lr, dtype=torch.float32, device=dev)
    if train_cfg.schedule != "warmup_cosine":
        raise ValueError(f"unknown schedule {train_cfg.schedule!r}")
    if train_cfg.total_steps <= 0:
        raise ValueError("schedule='warmup_cosine' needs total_steps > 0")
    t = torch.as_tensor(step, device=dev).to(torch.float32)
    warm = float(train_cfg.warmup_steps)
    ramp = torch.clamp(t / max(warm, 1.0), max=1.0)
    span = float(max(train_cfg.total_steps - train_cfg.warmup_steps, 1))
    frac = torch.clamp((t - warm) / span, 0.0, 1.0)
    floor = float(train_cfg.min_lr_frac)
    cos = floor + (1.0 - floor) * 0.5 * (1.0 + torch.cos(math.pi * frac))
    one = torch.ones((), dtype=torch.float32, device=dev)
    return train_cfg.lr * ramp * torch.where(t <= warm, one, cos)


def global_grad_norm(grads, pspecs=None, *, comm=None):
    """The L2 norm of the gradient, in float32.

    ``comm`` None: ``grads`` is one tree of whole leaves (one rank, or
    data parallelism, which replicates every leaf), and the norm is the
    sum over its leaves.  ``comm`` a :class:`~.mesh.Mesh`: ``grads`` is
    every rank's synced tree of its slices, and the norm is the JAX
    function's: each rank's leaves grouped by the axes their spec names,
    each group's square-sums added in leaf order, then summed over those
    axes' groups in rank order (:meth:`.spmd.Axis.psum`), the groups'
    totals added.  Every rank gets the same bits; rank 0's is returned."""
    if comm is None:
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in tree_leaves(grads)))
    from .bucketing import spec_axes, spec_leaves

    specs = spec_leaves(grads[0], pspecs)
    by_axes: list[dict] = []
    for tree in grads:
        groups: dict = {}
        for g, spec in zip(tree_leaves(tree), specs):
            key = spec_axes(spec)
            zero = torch.zeros((), dtype=torch.float32, device=g.device)
            groups[key] = groups.get(key, zero) + torch.sum(
                torch.square(g.float()))
        by_axes.append(groups)
    total = [torch.zeros((), dtype=torch.float32,
                         device=tree_leaves(t)[0].device) for t in grads]
    for key in by_axes[0]:
        sq = [groups[key] for groups in by_axes]
        for name in key:
            if name in comm.axis_names:
                sq = axis(comm, name).psum(sq)
        total = [t + s_ for t, s_ in zip(total, sq)]
    return torch.sqrt(total[0])


def clip_by_global_norm(grads, norm, clip: float):
    """Scale the tree so its global norm is at most ``clip`` (> 0)."""
    if clip <= 0:
        raise ValueError(f"clip must be positive, got {clip}")
    scale = torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads)


def maybe_clip_grads(grads, train_cfg: TrainConfig, metrics: dict,
                     pspecs=None, comm=None):
    """When ``grad_clip_norm`` is set (must be positive), clip ``grads``
    to it and record the pre-clip norm in ``metrics['grad_norm']``.  With
    a mesh ``comm``, ``grads`` is every rank's tree of its slices and the
    norm :func:`global_grad_norm`'s over them (``pspecs``)."""
    if not train_cfg.grad_clip_norm:
        return grads
    if train_cfg.grad_clip_norm < 0:
        raise ValueError(
            f"grad_clip_norm must be positive, got {train_cfg.grad_clip_norm}"
        )
    norm = global_grad_norm(grads, pspecs, comm=comm)
    metrics["grad_norm"] = norm
    if comm is not None:
        return [clip_by_global_norm(g, norm, train_cfg.grad_clip_norm)
                for g in grads]
    return clip_by_global_norm(grads, norm, train_cfg.grad_clip_norm)


def adamw_apply(state: dict, grads, train_cfg: TrainConfig) -> dict:
    """One AdamW update; returns a new state (the input is not modified).
    The element math is :func:`.zero._adamw_elem`, which the sharded
    update runs too."""
    step = state["step"] + 1
    c1, c2 = _bias_corrections(train_cfg, step.to(torch.float32))
    lr = schedule_lr(train_cfg, step)
    params = state["params"]
    out = [_adamw_elem(p, g, m, v, c1, c2, train_cfg) for p, g, m, v in
           zip(*(tree_leaves(t) for t in (params, grads, state["mu"],
                                          state["nu"])))]
    return {"params": tree_unflatten(params, [p - lr * d for p, (d, _, _)
                                              in zip(tree_leaves(params),
                                                     out)]),
            "mu": tree_unflatten(params, [m for _, m, _ in out]),
            "nu": tree_unflatten(params, [v for _, _, v in out]),
            "step": step}


def _global_loss(losses: list, comm):
    """The ranks' losses summed in rank order, on every rank (the JAX
    step's ``psum`` of the loss): on a process group the scalars are
    gathered first (through host memory on gloo)."""
    if comm is not None and not isinstance(comm, Mesh):
        import torch.distributed as dist

        mine = losses[0].reshape(1)
        sent = mine.cpu() if dist.get_backend(comm) == "gloo" else mine
        losses = [torch.empty_like(sent)
                  for _ in range(dist.get_world_size(comm))]
        dist.all_gather(losses, sent, group=comm)
        losses = [t.to(mine.device).reshape(()) for t in losses]
    return functools.reduce(operator.add, losses)


def _spmd(comm) -> bool:
    """Whether a step over ``comm`` runs sequence or tensor parallelism:
    a mesh whose sp or tp axis is above size 1."""
    sizes = comm_axis_sizes(comm, AXIS_NAMES)
    return any(sizes[ax] > 1 for ax in AXIS_NAMES[1:])


def _local_ranks(comm, device):
    """``(device, dp, local ranks)`` of a step over ``comm`` (see
    :func:`make_train_step`)."""
    from ..device import resolve_device

    dp = comm_axis_sizes(comm, AXIS_NAMES)[AXIS_NAMES[0]]
    if isinstance(comm, Mesh):
        if len(set(comm.devices)) != 1:
            raise ValueError(f"the ranks of a mesh share one device; got "
                             f"{comm.devices}")
        dev = comm.devices[0]
        if device is not None and resolve_device(device) != dev:
            raise ValueError(f"device={device!r}, but the mesh's ranks are "
                             f"on {dev}")
        return dev, dp, list(range(dp))
    dev = resolve_device(device)
    if comm is None:
        return dev, dp, [0]
    import torch.distributed as dist

    return dev, dp, [dist.get_rank(comm)]


def _rank_batches(tokens, targets, dev, dp: int, local):
    """Each local rank's rows of the global batch (contiguous row blocks
    over dp, as the JAX ``shard_map`` splits it) and the global token
    count."""
    tokens = torch.as_tensor(tokens, device=dev)
    targets = torch.as_tensor(targets, device=dev)
    if tokens.shape[0] % dp:
        raise ValueError(f"a batch of {tokens.shape[0]} rows does not "
                         f"split over dp={dp}")
    rows = tokens.shape[0] // dp
    cuts = [slice(r * rows, (r + 1) * rows) for r in local]
    return ([tokens[c] for c in cuts], [targets[c] for c in cuts],
            tokens.numel())


def _rank_loss_and_grads(model_cfg, params, tokens, targets, n_total):
    """One rank's loss (its summed cross entropy over the global token
    count) and unsynced gradient tree, in one backward."""
    with torch.enable_grad():
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        logits = forward(leaves, tokens.long(), model_cfg)
        loss_sum, _ = cross_entropy_loss(logits, targets)
        loss = loss_sum / n_total
        flat = torch.autograd.grad(loss, tree_leaves(leaves))
    return loss.detach(), tree_unflatten(params, flat)


def psum_all(xs: list, comm: Mesh, axis_names) -> list:
    """Every rank's value summed over each of ``axis_names`` in turn (the
    JAX steps' ``psum`` of the loss over every mesh axis)."""
    for ax in axis_names:
        if ax in comm.axis_names:
            xs = axis(comm, ax).psum(xs)
    return xs


def spmd_grads(state: dict, pspecs, comm: Mesh, axis_names, topos,
               train_cfg: TrainConfig, rank_losses, tail=None):
    """The backward and the sync of every step over a mesh of in-process
    ranks (dense with sp or tp, pipeline, MoE): ``state["params"]`` (the
    full tree) cut into every rank's slices by ``pspecs``, each a leaf of
    its own; ``rank_losses(leaves) -> (losses, extra)`` runs every rank's
    forward in lock-step and gives each rank's loss term (None for a rank
    whose loss is 0, as off a pipeline's last stage); one
    ``torch.autograd.grad`` over their sum gives each rank's copy its
    gradient (zeros for a slice no loss reads); then the sync:
    :func:`sync_with_feedback` over each leaf's replication axes, or
    ``tail(state, grads) -> (synced, ef)`` in its place (the pipeline's
    overlapped tail); under ``shard_optimizer`` none, the update
    reduce-scatters (:func:`spmd_update`).  Returns ``(losses, grads,
    ef, extra)``: every rank's loss term detached (0 for None), every
    rank's synced (or, sharded, unsynced) tree, the ranks' new residuals
    (None for the identity codec or when sharded)."""
    with torch.enable_grad():
        leaves = [tree_map(lambda p: p.detach().requires_grad_(), tr)
                  for tr in shard_tree(state["params"], pspecs, comm)]
        losses, extra = rank_losses(leaves)
        live = [x for x in losses if x is not None]
        flat = torch.autograd.grad(
            live, [x for tr in leaves for x in tree_leaves(tr)],
            grad_outputs=[torch.ones_like(x) for x in live],
            materialize_grads=True)
    n = len(flat) // comm.size
    grads = [tree_unflatten(tr, flat[r * n:(r + 1) * n])
             for r, tr in enumerate(leaves)]
    losses = [torch.zeros((), dtype=torch.float32, device=dev)
              if x is None else x.detach()
              for x, dev in zip(losses, comm.devices)]
    if train_cfg.shard_optimizer:
        return losses, grads, None, extra
    if tail is not None:
        synced, ef = tail(state, grads)
    else:
        synced, ef = sync_with_feedback(state, grads, pspecs, axis_names,
                                        topos, train_cfg, comm=comm)
    return losses, synced, ef, extra


def overlap_stream(train_cfg: TrainConfig, dev):
    """The side stream a step's fired syncs run on: one a step function,
    on a card with ``overlap``, else None."""
    if train_cfg.overlap and dev.type == "cuda":
        return torch.cuda.Stream(device=dev)
    return None


def _spmd_grads(model_cfg: TransformerConfig, train_cfg: TrainConfig,
                comm: Mesh, dev, serialize_overlap: bool = False,
                cache: dict | None = None):
    """``(grads_fn, pspecs, topos)``: ``grads_fn(state, tokens, targets) ->
    (loss, grads, ef)`` of a step over a mesh with sp or tp above 1: the
    global mean token loss, every rank's tree (synced slices; under
    ``shard_optimizer`` unsynced, or with ``overlap`` the fired buckets'
    :class:`~.zero.ZeroShard` trees) and the ranks' new residuals (see the
    module docstring).  ``cache``: the step's (:func:`spmd_step`), which
    keeps the overlap plan and the ZeRO layout."""
    sizes = comm_axis_sizes(comm, AXIS_NAMES)
    dp, sp, tp = (sizes[ax] for ax in AXIS_NAMES)
    validate_tp(model_cfg, tp)
    topos = resolve_axis_topos(sizes, AXIS_NAMES, train_cfg.grad_topo)
    pspecs = param_specs(model_cfg, AXIS_NAMES[-1])
    sp_axis, tp_axis = (axis(comm, ax) if ax in comm.axis_names else None
                        for ax in AXIS_NAMES[1:])
    lossy = get_codec(train_cfg.codec).lossy
    side = overlap_stream(train_cfg, dev)
    plans = {} if cache is None else cache

    def grads_fn(state, tokens, targets):
        if lossy and "ef" not in state:
            raise ValueError(f"codec {train_cfg.codec!r}: the sync needs the "
                             f"train state (its step and ef)")
        tokens = torch.as_tensor(tokens, device=dev)
        targets = torch.as_tensor(targets, device=dev)
        b, t = tokens.shape
        if b % dp or t % sp:
            raise ValueError(f"a batch of {tuple(tokens.shape)} does not "
                             f"split over dp={dp} rows and sp={sp} columns")
        toks, tgts = (shard_batch(x, AXIS_NAMES[:2], comm)
                      for x in (tokens, targets))
        # the JAX normalisation counts the tp-fold redundancy: every tp
        # rank computes its group's whole loss
        n_total = tokens.numel() * tp
        if train_cfg.overlap:
            from .overlap import dense_overlap_step_grads

            plan, layout = mesh_overlap_plan(
                plans, state["params"], pspecs, comm, AXIS_NAMES, topos,
                train_cfg, model_cfg, toks[0], dev)
            losses, grads, ef = dense_overlap_step_grads(
                state, [x.long() for x in toks], tgts, model_cfg, train_cfg,
                plan, pspecs, AXIS_NAMES, topos, n_total, tp_axis=tp_axis,
                sp_axis=sp_axis, serialize=serialize_overlap,
                zero_layout=layout, comm=comm, stream=side)
        else:
            def rank_losses(leaves):
                logits = forward(leaves, [x.long() for x in toks], model_cfg,
                                 tp_axis=tp_axis, sp_axis=sp_axis)
                return [cross_entropy_loss(lg, y)[0] / n_total
                        for lg, y in zip(logits, tgts)], None

            losses, grads, ef, _ = spmd_grads(state, pspecs, comm,
                                              AXIS_NAMES, topos, train_cfg,
                                              rank_losses)
        # the JAX step's psum over dp, sp, tp
        return psum_all(losses, comm, AXIS_NAMES)[0], grads, ef

    return grads_fn, pspecs, topos


def step_layout(cache: dict, train_cfg: TrainConfig, comm, params, pspecs,
                axis_names):
    """A step's ZeRO layout (None without ``shard_optimizer``), built from
    its first call's params and kept in the step's ``cache``, which
    :func:`mesh_overlap_plan` shares."""
    if not train_cfg.shard_optimizer:
        return None
    if "layout" not in cache:
        cache["layout"] = zero_layout_for(comm, params, pspecs, axis_names)
    return cache["layout"]


def mesh_overlap_plan(cache: dict, params, pspecs, comm, axis_names, topos,
                      train_cfg: TrainConfig, model_cfg, tokens, dev):
    """``(plan, zero layout or None)`` of an overlapped step over a mesh,
    planned once a rank's batch shape, as the JAX step plans inside
    ``shard_map``: on one rank's slices and tokens
    (:func:`.overlap.plan_overlap`); the layout is :func:`step_layout`'s
    from the same ``cache``."""
    from .overlap import plan_overlap

    if tokens.shape not in cache:
        slices = shard_tree(params, pspecs, comm)[0]
        lossy = get_codec(train_cfg.codec).lossy
        cache[tokens.shape] = plan_overlap(
            slices, pspecs, axis_names, topos,
            comm_axis_sizes(comm, axis_names), n_tokens=tokens.numel(),
            t_local=tokens.shape[1], d_model=model_cfg.d_model,
            codec=train_cfg.codec if lossy else None, device=dev)
    return cache[tokens.shape], step_layout(cache, train_cfg, comm, params,
                                            pspecs, axis_names)


def spmd_step(grads_fn, cache: dict, pspecs, comm: Mesh, axis_names, topos,
              train_cfg: TrainConfig, fired: bool, metrics_of=None):
    """The train step of every family over a mesh: ``grads_fn(state,
    tokens, targets) -> (out, grads, ef)`` (the family's backward and
    sync; ``metrics_of(out)`` its metrics, default ``{"loss": out}``),
    then :func:`spmd_update` with :func:`step_layout`'s layout from
    ``cache`` (the one ``grads_fn``'s overlap plan shares); ``fired``: the
    overlap engine reduce-scattered each bucket."""
    def step(state, tokens, targets):
        layout = step_layout(cache, train_cfg, comm, state["params"], pspecs,
                             axis_names)
        out, grads, ef = grads_fn(state, tokens, targets)
        metrics = metrics_of(out) if metrics_of else {"loss": out}
        return spmd_update(state, grads, ef, pspecs, comm, axis_names, topos,
                           train_cfg, metrics, layout, fired=fired), metrics

    return step


def step_sync_fold_launches(model_cfg, train_cfg: TrainConfig, params,
                            pspecs, comm: Mesh, axis_names, batch_shape,
                            pipeline: bool = False) -> int:
    """The fold kernel's launches of one step's gradient sync over the
    in-process mesh ``comm``, from the code: :func:`.bucketing.
    mesh_fold_launches` on one rank's slices of each payload the step
    syncs.  That is the whole tree (the replicated or lossy sync, ZeRO-1's
    reduce-scatter), or under ``overlap`` each fired bucket's: the
    readiness plan's (:func:`mesh_overlap_plan` on one rank's block of the
    global ``batch_shape``; the rows over every axis but the last two,
    the columns over the second last), or the pipeline's three tail
    buckets (:data:`.overlap.PIPELINE_TAIL`; under ZeRO-1 the pipeline
    step runs without overlap, as the JAX step does).  The bf16 codec
    folds as the lossless sync."""
    from .bucketing import mesh_fold_launches, spec_leaves
    from .overlap import PIPELINE_TAIL, fired_payloads

    sizes = comm_axis_sizes(comm, axis_names)
    topos = resolve_axis_topos(sizes, axis_names, train_cfg.grad_topo)
    slices = shard_tree(params, pspecs, comm)[0]
    codec = "int8" if train_cfg.codec == "int8" else None
    if not train_cfg.overlap or (pipeline and train_cfg.shard_optimizer):
        payloads = [(slices, pspecs)]
    elif pipeline:
        payloads = [({k: slices[k]}, {k: pspecs[k]}) for k in PIPELINE_TAIL]
    else:
        rows = batch_shape[0] // math.prod(sizes[a] for a in axis_names[:-2])
        local = torch.zeros((rows, batch_shape[1] // sizes[axis_names[-2]]),
                            dtype=torch.long, device=comm.devices[0])
        plan, _ = mesh_overlap_plan({}, params, pspecs, comm, axis_names,
                                    topos, train_cfg, model_cfg, local,
                                    comm.devices[0])
        payloads = list(zip(fired_payloads(plan, slices),
                            fired_payloads(plan, pspecs)))
    return sum(mesh_fold_launches(
        tree_leaves(tree), spec_leaves(tree, sp), axis_names, sizes, topos,
        codec=codec, sharded=train_cfg.shard_optimizer)
        for tree, sp in payloads)


def make_loss_and_grads(model_cfg: TransformerConfig,
                        train_cfg: TrainConfig = TrainConfig(), device=None,
                        comm=None, serialize_overlap: bool = False):
    """``(params, tokens, targets, state=None) -> (loss, grads, ef)``: the
    global mean token loss, the synced gradient tree and the ranks' new
    residuals (None for the identity codec), the first half of
    :func:`make_train_step` (see it for ``comm`` and
    ``serialize_overlap``).  Each rank's loss divides its summed cross
    entropy by the global token count, so the synced gradient is the
    gradient of the global mean.  A lossy codec needs the train ``state``:
    its ``"step"`` keys the rounding and its ``"ef"`` is added before the
    sync.

    Under ``shard_optimizer`` the sync is :mod:`.zero`'s, so ``grads`` is
    each rank's unsynced gradient in ``comm``'s form (the list of the
    ranks' trees on a mesh) and ``ef`` None; with ``overlap`` it is the
    fired buckets' reduce-scatter, a :class:`~.zero.ZeroShard` a leaf, with
    the ranks' new residuals."""
    _refuse_unported(train_cfg)
    if model_cfg.d_model % model_cfg.n_heads:
        raise ValueError(f"n_heads={model_cfg.n_heads} must divide "
                         f"d_model={model_cfg.d_model}")
    dev, dp, local = _local_ranks(comm, device)
    if _spmd(comm):
        grads_fn, pspecs, _ = _spmd_grads(model_cfg, train_cfg, comm, dev,
                                          serialize_overlap)

        def sharded_loss_and_grads(params, tokens, targets, state=None):
            loss, grads, ef = grads_fn(dict(state or {}, params=params),
                                       tokens, targets)
            if train_cfg.shard_optimizer:  # every rank's own tree
                return loss, grads, ef
            return loss, gather_tree(grads, pspecs, comm), ef

        return sharded_loss_and_grads
    topos = resolve_axis_topos(comm_axis_sizes(comm, AXIS_NAMES),
                               AXIS_NAMES, train_cfg.grad_topo)
    pspecs = param_specs(model_cfg, AXIS_NAMES[-1])
    lossy = get_codec(train_cfg.codec).lossy
    mesh = isinstance(comm, Mesh)
    sharded = train_cfg.shard_optimizer
    layouts: list = []  # the ZeRO layout, from the first call's params
    # the side stream this step's fired syncs run on, on a card
    side = overlap_stream(train_cfg, dev)
    plans: dict = {}  # the overlap plan by one rank's batch shape

    def overlap_plan(params, tokens):
        from .overlap import plan_overlap

        if tokens.shape not in plans:
            plans[tokens.shape] = plan_overlap(
                params, pspecs, AXIS_NAMES, topos,
                comm_axis_sizes(comm, AXIS_NAMES), n_tokens=tokens.numel(),
                t_local=tokens.shape[1], d_model=model_cfg.d_model,
                codec=train_cfg.codec if lossy else None, device=dev)
        return plans[tokens.shape]

    def overlapped(params, toks, tgts, n_total, state):
        from .overlap import dense_overlap_step_grads

        state = dict(state or {}, params=params)
        if sharded and not layouts:
            layouts.append(zero_layout_for(comm, params, pspecs))
        losses, synced, ef = dense_overlap_step_grads(
            state, toks, tgts, model_cfg, train_cfg,
            overlap_plan(params, toks[0]), pspecs, AXIS_NAMES, topos,
            n_total, serialize=serialize_overlap,
            zero_layout=layouts[0] if sharded else None, comm=comm,
            stream=side)
        # every rank's synced tree is bitwise the first's; shards are not
        return (losses, synced if sharded and mesh else synced[0],
                ef if mesh or ef is None else ef[0])

    def serialized(params, toks, tgts, n_total, state):
        losses, grads = [], []
        for t, y in zip(toks, tgts):
            loss, g = _rank_loss_and_grads(model_cfg, params, t, y, n_total)
            losses.append(loss)
            grads.append(g)
        if sharded:  # the step's zero_sync_and_update syncs them
            return losses, grads if mesh else grads[0], None
        synced, ef = sync_with_feedback(state, grads if mesh else grads[0],
                                        pspecs, AXIS_NAMES, topos, train_cfg,
                                        comm=comm)
        return losses, synced[0] if mesh else synced, ef

    run = overlapped if train_cfg.overlap else serialized

    def loss_and_grads(params, tokens, targets, state=None):
        if lossy and state is None:
            raise ValueError(f"codec {train_cfg.codec!r}: the sync needs the "
                             f"train state (its step and ef)")
        toks, tgts, n_total = _rank_batches(tokens, targets, dev, dp, local)
        losses, synced, ef = run(params, toks, tgts, n_total, state)
        return _global_loss(losses, comm), synced, ef

    return loss_and_grads


def make_train_step(model_cfg: TransformerConfig,
                    train_cfg: TrainConfig = TrainConfig(), device=None,
                    comm=None, serialize_overlap: bool = False):
    """The train step ``(state, tokens, targets) -> (state, metrics)``.

    ``comm``: None (one rank on ``device``, default ``cuda``), a
    :class:`~.mesh.Mesh` whose ``"dp"`` axis spans its ranks, all on one
    device (the step runs every rank, and ``device``, if given, must be
    theirs), or a ``torch.distributed`` process group (this
    process is one rank on ``device``; each rank passes the same global
    batch).  ``tokens``/``targets``: the global (B, T) batch, B a multiple
    of dp, as integer arrays or tensors.  ``metrics``: ``{"loss"}`` the
    global mean token loss, plus ``{"grad_norm"}`` (pre-clip) when
    clipping is on, as 0-d float32 tensors on the device.  The step reads
    ``state`` and returns a new one; under a lossy codec it carries the
    ranks' new residuals in ``"ef"``.

    With ``train_cfg.overlap`` the gradient comes from
    :func:`.overlap.dense_overlap_step_grads`: each bucket synced as its
    backward segments finish; ``serialize_overlap=True`` builds its
    serialized twin (the whole backward, then the same buckets in the same
    order), the A/B comparator.  Both give the same bits, and for the
    identity codec the bits of the step without ``overlap``.

    With ``train_cfg.shard_optimizer`` the state is the sharded one
    (:func:`init_train_state` with the same ``comm``) and the update is
    ZeRO-1's (:mod:`.zero`): without ``overlap``
    :func:`.zero.zero_sync_and_update`; with it the fired buckets'
    reduce-scatter, then :func:`.zero.maybe_clip_shards` and
    :func:`.zero.zero_apply_and_gather` after the backward, on the current
    stream."""
    if _spmd(comm):
        return _spmd_step(model_cfg, train_cfg, device, comm,
                          serialize_overlap)
    loss_and_grads = make_loss_and_grads(model_cfg, train_cfg, device, comm,
                                         serialize_overlap)
    if train_cfg.shard_optimizer:
        return _zero_step(model_cfg, train_cfg, comm, loss_and_grads)

    def step(state, tokens, targets):
        loss, grads, ef = loss_and_grads(state["params"], tokens, targets,
                                         state)
        metrics = {"loss": loss}
        grads = maybe_clip_grads(grads, train_cfg, metrics)
        new = adamw_apply(state, grads, train_cfg)
        if ef is not None:
            new["ef"] = ef
        return new, metrics

    return step


def _spmd_step(model_cfg, train_cfg, device, comm, serialize_overlap):
    """:func:`make_train_step`'s step over a mesh with sp or tp above 1:
    the backward and sync of :func:`_spmd_grads`, then
    :func:`spmd_update`."""
    _refuse_unported(train_cfg)
    dev, _, _ = _local_ranks(comm, device)
    cache: dict = {}
    grads_fn, pspecs, topos = _spmd_grads(model_cfg, train_cfg, comm, dev,
                                          serialize_overlap, cache)
    return spmd_step(grads_fn, cache, pspecs, comm, AXIS_NAMES, topos,
                     train_cfg, fired=train_cfg.overlap)


def spmd_update(state: dict, grads: list, ef, pspecs, comm: Mesh,
                axis_names, topos, train_cfg: TrainConfig, metrics: dict,
                layout=None, fired: bool = False) -> dict:
    """The tail of every step over a mesh, ``grads`` every rank's tree.
    Replicated: the synced slices clipped by their global norm (recorded
    in ``metrics``), put back into the full tree
    (:func:`.spmd.gather_tree`), and AdamW on it, as on one rank.  Under
    ``shard_optimizer`` (``layout`` the step's
    :class:`~.zero.ZeroLayout`): :func:`.zero.zero_sync_and_update` on the
    unsynced trees, or, ``fired`` (the overlap engine reduce-scattered each
    bucket: :class:`~.zero.ZeroShard` trees), clipping from the shards and
    :func:`.zero.zero_apply_and_gather`.  ``ef``, the ranks' new
    residuals, goes into the new state."""
    if train_cfg.shard_optimizer:
        if not fired:
            return zero_sync_and_update(state, grads, pspecs, axis_names,
                                        topos, train_cfg, layout, metrics,
                                        comm=comm)
        shards = maybe_clip_shards(grads, pspecs, train_cfg, layout, metrics,
                                   comm=comm)
        new = zero_apply_and_gather(state, shards, pspecs, axis_names, topos,
                                    train_cfg, layout, comm=comm)
    else:
        shards = maybe_clip_grads(grads, train_cfg, metrics, pspecs, comm)
        new = adamw_apply(state, gather_tree(shards, pspecs, comm),
                          train_cfg)
    if ef is not None:
        new["ef"] = ef
    return new


def _zero_step(model_cfg, train_cfg, comm, loss_and_grads):
    """:func:`make_train_step`'s sharded (ZeRO-1) step."""
    pspecs = param_specs(model_cfg, AXIS_NAMES[-1])
    topos = resolve_axis_topos(comm_axis_sizes(comm, AXIS_NAMES),
                               AXIS_NAMES, train_cfg.grad_topo)
    layouts: list = []

    def step(state, tokens, targets):
        if not layouts:
            layouts.append(zero_layout_for(comm, state["params"], pspecs))
        layout = layouts[0]
        loss, grads, ef = loss_and_grads(state["params"], tokens, targets,
                                         state)
        metrics = {"loss": loss}
        if not train_cfg.overlap:
            return zero_sync_and_update(state, grads, pspecs, AXIS_NAMES,
                                        topos, train_cfg, layout, metrics,
                                        comm=comm), metrics
        # the engine reduce-scattered each fired bucket: ZeroShard trees
        shards = maybe_clip_shards(grads, pspecs, train_cfg, layout, metrics,
                                   comm=comm)
        new = zero_apply_and_gather(state, shards, pspecs, AXIS_NAMES, topos,
                                    train_cfg, layout, comm=comm)
        if ef is not None:
            new["ef"] = ef
        return new, metrics

    return step
