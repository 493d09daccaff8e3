"""Pipeline parallelism: stage-sharded layers and the GPipe schedule.

PyTorch counterpart of ``flextree_tpu/parallel/pipeline.py``.  The layer
stack splits into ``pp`` contiguous stages: each layer's parameters are
stacked on a leading layer axis (:func:`stack_layer_params`) that is
sharded over ``pp``, so a rank holds its stage's ``n_layers / pp``
layers, and activations move one stage right by
:meth:`.spmd.Axis.ppermute` over ``pp``.

Schedule: GPipe.  Each rank's batch splits into ``M`` microbatches and the
loop runs ``M + pp - 1`` ticks.  At each tick stage 0's ranks take the
embedding of microbatch ``clip(t)`` and every other rank the state it was
sent; every rank applies its stage's layers (the dense model's blocks,
with the sequence-parallel attention over ``sp`` and the tensor-parallel
combine over ``tp``, every rank of the mesh in lock-step); the outputs
move one hop right.  A bubble (a stage before its first microbatch or
after its last) computes what the JAX schedule computes, output that no
loss reads, so its cotangent is zero and autograd never runs its
backward.  The head and the loss are per rank and cross no collective, so
they run only where they count, on the last stage's ranks at the ticks
that finish a microbatch (a host branch): the loss and gradient of JAX's
``where`` mask, without the head on every rank at every tick.

The gradient sync composes as in :mod:`.train`: the stacked layers are
sharded over ``pp`` (no sync there) and the embedding and final norm are
replicated over it, so they are summed over ``pp`` too, with the other
replication axes.  The options compose as in the JAX step: a lossy codec
syncs each rank's ``grad + ef`` (:func:`.train.sync_with_feedback`);
``shard_optimizer`` shards each leaf's moments over its first
replication axis above size 1 (pp for the embedding and the final norm,
sp for the stacked layers on a ``(1, 2, 2, 2)`` mesh) and ignores
``overlap``, as the JAX step does (the scan's backward yields every
gradient at once, so the sharded sync's buckets are already free to run
after it); ``overlap`` alone fires three buckets after the backward
(:func:`.overlap.overlap_sync_with_feedback`).

Not ported yet (ROADMAP.md, Queue 1: 'Sequence, pipeline and expert
parallelism'): the step over a ``torch.distributed`` group.
"""

from __future__ import annotations

from ..models.transformer import (
    TransformerConfig,
    cross_entropy_loss,
    final_logits,
    global_positions,
    init_params,
    layer_forward,
    param_specs,
)
from .bucketing import WIDE_AXES_ITEM, comm_axis_sizes
from .mesh import Mesh
from .spmd import axis, gather_tree, shard_batch
from .train import (
    TrainConfig,
    _refuse_unported,
    make_mesh_nd,
    make_train_state,
    overlap_stream,
    psum_all,
    resolve_axis_topos,
    spmd_grads,
    spmd_step,
    spread_factors,
    validate_tp,
    zero_layout_for,
)

__all__ = [
    "PIPELINE_AXES",
    "stack_layer_params",
    "unstack_layer_params",
    "pipeline_param_specs",
    "pipeline_state_specs",
    "init_pipeline_train_state",
    "make_pipeline_train_step",
    "make_pipeline_loss_and_grads",
    "pipeline_losses",
    "make_mesh_4d",
    "factor_devices_4d",
    "step_mesh",
]

#: the pipeline step's mesh axes: data, pipeline, sequence, tensor
PIPELINE_AXES = ("dp", "pp", "sp", "tp")


# ------------------------------------------------------------ param layout


def stack_layer_params(params: dict) -> dict:
    """A list of layer dicts -> one dict of ``(L, ...)`` stacked leaves,
    the leading axis the pipeline's shard axis."""
    import torch

    layers = params["layers"]
    return {"embed": params["embed"], "ln_f": params["ln_f"],
            "layers": {k: torch.stack([layer[k] for layer in layers])
                       for k in layers[0]}}


def unstack_layer_params(params: dict) -> dict:
    """The inverse of :func:`stack_layer_params`."""
    stacked = params["layers"]
    n_layers = next(iter(stacked.values())).shape[0]
    return {"embed": params["embed"], "ln_f": params["ln_f"],
            "layers": [{k: v[i] for k, v in stacked.items()}
                       for i in range(n_layers)]}


def pipeline_param_specs(cfg: TransformerConfig, pp_axis: str | None = "pp",
                         tp_axis: str | None = "tp") -> dict:
    """The stacked layout's specs: the leading layer axis over
    ``pp_axis``, each layer's dimensions tp-sharded as in
    :func:`..models.transformer.param_specs`."""
    per_layer = param_specs(cfg, tp_axis)["layers"][0]
    return {"embed": (None, None), "ln_f": (None,),
            "layers": {k: (pp_axis, *spec) for k, spec in per_layer.items()}}


def pipeline_state_specs(cfg: TransformerConfig, pp_axis: str | None = "pp",
                         tp_axis: str | None = "tp") -> dict:
    """The train state's specs: the moments shard as the parameters, the
    step is replicated."""
    pspecs = pipeline_param_specs(cfg, pp_axis, tp_axis)
    return {"params": pspecs, "mu": pspecs, "nu": pspecs, "step": ()}


def init_pipeline_train_state(cfg: TransformerConfig, generator,
                              train_cfg: TrainConfig | None = None,
                              device=None, comm=None,
                              axis_names=PIPELINE_AXES) -> dict:
    """A fresh AdamW state around ``init_params(cfg, generator, device)``
    in the stacked layout (the JAX ``init_pipeline_train_state``); under
    ``shard_optimizer`` its moments are sharded over ``comm``, the step's
    mesh (the JAX ``mesh=``; None: one rank, every leaf ``*_rep``)."""
    params = stack_layer_params(init_params(cfg, generator, device=device))
    layout = None
    if train_cfg is not None and train_cfg.shard_optimizer:
        layout = zero_layout_for(comm, params, pipeline_param_specs(
            cfg, axis_names[1], axis_names[3]), axis_names)
    return make_train_state(params, train_cfg, layout=layout)


# ------------------------------------------------------------- mesh helper


def factor_devices_4d(n: int) -> tuple[int, int, int, int]:
    """Split ``n`` devices into (dp, pp, sp, tp), the JAX
    ``factor_devices_4d``: the largest prime factors to pp, then sp, then
    tp, then dp (8 -> (1, 2, 2, 2), 16 -> (2, 2, 2, 2))."""
    return spread_factors(n, 4, order=[1, 2, 3, 0])


def make_mesh_4d(n_devices: int | None = None, shape=None,
                 axis_names=PIPELINE_AXES, device=None) -> Mesh:
    """A 4-axis mesh of in-process ranks on ``device``: ``shape``, or
    ``factor_devices_4d(n_devices)`` (one rank when neither is given)."""
    if shape is None:
        shape = factor_devices_4d(n_devices or 1)
    return make_mesh_nd(n_devices, shape, axis_names, device)


def step_mesh(comm, device, axis_names) -> Mesh:
    """The mesh a 4-axis step runs over: ``comm`` (a :class:`~.mesh.Mesh`
    naming every axis, its ranks on one device), or with None one rank on
    ``device``."""
    from ..device import resolve_device

    if comm is None:
        return make_mesh_nd(1, (1,) * len(axis_names), axis_names, device)
    if not isinstance(comm, Mesh):
        raise NotImplementedError(
            f"a pipeline or MoE step over a torch.distributed group is not "
            f"ported yet ({WIDE_AXES_ITEM})")
    for a in axis_names:
        if a not in comm.axis_names:
            raise ValueError(f"mesh is missing axis {a!r}; has "
                             f"{comm.axis_names}")
    if len(set(comm.devices)) != 1:
        raise ValueError(f"the ranks of a mesh share one device; got "
                         f"{comm.devices}")
    if device is not None and resolve_device(device) != comm.devices[0]:
        raise ValueError(f"device={device!r}, but the mesh's ranks are on "
                         f"{comm.devices[0]}")
    return comm


# ---------------------------------------------------------------- schedule


def pipeline_losses(leaves, toks, tgts, cfg: TransformerConfig, pp_axis,
                    sp_axis, tp_axis, n_total: int) -> list:
    """Every rank's loss term of one GPipe pass: its summed token loss
    over the microbatches its stage finishes, over ``n_total``, on the
    last stage's ranks; None elsewhere.  ``leaves``: every rank's slices
    of the stacked tree; ``toks``/``tgts``: every rank's ``(M, mb,
    T_local)`` microbatches."""
    n, idx = pp_axis.size, pp_axis.index
    m_count = toks[0].shape[0]
    t_local = toks[0].shape[2]
    positions = global_positions(t_local, sp_axis)
    per_stage = next(iter(leaves[0]["layers"].values())).shape[0]
    stages = [[{k: v[j] for k, v in p["layers"].items()}
               for p in leaves] for j in range(per_stage)]
    right = [(j, (j + 1) % n) for j in range(n)]
    losses = [None] * len(leaves)
    # the carry before the first hop: zeros, as the JAX scan starts it
    state = [p["embed"].new_zeros((*tk.shape[1:], cfg.d_model),
                                  dtype=cfg.dtype)
             for p, tk in zip(leaves, toks)]
    for t in range(m_count + n - 1):
        mb = min(t, m_count - 1)
        x = [p["embed"][tk[mb]].to(cfg.dtype) if i == 0 else state[r]
             for r, (p, tk, i) in enumerate(zip(leaves, toks, idx))]
        for layer in stages:
            x = layer_forward(layer, x, positions, cfg, tp_axis=tp_axis,
                              sp_axis=sp_axis)
        mb_i = t - (n - 1)
        if mb_i >= 0:  # the last stage finishes microbatch mb_i
            for r, (p, i) in enumerate(zip(leaves, idx)):
                if i == n - 1:
                    logits = final_logits(p["embed"], p["ln_f"], x[r])
                    term = cross_entropy_loss(logits, tgts[r][mb_i])[0]
                    losses[r] = term if losses[r] is None else \
                        losses[r] + term
        state = pp_axis.ppermute(x, right) if t < m_count + n - 2 else None
    return [None if x is None else x / n_total for x in losses]


def _pipeline_grads(model_cfg, train_cfg, n_microbatches, device, comm,
                    axis_names, serialize_overlap=False):
    """``(grads_fn, pspecs, mesh, topos)``: ``grads_fn(state, tokens,
    targets) -> (loss, grads, ef)``, the global mean token loss, every
    rank's synced slices of the stacked tree (under ``shard_optimizer``
    unsynced) and the ranks' new residuals (see
    :func:`make_pipeline_train_step`)."""
    import torch

    _refuse_unported(train_cfg)
    comm = step_mesh(comm, device, axis_names)
    dp, pp, sp, tp = axis_names
    sizes = comm_axis_sizes(comm, axis_names)
    if model_cfg.n_layers % sizes[pp]:
        raise ValueError(f"n_layers={model_cfg.n_layers} must be divisible "
                         f"by pp={sizes[pp]}")
    validate_tp(model_cfg, sizes[tp])
    if n_microbatches < 1:
        raise ValueError(f"n_microbatches={n_microbatches} must be >= 1")
    pspecs = pipeline_param_specs(model_cfg, pp, tp)
    topos = resolve_axis_topos(sizes, axis_names, train_cfg.grad_topo)
    pp_axis, sp_axis, tp_axis = (axis(comm, a) for a in (pp, sp, tp))
    dev = comm.devices[0]
    tail = None
    if train_cfg.overlap and not train_cfg.shard_optimizer:
        from .overlap import overlap_sync_with_feedback

        side = overlap_stream(train_cfg, dev)

        def tail(state, grads):
            return overlap_sync_with_feedback(
                state, grads, pspecs, axis_names, topos, train_cfg,
                serialize=serialize_overlap, comm=comm, stream=side)

    def grads_fn(state, tokens, targets):
        tokens = torch.as_tensor(tokens, device=dev)
        targets = torch.as_tensor(targets, device=dev)
        b, t = tokens.shape
        if b % sizes[dp] or t % sizes[sp]:
            raise ValueError(f"a batch of {tuple(tokens.shape)} does not "
                             f"split over dp={sizes[dp]} rows and "
                             f"sp={sizes[sp]} columns")
        b_local, t_local = b // sizes[dp], t // sizes[sp]
        if b_local % n_microbatches:
            raise ValueError(f"local batch {b_local} not divisible by "
                             f"n_microbatches={n_microbatches}")
        mb = b_local // n_microbatches
        toks, tgts = ([x.reshape(n_microbatches, mb, t_local).long()
                       for x in shard_batch(y, (dp, sp), comm)]
                      for y in (tokens, targets))
        # the loss exists once a (dp, sp, tp) replica set, on the last
        # stage: normalise by the global token count and the tp-fold
        # redundancy, as the dense step does
        n_total = tokens.numel() * sizes[tp]

        def rank_losses(leaves):
            return pipeline_losses(leaves, toks, tgts, model_cfg, pp_axis,
                                   sp_axis, tp_axis, n_total), None

        losses, grads, ef, _ = spmd_grads(state, pspecs, comm, axis_names,
                                          topos, train_cfg, rank_losses,
                                          tail)
        return psum_all(losses, comm, axis_names)[0], grads, ef

    return grads_fn, pspecs, comm, topos


def make_pipeline_loss_and_grads(model_cfg: TransformerConfig,
                                 train_cfg: TrainConfig = TrainConfig(),
                                 n_microbatches: int = 2, device=None,
                                 comm=None, axis_names=PIPELINE_AXES):
    """``(params, tokens, targets, state=None) -> (loss, grads)``: the
    global mean token loss and the synced gradient of the full stacked
    tree, the first half of :func:`make_pipeline_train_step` (same
    arguments); under ``shard_optimizer`` every rank's unsynced tree.  A
    lossy codec needs the train ``state`` (its ``step`` and ``ef``)."""
    grads_fn, pspecs, comm, _ = _pipeline_grads(
        model_cfg, train_cfg, n_microbatches, device, comm, axis_names)

    def loss_and_grads(params, tokens, targets, state=None):
        loss, grads, _ = grads_fn(dict(state or {}, params=params), tokens,
                                  targets)
        if train_cfg.shard_optimizer:
            return loss, grads
        return loss, gather_tree(grads, pspecs, comm)

    return loss_and_grads


def make_pipeline_train_step(model_cfg: TransformerConfig,
                             train_cfg: TrainConfig = TrainConfig(),
                             n_microbatches: int = 2, device=None,
                             comm=None, axis_names=PIPELINE_AXES,
                             serialize_overlap: bool = False):
    """The GPipe train step ``(state, tokens, targets) -> (state,
    metrics)`` over ``comm``, a :class:`~.mesh.Mesh` with the axes
    ``axis_names`` (dp, pp, sp, tp), every rank in this process on one
    device (None: one rank on ``device``, default ``cuda``).

    ``state`` is the stacked layout (:func:`init_pipeline_train_state`,
    with the same ``comm`` under ``shard_optimizer``);
    ``tokens``/``targets`` the global (B, T) batch, rows over dp and
    columns over sp; each rank's rows must split into ``n_microbatches``.
    ``metrics``: ``{"loss"}`` the global mean token loss and, with
    clipping, ``{"grad_norm"}``.  Each rank's loss divides by the global
    token count times tp, as the JAX step does; the synced slices are
    clipped by their global norm and AdamW updates the full stacked tree
    (:func:`.train.spmd_update`, ZeRO-1's under ``shard_optimizer``).
    ``serialize_overlap``: the overlapped tail's twin, its three buckets
    on the current stream."""
    grads_fn, pspecs, comm, topos = _pipeline_grads(
        model_cfg, train_cfg, n_microbatches, device, comm, axis_names,
        serialize_overlap)
    # the tail syncs whole trees: never the engine's fired shards
    return spmd_step(grads_fn, {}, pspecs, comm, axis_names, topos,
                     train_cfg, fired=False)
