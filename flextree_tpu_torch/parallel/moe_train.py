"""The MoE train step: dp x ep x sp x tp over a mesh of in-process ranks.

PyTorch counterpart of ``flextree_tpu/parallel/moe_train.py``:

- ``ep`` is a data axis outside the MoE layers (the batch rows split over
  dp and ep jointly, ``P((dp, ep), sp)``) and the expert axis inside them
  (tokens go to their experts' owners by all-to-all).
- The expert weights shard over ep (their expert axis) and tp (their
  hidden dimension), so by the replication rule of :mod:`.train` they
  sync over dp and sp only.
- Each rank's loss adds the router load-balance term: ``ce +
  router_aux_weight aux / n_devices``, the aux a per-rank mean and
  ``n_devices`` the product of the four axes.

Every rank's forward runs in lock-step (:func:`..models.moe.moe_forward`
with the axes), one ``torch.autograd.grad`` covers every rank's loss, and
clipping and AdamW follow as in the dense step over a mesh
(:func:`.train.spmd_update`).  The options compose as in the JAX step: a
lossy codec syncs each rank's ``grad + ef``; ``shard_optimizer`` shards
each leaf's moments over its first replication axis above size 1 (ep for
the dense leaves, sp for the expert weights on a ``(1, 2, 2, 2)`` mesh);
``overlap`` runs :func:`.overlap.moe_overlap_step_grads`, each layer's
segment carrying the router's balance term.

Not ported yet (ROADMAP.md, Queue 1: 'Sequence, pipeline and expert
parallelism'): the step over a ``torch.distributed`` group.
"""

from __future__ import annotations

import math

import torch

from ..models.moe import MoEConfig, init_moe_params, moe_forward, \
    moe_param_specs
from ..models.transformer import cross_entropy_loss
from ..ops.quantize import get_codec
from .bucketing import comm_axis_sizes
from .pipeline import factor_devices_4d, make_mesh_4d, step_mesh
from .spmd import axis, gather_tree, shard_batch
from .train import (
    TrainConfig,
    make_train_state,
    maybe_autotune_grad_topo,
    mesh_overlap_plan,
    overlap_stream,
    psum_all,
    resolve_axis_topos,
    spmd_grads,
    spmd_step,
    validate_tp,
    zero_layout_for,
)

__all__ = [
    "MOE_AXES",
    "init_moe_train_state",
    "moe_state_specs",
    "make_moe_train_step",
    "make_moe_loss_and_grads",
    "make_mesh_moe",
    "factor_devices_moe",
]

#: the MoE step's mesh axes: data, expert, sequence, tensor
MOE_AXES = ("dp", "ep", "sp", "tp")


def init_moe_train_state(cfg: MoEConfig, generator,
                         train_cfg: TrainConfig | None = None,
                         device=None, comm=None,
                         axis_names=MOE_AXES) -> dict:
    """A fresh AdamW state around ``init_moe_params(cfg, generator,
    device)`` (the JAX ``init_moe_train_state``); under
    ``shard_optimizer`` its moments are sharded over ``comm``, the step's
    mesh (the JAX ``mesh=``; None: one rank, every leaf ``*_rep``)."""
    params = init_moe_params(cfg, generator, device=device)
    layout = None
    if train_cfg is not None and train_cfg.shard_optimizer:
        layout = zero_layout_for(comm, params, moe_param_specs(
            cfg, axis_names[3], axis_names[1]), axis_names)
    return make_train_state(params, train_cfg, layout=layout)


def moe_state_specs(cfg: MoEConfig, tp_axis: str | None = "tp",
                    ep_axis: str | None = "ep") -> dict:
    """The train state's specs: the moments shard as the parameters, the
    step is replicated."""
    pspecs = moe_param_specs(cfg, tp_axis, ep_axis)
    return {"params": pspecs, "mu": pspecs, "nu": pspecs, "step": ()}


def factor_devices_moe(n: int) -> tuple[int, int, int, int]:
    """(dp, ep, sp, tp), ep first (8 -> (1, 2, 2, 2)): the pipeline's
    split."""
    return factor_devices_4d(n)


def make_mesh_moe(n_devices: int | None = None, shape=None,
                  axis_names=MOE_AXES, device=None):
    """A (dp, ep, sp, tp) mesh of in-process ranks on ``device``."""
    return make_mesh_4d(n_devices, shape, axis_names, device)


def _moe_grads(model_cfg, train_cfg, device, comm, axis_names,
               serialize_overlap=False, cache=None):
    """``(grads_fn, pspecs, mesh, topos)``: ``grads_fn(state, tokens,
    targets) -> (metrics, grads, ef)``, the global ``loss``, ``aux`` and
    ``total``, every rank's tree (synced slices; under
    ``shard_optimizer`` unsynced, or with ``overlap`` the fired buckets'
    shards) and the ranks' new residuals (see
    :func:`make_moe_train_step`); ``cache`` the step's
    (:func:`.train.spmd_step`)."""
    get_codec(train_cfg.codec)  # raises for an unknown codec
    comm = step_mesh(comm, device, axis_names)
    dp, ep, sp, tp = axis_names
    sizes = comm_axis_sizes(comm, axis_names)
    if model_cfg.n_experts % sizes[ep]:
        raise ValueError(f"n_experts={model_cfg.n_experts} must be divisible "
                         f"by ep={sizes[ep]}")
    if model_cfg.top_k > model_cfg.n_experts:
        raise ValueError("top_k cannot exceed n_experts")
    validate_tp(model_cfg, sizes[tp])
    pspecs = moe_param_specs(model_cfg, tp, ep)
    topos = resolve_axis_topos(sizes, axis_names, train_cfg.grad_topo)
    ep_axis, sp_axis, tp_axis = (axis(comm, a) for a in (ep, sp, tp))
    n_devices = math.prod(sizes.values())
    weight = model_cfg.router_aux_weight
    dev = comm.devices[0]
    side = overlap_stream(train_cfg, dev)
    plans = {} if cache is None else cache

    def grads_fn(state, tokens, targets):
        tokens = torch.as_tensor(tokens, device=dev)
        targets = torch.as_tensor(targets, device=dev)
        rows, cols = sizes[dp] * sizes[ep], sizes[sp]
        if tokens.shape[0] % rows or tokens.shape[1] % cols:
            raise ValueError(f"a batch of {tuple(tokens.shape)} does not "
                             f"split over dp x ep={rows} rows and sp={cols} "
                             f"columns")
        toks, tgts = (shard_batch(x, ((dp, ep), sp), comm)
                      for x in (tokens, targets))
        # the tp-fold redundancy only: dp, ep and sp split the data
        n_total = tokens.numel() * sizes[tp]
        if train_cfg.overlap:
            from .overlap import moe_overlap_step_grads

            plan, layout = mesh_overlap_plan(
                plans, state["params"], pspecs, comm, axis_names, topos,
                train_cfg, model_cfg, toks[0], dev)
            ce, aux, grads, ef = moe_overlap_step_grads(
                state, [x.long() for x in toks], tgts, model_cfg, train_cfg,
                plan, pspecs, axis_names, topos, n_total, n_devices,
                tp_axis, sp_axis, ep_axis, serialize=serialize_overlap,
                zero_layout=layout, comm=comm, stream=side)
        else:
            def rank_losses(leaves):
                logits, aux = moe_forward(leaves, [x.long() for x in toks],
                                          model_cfg, tp_axis=tp_axis,
                                          sp_axis=sp_axis, ep_axis=ep_axis)
                ce = [cross_entropy_loss(lg, y)[0] / n_total
                      for lg, y in zip(logits, tgts)]
                # the aux is a per-rank mean: average it over every rank
                # (the tp copies are equal, so the 1/n_devices weighting is
                # exact)
                return [c + weight * a / n_devices for c, a in
                        zip(ce, aux)], (ce, aux)

            _, grads, ef, (ce, aux) = spmd_grads(
                state, pspecs, comm, axis_names, topos, train_cfg,
                rank_losses)
        loss = psum_all([c.detach() for c in ce], comm, axis_names)[0]
        aux = psum_all([a.detach() / n_devices for a in aux], comm,
                       axis_names)[0]
        return {"loss": loss, "aux": aux,
                "total": loss + weight * aux}, grads, ef

    return grads_fn, pspecs, comm, topos


def make_moe_loss_and_grads(model_cfg: MoEConfig,
                            train_cfg: TrainConfig = TrainConfig(),
                            device=None, comm=None, axis_names=MOE_AXES):
    """``(params, tokens, targets, state=None) -> (metrics, grads)``: the
    step's ``loss``, ``aux`` and ``total`` and the synced gradient of the
    full tree, the first half of :func:`make_moe_train_step` (same
    arguments); under ``shard_optimizer`` every rank's unsynced tree.  A
    lossy codec needs the train ``state`` (its ``step`` and ``ef``)."""
    train_cfg = maybe_autotune_grad_topo(comm, model_cfg, train_cfg,
                                         axis_names, init_moe_params, device)
    grads_fn, pspecs, comm, _ = _moe_grads(model_cfg, train_cfg, device,
                                           comm, axis_names)

    def loss_and_grads(params, tokens, targets, state=None):
        metrics, grads, _ = grads_fn(dict(state or {}, params=params),
                                     tokens, targets)
        if train_cfg.shard_optimizer:
            return metrics, grads
        return metrics, gather_tree(grads, pspecs, comm)

    return loss_and_grads


def make_moe_train_step(model_cfg: MoEConfig,
                        train_cfg: TrainConfig = TrainConfig(), device=None,
                        comm=None, axis_names=MOE_AXES,
                        serialize_overlap: bool = False):
    """The MoE train step ``(state, tokens, targets) -> (state, metrics)``
    over ``comm``, a :class:`~.mesh.Mesh` with the axes ``axis_names`` (dp,
    ep, sp, tp), every rank in this process on one device (None: one rank
    on ``device``, default ``cuda``).

    ``tokens``/``targets``: the global (B, T) batch, rows over (dp, ep)
    and columns over sp.  ``metrics``: the global mean cross entropy
    ``loss``, the router balance ``aux`` (a mean over every rank), the
    optimized ``total`` and, with clipping, ``grad_norm``.  Under
    ``shard_optimizer`` the state is :func:`init_moe_train_state`'s with
    the same ``comm``.  ``serialize_overlap``: the overlapped step's twin
    (the whole backward, then the same buckets in the same order).
    ``train_cfg.autotune`` resolves ``grad_topo`` first
    (:func:`.train.maybe_autotune_grad_topo`)."""
    train_cfg = maybe_autotune_grad_topo(comm, model_cfg, train_cfg,
                                         axis_names, init_moe_params, device)
    cache: dict = {}
    grads_fn, pspecs, comm, topos = _moe_grads(
        model_cfg, train_cfg, device, comm, axis_names, serialize_overlap,
        cache)
    return spmd_step(grads_fn, cache, pspecs, comm, axis_names, topos,
                     train_cfg, fired=train_cfg.overlap,
                     metrics_of=lambda metrics: metrics)
