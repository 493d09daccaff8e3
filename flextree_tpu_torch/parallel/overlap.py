"""Readiness-ordered backward/comm overlap for the gradient sync.

The port's copy of ``flextree_tpu/parallel/overlap.py`` (its dense
engine).  The serialized train step runs the whole backward, then the
whole sync.  But the last layer's gradient exists as soon as its backward
segment has run, long before the first layer's.  This module splits the
backward into segments, one ``torch.autograd.grad`` each (the chain rule
that one ``torch.autograd.grad`` over the whole graph runs, composed by
hand, so the gradients are bitwise the same), and fires each gradient
bucket's FlexTree sync as soon as its last segment has run.

Readiness order for the ``{embed, ln_f, layers}`` model:

1. the loss head (``ln_f``: its gradient falls out of the logits'
   backward);
2. the layers, last to first;
3. the embedding, whose gradient is the head's ``embed.T`` contribution
   (ready first) plus the lookup's (ready last): the embedding's bucket
   fires at the backward's end, and its sync is always exposed.

The bucket boundaries come from the planner
(:func:`..planner.choose.choose_overlap_boundaries`): each bucket's
predicted sync time is weighed against the backward compute still left
to hide it.

**Ranks in lock-step.**  On an in-process :class:`~.mesh.Mesh` a bucket
needs every rank's segment, so the engine runs every rank's forward
first (each rank holds its segment graphs), then, segment by segment in
readiness order, every rank's backward of that segment, then the buckets
that segment closes.  On a ``torch.distributed`` group this process is
one rank and walks the same order.

**The comm stream.**  On a card each fired bucket's sync runs on a side
stream of the device (each step function keeps its own), so the card can
run a bucket's folds and copies while the next segment's backward runs on
the current stream.  The fold kernel and the mesh's copies launch on the
current stream, so entering the side stream moves the whole sync.  Before
each fire the side stream waits for the current one (the segment's
gradients exist); before anything reads the synced trees the current
stream waits for the side stream.  Every segment gradient stays
referenced until that last wait, and everything the sync allocates is
read on the current stream only after it, so the caching allocator never
hands one stream a block the other is still using.  On the CPU there are
no streams, and over gloo the sync stages through host memory and is
synchronous: the fires run in order and nothing overlaps there.

**The serialized twin** (``serialize=True``) runs the whole backward
first, then fires the same buckets in the same order, on the same
stream: the A/B comparator, bitwise equal to the overlapped step (the
JAX twin puts an ``optimization_barrier`` over every gradient instead).

A lossy codec syncs ``grad + ef`` per fired bucket and returns the
wire's residual per leaf, with ``sync_with_feedback``'s semantics.

**ZeRO-1** (``zero_layout``): a fired bucket reduce-scatters
(:func:`.zero.zero_reduce_scatter_grads`, ``grad + ef`` under a lossy
codec, whose residual comes back), and the engine hands back each rank's
tree of :class:`~.zero.ZeroShard`; the shard update and the parameters'
all-gather run after the backward, on the current stream, after its wait
for the side stream.  The shards and residuals a fire makes on the side
stream are read on the current stream only after that wait, as the fired
allreduce's results are, and the next step's first fire waits for the
current stream before its stream reuses their blocks.

Not here yet: ``moe_overlap_step_grads`` and
``overlap_sync_with_feedback`` (the pipeline's tail) wait for ROADMAP
Queue 1 item 8 ('Sequence, pipeline and expert parallelism').
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence

import torch

from ..schedule.stages import Topology
from ..utils.profiling import comm_span
from ..utils.tree import tree_leaves, tree_map, tree_unflatten
from .mesh import Mesh

__all__ = [
    "OverlapPlan",
    "resolve_bwd_GFLOPs",
    "readiness_segments",
    "segment_flops",
    "plan_overlap",
    "fired_payloads",
    "dense_overlap_step_grads",
]

#: The boundary equalizer's backward throughput (GFLOP/s) by device type
#: when the calibration leaves ``bwd_GFLOPs`` at 0.  The CPU's is the JAX
#: package's host figure.  The card's is :func:`segment_flops` summed over
#: the flagship's segments (vocab 8192, d_model 512, 8 heads, 4 layers,
#: d_ff 2048, bf16, flash) for one rank's share of the dp=8 step (B=1,
#: T=1024): 85.900 GFLOP over that backward's 2.3364 ms in CUDA events
#: (median of 10, the host ahead of the card), measured by
#: ``chip_smoke.py`` phase 18(e) on an NVIDIA H100 80GB HBM3 at a 700 W
#: power limit.
_BWD_GFLOPS_DEFAULTS = {"cpu": 8.0, "cuda": 36_765.6}


def resolve_bwd_GFLOPs(params, device) -> float:
    """The boundary equalizer's compute throughput: the calibrated
    ``bwd_GFLOPs`` when set, else the default for ``device``'s type."""
    if params is not None and getattr(params, "bwd_GFLOPs", 0.0) > 0.0:
        return params.bwd_GFLOPs
    kind = torch.device(device).type
    if kind not in _BWD_GFLOPS_DEFAULTS:
        raise ValueError(f"no backward throughput for device type {kind!r}; "
                         f"calibrate bwd_GFLOPs")
    return _BWD_GFLOPS_DEFAULTS[kind]


@dataclasses.dataclass(frozen=True)
class OverlapPlan:
    """Which readiness segments fire together, and what the model
    predicted for it."""

    labels: tuple[str, ...]  # per segment, readiness order
    boundaries: tuple[tuple[int, ...], ...]  # groups of segment indices
    seg_bytes: tuple[int, ...]
    seg_compute_us: tuple[float, ...]
    predicted_total_us: float
    predicted_exposed_us: float

    @property
    def n_buckets(self) -> int:
        return len(self.boundaries)


def readiness_segments(params) -> list[tuple[str, Any]]:
    """``(label, path)`` of each backward segment in readiness order for
    the ``{embed, ln_f, layers: [...]}`` model.  The path is ``("ln_f",)``,
    ``("layers", i)`` or ``("embed",)``: it indexes the params, the grads
    and the specs trees alike."""
    n_layers = len(params["layers"])
    segs: list[tuple[str, Any]] = [("head", ("ln_f",))]
    for i in reversed(range(n_layers)):
        segs.append((f"layer{i}", ("layers", i)))
    segs.append(("embed", ("embed",)))
    return segs


def _subtree(tree, path):
    out = tree
    for p in path:
        out = out[p]
    return out


def _merge(bucket, part) -> dict:
    """A fired bucket's payload: segment ``i``'s ``part(i)`` keyed
    ``str(i)``, as the JAX engine keys the merged subtree, so the leaves
    pack in the JAX package's order."""
    return {str(i): part(i) for i in bucket}


def fired_payloads(plan: OverlapPlan, tree) -> list[dict]:
    """Each fired bucket's payload cut from a whole ``{embed, ln_f,
    layers}`` tree (gradients, specs or residuals), in firing order: the
    tree the engine syncs for that bucket."""
    paths = [path for _, path in readiness_segments(tree)]
    return [_merge(b, lambda i: _subtree(tree, paths[i]))
            for b in plan.boundaries]


def segment_flops(path, params_shapes, n_tokens: int, d_model: int,
                  t_local: int) -> float:
    """Estimated backward FLOPs of one readiness segment: the matmul
    gradients (dgrad and wgrad, twice the forward's ``2·P·T``) of the
    segment's weights of two or more dimensions, plus for a layer the
    attention's score and value products (``4·T²·d`` forward, doubled).
    The head carries the vocab projection's gradients (through
    ``embed.T``); the embedding's segment is the lookup's scatter-add.  An
    estimate: a mispriced segment moves one boundary by one layer."""
    sub = _subtree(params_shapes, path)
    weight_params = sum(math.prod(leaf.shape) for leaf in tree_leaves(sub)
                        if len(leaf.shape) >= 2)
    flops = 4.0 * weight_params * n_tokens
    if path[0] == "layers":
        flops += 8.0 * t_local * t_local * d_model * (n_tokens / t_local)
    if path == ("ln_f",):
        v, d = params_shapes["embed"].shape
        flops += 4.0 * v * d * n_tokens
    if path[0] == "embed":
        flops = 2.0 * d_model * n_tokens
    return flops


def _cost_topologies(mesh_axes, topos, axis_sizes) -> list:
    """The topologies a fired bucket is priced with: one for each mesh
    axis of size above 1, the ``"psum"`` sentinel (None) priced as a flat
    tree."""
    out = []
    for ax in mesh_axes:
        n = int(axis_sizes.get(ax, 1))
        if n <= 1:
            continue
        topo = topos.get(ax)
        out.append(Topology.flat(n) if topo is None
                   else Topology.resolve(n, topo))
    return out


def plan_overlap(params_shapes, pspecs, mesh_axes, topos, axis_sizes,
                 n_tokens: int, t_local: int, d_model: int,
                 cost_params=None, codec=None, device=None) -> OverlapPlan:
    """Compute-equalized bucket boundaries for the readiness segments of
    ``params_shapes`` (tensors, of any device, ``"meta"`` included; only
    their shapes and dtypes are read).  ``n_tokens``/``t_local``: one
    rank's tokens and sequence length.  ``device``: whose default backward
    throughput prices the segments when ``cost_params`` has none (default:
    the embedding's device)."""
    from ..planner.choose import (
        choose_overlap_boundaries,
        predict_overlap_schedule,
    )

    if cost_params is None:
        from ..planner.calibrate import default_params

        cost_params = default_params()
    if device is None:
        device = params_shapes["embed"].device
    gflops = resolve_bwd_GFLOPs(cost_params, device)
    segs = readiness_segments(params_shapes)
    labels, seg_bytes, seg_us = [], [], []
    for label, path in segs:
        sub = _subtree(params_shapes, path)
        labels.append(label)
        seg_bytes.append(sum(leaf.numel() * leaf.element_size()
                             for leaf in tree_leaves(sub)))
        seg_us.append(segment_flops(path, params_shapes, n_tokens, d_model,
                                    t_local) / (gflops * 1e3))
    cost_topos = _cost_topologies(mesh_axes, topos, axis_sizes)
    if not cost_topos:  # one rank: nothing to sync, one bucket
        boundaries = (tuple(range(len(segs))),)
        total = exposed = 0.0
    else:
        boundaries = choose_overlap_boundaries(
            seg_bytes, seg_us, cost_topos, params=cost_params, codec=codec)
        total, exposed = predict_overlap_schedule(
            boundaries, seg_bytes, seg_us, cost_topos, params=cost_params,
            codec=codec)
    return OverlapPlan(tuple(labels), boundaries, tuple(seg_bytes),
                       tuple(seg_us), total, exposed)


# ------------------------------------------------------------- bucket fire


def _sync_fired_bucket(bucket_trees, bucket_specs, mesh_axes, topos,
                       train_cfg, step, ef_trees, name: str,
                       zero_layout=None, *, comm):
    """Sync one fired bucket with ``sync_with_feedback``'s semantics: the
    identity codec gives the plain (bitwise) sync and no residual; a lossy
    one syncs ``grad + ef`` compressed and returns each leaf's residual.
    ``bucket_trees``/``ef_trees``: each local rank's tree, in a list.  The
    granularity inside the fired payload follows ``train_cfg.bucket_bytes``
    as the serialized sync's does: the boundary decides when a payload
    fires, the inner plan its collectives.  Returns ``(synced, residuals
    or None)``, each a list of the local ranks' trees.

    With ``zero_layout`` (ZeRO-1) the bucket reduce-scatters instead
    (:func:`.zero.zero_reduce_scatter_grads` on the payload's own layout, a
    function of its leaves' shapes and specs, so it agrees with the
    step's): ``synced`` holds :class:`~.zero.ZeroShard` leaves."""
    from ..obs import bucket_provenance
    from ..ops.quantize import get_codec
    from ..utils.profiling import span_bytes
    from .train import sync_grads

    codec = get_codec(train_cfg.codec)
    prov = bucket_provenance(mesh_axes, topos, span_bytes(name) or 0,
                             codec=codec if codec.lossy else None,
                             chunks=train_cfg.grad_chunks,
                             sharded=zero_layout is not None, fired=True)
    # the syncs take a mesh's list of trees, else the one rank's tree
    mesh = isinstance(comm, Mesh)
    kw = dict(bucket_bytes=train_cfg.bucket_bytes, comm=comm)
    if zero_layout is not None:
        from .zero import zero_reduce_scatter_grads as sync
    else:
        sync = sync_grads
        kw["chunks"] = train_cfg.grad_chunks
    with comm_span(name, provenance=prov):
        if not codec.lossy:
            out = sync(bucket_trees if mesh else bucket_trees[0],
                       bucket_specs, mesh_axes, topos, **kw)
            return (out if mesh else [out]), None
        v = [tree_map(lambda g, e: g + e.to(g.dtype), g, e)
             for g, e in zip(bucket_trees, ef_trees)]
        synced, res = sync(v if mesh else v[0], bucket_specs, mesh_axes,
                           topos, codec=codec, step=step,
                           return_residual=True, **kw)
        return (synced, res) if mesh else ([synced], [res])


def _fire_boundaries(plan: OverlapPlan, seg_paths, seg_grads, efs, step,
                     pspecs, mesh_axes, topos, train_cfg,
                     fire_at: dict[int, int], seg_index: int,
                     synced_out: dict, ef_out: dict, zero_layout=None, *,
                     comm):
    """Fire the bucket whose closing segment is ``seg_index``, if any:
    merge its segments into one tree a rank (:func:`_merge`), sync, and
    hand the results back by segment."""
    bi = fire_at.get(seg_index)
    if bi is None:
        return
    bucket = plan.boundaries[bi]
    trees = [_merge(bucket, lambda i: seg_grads[i][r])
             for r in range(len(seg_grads[seg_index]))]
    specs = _merge(bucket, lambda i: _subtree(pspecs, seg_paths[i]))
    ef = None
    if efs is not None:
        ef = [_merge(bucket, lambda i: _subtree(e, seg_paths[i]))
              for e in efs]
    nbytes = sum(plan.seg_bytes[i] for i in bucket)
    name = f"ft_overlap_bucket{bi}_{plan.labels[bucket[0]]}_{nbytes}B"
    synced, res = _sync_fired_bucket(trees, specs, mesh_axes, topos,
                                     train_cfg, step, ef, name,
                                     zero_layout=zero_layout, comm=comm)
    for i in bucket:
        synced_out[i] = [t[str(i)] for t in synced]
        if res is not None:
            ef_out[i] = [t[str(i)] for t in res]


def _assemble(params, seg_paths, synced_by_seg):
    """A full ``{embed, ln_f, layers}`` tree from per-segment parts."""
    layers = [None] * len(params["layers"])
    out = {"embed": None, "ln_f": None, "layers": layers}
    for path, sub in zip(seg_paths, synced_by_seg):
        if path[0] == "layers":
            layers[path[1]] = sub
        else:
            out[path[0]] = sub
    return out


# --------------------------------------------------------------- engines


def _run_overlap_engine(params, efs, step, pspecs, mesh_axes, topos,
                        train_cfg, plan: OverlapPlan, seg_paths,
                        backward_segments: Callable[[], Sequence],
                        serialize: bool, zero_layout=None, *, comm,
                        side):
    """Walk ``backward_segments()`` (each segment's gradients, one tree a
    local rank, in readiness order), firing each bucket as its last
    segment arrives, or, serialized, after the whole backward (same
    buckets, same order, bitwise the same results).  With a ``side``
    stream (a card) every fire runs on it.  Returns each local rank's
    synced tree and new residual tree (None for the identity codec), in
    lists."""
    fire_at = {b[-1]: bi for bi, b in enumerate(plan.boundaries)}
    n_seg = len(seg_paths)
    seg_grads: list = [None] * n_seg
    synced: dict[int, Any] = {}
    ef_out: dict[int, Any] = {}
    main = torch.cuda.current_stream(side.device) if side is not None \
        else None

    def fire(i):
        if i not in fire_at:
            return
        args = (plan, seg_paths, seg_grads, efs, step, pspecs, mesh_axes,
                topos, train_cfg, fire_at, i, synced, ef_out)
        if side is None:
            _fire_boundaries(*args, zero_layout=zero_layout, comm=comm)
            return
        side.wait_stream(main)  # the segment's gradients exist
        with torch.cuda.stream(side):
            _fire_boundaries(*args, zero_layout=zero_layout, comm=comm)

    for i, g in enumerate(backward_segments()):
        seg_grads[i] = g
        if not serialize:
            fire(i)
    if serialize:
        for i in range(n_seg):
            fire(i)
    if side is not None:
        main.wait_stream(side)  # before anything reads the synced trees
    n_ranks = len(seg_grads[0])
    grads = [_assemble(params, seg_paths, [synced[i][r] for i in
                                           range(n_seg)])
             for r in range(n_ranks)]
    new_ef = None
    if ef_out:
        new_ef = [_assemble(params, seg_paths, [ef_out[i][r] for i in
                                                range(n_seg)])
                  for r in range(n_ranks)]
    return grads, new_ef


def _segment_graphs(params, tokens, targets, model_cfg, positions,
                    n_total_tokens, tp_axis, sp_axis):
    """One rank's forward, cut at every segment: each layer's input is a
    fresh leaf.  Returns the backward as a generator of the segments'
    gradients in readiness order, and the rank's loss."""
    from ..models.transformer import (
        cross_entropy_loss,
        final_logits,
        layer_forward,
    )

    with torch.enable_grad():
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        embed = leaves["embed"]
        x0 = embed[tokens.long()].to(model_cfg.dtype)
        ins, outs = [x0.detach().requires_grad_()], []
        for layer in leaves["layers"]:
            outs.append(layer_forward(layer, ins[-1], positions, model_cfg,
                                      tp_axis=tp_axis, sp_axis=sp_axis))
            ins.append(outs[-1].detach().requires_grad_())
        loss_sum, _ = cross_entropy_loss(
            final_logits(embed, leaves["ln_f"], ins[-1]), targets)
        loss = loss_sum / n_total_tokens

    def backward():
        d_embed_head, d_ln_f, dx = torch.autograd.grad(
            loss, [embed, leaves["ln_f"], ins[-1]])
        yield d_ln_f  # segment 0: the loss head
        for i in reversed(range(len(outs))):
            layer = leaves["layers"][i]
            *d_layer, dx = torch.autograd.grad(
                outs[i], tree_leaves(layer) + [ins[i]], grad_outputs=dx)
            yield tree_unflatten(layer, d_layer)
        (d_embed_in,) = torch.autograd.grad(x0, [embed], grad_outputs=dx)
        yield d_embed_head + d_embed_in  # last: the embedding

    return backward(), loss.detach()


def dense_overlap_step_grads(state, tokens, targets, model_cfg, train_cfg,
                             plan: OverlapPlan, pspecs, mesh_axes, topos,
                             n_total_tokens, tp_axis=None, sp_axis=None,
                             serialize: bool = False, zero_layout=None, *,
                             comm=None, stream=None):
    """Losses, readiness-order-synced gradients and new residuals for the
    dense train step: the overlap twin of the local backward plus
    ``sync_with_feedback``, bitwise the same for the identity codec.

    ``tokens``/``targets``: each local rank's batch rows, in a list (every
    rank's on a :class:`~.mesh.Mesh`, else the one rank's).  ``plan``: the
    buckets (:func:`plan_overlap`, a function of the shapes only, so a step
    function plans once).  ``comm``: None (one rank), a mesh or a process
    group.  ``state``: its ``"params"``, and for a lossy codec its
    ``"step"`` (the counter before the update, keying the rounding) and
    ``"ef"`` (each local rank's tree, in a list).  ``stream``: on a card,
    the side stream the fired syncs run on (None: one from PyTorch's pool;
    a step function keeps one for all its calls, so the caching allocator
    reuses its blocks).  ``zero_layout`` (the step's
    :class:`~.zero.ZeroLayout`, or None): each fired bucket
    reduce-scatters, and ``synced_grads`` holds each rank's
    :class:`~.zero.ZeroShard` tree.  Returns ``(losses, synced_grads,
    new_ef or None)``, each a list of the local ranks'."""
    from ..models.transformer import global_positions
    from ..ops.quantize import get_codec

    params = state["params"]
    dev = params["embed"].device
    t_local = tokens[0].shape[1]
    seg_paths = [path for _, path in readiness_segments(params)]
    positions = global_positions(t_local, sp_axis, device=dev)
    efs, step = None, 0
    if get_codec(train_cfg.codec).lossy:
        efs, step = state["ef"], int(state["step"])
    # lock-step: every local rank's forward, then each segment's backward
    # on every rank
    runs = [_segment_graphs(params, t, y, model_cfg, positions,
                            n_total_tokens, tp_axis, sp_axis)
            for t, y in zip(tokens, targets)]

    def backward_segments():
        for gs in zip(*(seg for seg, _ in runs)):
            yield list(gs)

    grads, new_ef = _run_overlap_engine(
        params, efs, step, pspecs, mesh_axes, topos, train_cfg, plan,
        seg_paths, backward_segments, serialize, zero_layout, comm=comm,
        side=None if dev.type != "cuda" else
        stream or torch.cuda.Stream(device=dev))
    return [loss for _, loss in runs], grads, new_ef
