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
first, then, segment by segment in readiness order, every rank's
backward of that segment, then the buckets that segment closes.  The cut
runs across every rank at once: each layer's input is a fresh leaf on
every rank, the layer runs over all ranks (on a wide mesh the ring hops'
``ppermute`` and the tensor-parallel combine couple them), and one
``torch.autograd.grad`` a segment covers every rank's outputs, so a
cotangent hop inside a segment stays on the current stream.  On a
``torch.distributed`` group this process is one rank and walks the same
order.

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

**The MoE engine** (:func:`moe_overlap_step_grads`) cuts the MoE model
the same way; a MoE layer's segment has a second output, the router's
balance term, whose cotangent is the constant the loss gives it
(``router_aux_weight / (n_moe · n_devices)``, computed by autograd from
the step's own expression, so the composed gradient is bitwise the
whole backward's).  **The pipeline's tail** (:func:`overlap_sync_with_
feedback`): the GPipe backward yields every gradient at once, so overlap
there fires three buckets (``ln_f``, the layer stack, ``embed``) after
it, on the side stream.

**ZeRO-1** (``zero_layout``): a fired bucket reduce-scatters
(:func:`.zero.zero_reduce_scatter_grads`, ``grad + ef`` under a lossy
codec, whose residual comes back), and the engine hands back each rank's
tree of :class:`~.zero.ZeroShard`; the shard update and the parameters'
all-gather run after the backward, on the current stream, after its wait
for the side stream.  The shards and residuals a fire makes on the side
stream are read on the current stream only after that wait, as the fired
allreduce's results are, and the next step's first fire waits for the
current stream before its stream reuses their blocks.
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
from .spmd import rank_slices

__all__ = [
    "OverlapPlan",
    "resolve_bwd_GFLOPs",
    "readiness_segments",
    "segment_flops",
    "plan_overlap",
    "fired_payloads",
    "dense_overlap_step_grads",
    "moe_overlap_step_grads",
    "overlap_sync_with_feedback",
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


def _segment_graphs(slices, tokens, targets, model_cfg, n_total_tokens,
                    apply_layer, d_aux=None):
    """Every local rank's forward, cut at every segment: each layer's
    input a fresh leaf on every rank.  ``slices``: each rank's parameter
    tree; ``apply_layer(i, layers, xs) -> (outs, auxes or None)`` runs
    layer ``i`` over every rank (lists), ``d_aux`` the auxes' cotangent.
    Returns the backward, a generator of each segment's gradients (a list
    of the ranks' trees) in readiness order, and every rank's loss."""
    from ..models.transformer import cross_entropy_loss, final_logits

    with torch.enable_grad():
        leaves = [tree_map(lambda p: p.detach().requires_grad_(), t)
                  for t in slices]
        embeds = [lv["embed"] for lv in leaves]
        x0 = [e[t.long()].to(model_cfg.dtype) for e, t in zip(embeds, tokens)]
        ins = [[x.detach().requires_grad_() for x in x0]]
        outs, auxes = [], []
        for i in range(len(leaves[0]["layers"])):
            y, aux = apply_layer(i, [lv["layers"][i] for lv in leaves],
                                 ins[-1])
            outs.append(y)
            auxes.append(aux)
            ins.append([x.detach().requires_grad_() for x in y])
        losses = [cross_entropy_loss(final_logits(lv["embed"], lv["ln_f"], h),
                                     y)[0] / n_total_tokens
                  for lv, h, y in zip(leaves, ins[-1], targets)]
    k = len(leaves)

    def backward():
        got = torch.autograd.grad(
            losses, embeds + [lv["ln_f"] for lv in leaves] + ins[-1])
        d_embed_head, dx = got[:k], list(got[2 * k:])
        yield list(got[k:2 * k])  # segment 0: the loss head
        for i in reversed(range(len(outs))):
            layers = [lv["layers"][i] for lv in leaves]
            flat = [tree_leaves(layer) for layer in layers]
            roots, cots = list(outs[i]), dx
            if auxes[i] is not None:
                roots += auxes[i]
                cots = dx + [torch.full_like(a, d_aux) for a in auxes[i]]
            got = torch.autograd.grad(roots, [x for f in flat for x in f]
                                      + ins[i], grad_outputs=cots,
                                      materialize_grads=True)
            n = len(flat[0])
            yield [tree_unflatten(layer, got[r * n:(r + 1) * n])
                   for r, layer in enumerate(layers)]
            dx = list(got[k * n:])
        d_embed_in = torch.autograd.grad(x0, embeds, grad_outputs=dx)
        # last: the embedding
        yield [a + b for a, b in zip(d_embed_head, d_embed_in)]

    return backward(), [x.detach() for x in losses]


def _rank_efs(state, pspecs, comm, n: int):
    """The ranks' residual trees a lossy step syncs with (None for the
    identity codec): a mesh's list (one tree cut for every rank), a
    process group's own tree."""
    from .spmd import rank_trees

    if "ef" not in state:
        return None
    ef = state["ef"]
    if isinstance(comm, Mesh):
        return rank_trees(ef, pspecs, comm)
    return ef if isinstance(ef, list) else [ef] * n


def _engine(state, tokens, targets, model_cfg, train_cfg, plan, pspecs,
            mesh_axes, topos, n_total_tokens, apply_layer, serialize,
            zero_layout, comm, stream, d_aux=None):
    """The shared body of the dense and MoE engines: every rank's cut
    forward (:func:`_segment_graphs`), then the readiness walk
    (:func:`_run_overlap_engine`) on the side stream on a card."""
    from ..ops.quantize import get_codec

    params = state["params"]
    dev = params["embed"].device
    lossy = get_codec(train_cfg.codec).lossy
    efs = _rank_efs(state, pspecs, comm, len(tokens)) if lossy else None
    step = int(state["step"]) if lossy else 0
    slices = rank_slices(params, pspecs, comm, len(tokens))
    segs, losses = _segment_graphs(slices, tokens, targets, model_cfg,
                                   n_total_tokens, apply_layer, d_aux)
    seg_paths = [path for _, path in readiness_segments(params)]
    grads, new_ef = _run_overlap_engine(
        params, efs, step, pspecs, mesh_axes, topos, train_cfg, plan,
        seg_paths, lambda: segs, serialize, zero_layout, comm=comm,
        side=None if dev.type != "cuda" else
        stream or torch.cuda.Stream(device=dev))
    return losses, grads, new_ef


def _positions(tokens, sp_axis, lock: bool):
    """Every rank's global positions (a list) in lock-step, else the one
    rank-local position vector."""
    from ..models.transformer import global_positions

    t_local = tokens[0].shape[1]
    if sp_axis is not None:
        return global_positions(t_local, sp_axis)
    if lock:
        return [torch.arange(t_local, device=t.device) for t in tokens]
    return global_positions(t_local, device=tokens[0].device)


def dense_overlap_step_grads(state, tokens, targets, model_cfg, train_cfg,
                             plan: OverlapPlan, pspecs, mesh_axes, topos,
                             n_total_tokens, tp_axis=None, sp_axis=None,
                             serialize: bool = False, zero_layout=None, *,
                             comm=None, stream=None):
    """Losses, readiness-order-synced gradients and new residuals for the
    dense train step: the overlap twin of the local backward plus
    ``sync_with_feedback``, bitwise the same for the identity codec.

    ``tokens``/``targets``: each local rank's batch block, in a list
    (every rank's on a :class:`~.mesh.Mesh`, else the one rank's).
    ``tp_axis``/``sp_axis``: the mesh's :class:`~.spmd.Axis` handles on a
    wide mesh (each rank then holds its slices of ``state["params"]``, cut
    by ``pspecs``, and every layer runs over all ranks); None on the
    data-parallel mesh.  ``plan``: the buckets (:func:`plan_overlap` on one
    rank's slices, a function of the shapes only, so a step function plans
    once).  ``comm``: None (one rank), a mesh or a process group.
    ``state``: its ``"params"`` (the full tree), and for a lossy codec its
    ``"step"`` (the counter before the update, keying the rounding) and
    ``"ef"`` (one tree for every rank, or each local rank's, in a list).
    ``stream``: on a card, the side stream the fired syncs run on (None:
    one from PyTorch's pool; a step function keeps one for all its calls,
    so the caching allocator reuses its blocks).  ``zero_layout`` (the
    step's :class:`~.zero.ZeroLayout`, or None): each fired bucket
    reduce-scatters, and ``synced_grads`` holds each rank's
    :class:`~.zero.ZeroShard` tree.  Returns ``(losses, synced_grads,
    new_ef or None)``, each a list of the local ranks'."""
    from ..models.transformer import layer_forward

    lock = tp_axis is not None or sp_axis is not None
    positions = _positions(tokens, sp_axis, lock)

    def apply_layer(i, layers, xs):
        if lock:
            return layer_forward(layers, xs, positions, model_cfg,
                                 tp_axis=tp_axis, sp_axis=sp_axis), None
        return [layer_forward(layer, x, positions, model_cfg)
                for layer, x in zip(layers, xs)], None

    return _engine(state, tokens, targets, model_cfg, train_cfg, plan,
                   pspecs, mesh_axes, topos, n_total_tokens, apply_layer,
                   serialize, zero_layout, comm, stream)


def aux_cotangent(model_cfg, n_devices: int) -> float:
    """The cotangent of each MoE layer's balance term in the optimized
    loss ``ce + router_aux_weight · (Σ aux_i / n_moe) / n_devices``:
    autograd's own value of that expression's derivative (bitwise what
    the whole backward hands each layer), ``router_aux_weight / (n_moe ·
    n_devices)`` up to rounding."""
    n_moe = sum(1 for i in range(model_cfg.n_layers)
                if model_cfg.is_moe_layer(i))
    with torch.enable_grad():
        a = torch.zeros((), dtype=torch.float32, requires_grad=True)
        total = torch.zeros((), dtype=torch.float32) + a
        term = model_cfg.router_aux_weight * (total / max(n_moe, 1)) \
            / n_devices
        (d,) = torch.autograd.grad(term, a)
    return float(d)


def moe_overlap_step_grads(state, tokens, targets, model_cfg, train_cfg,
                           plan: OverlapPlan, pspecs, mesh_axes, topos,
                           n_total_tokens, n_devices: int, tp_axis, sp_axis,
                           ep_axis, serialize: bool = False,
                           zero_layout=None, *, comm, stream=None):
    """The MoE twin of :func:`dense_overlap_step_grads` (the JAX
    ``moe_overlap_step_grads``) over a (dp, ep, sp, tp) mesh: each MoE
    layer's segment carries the router's balance term, whose cotangent is
    :func:`aux_cotangent`'s constant, so the composed gradient is the
    whole backward's.  Returns ``(ce, aux_mean, synced_grads, new_ef or
    None)``, each a list of the ranks'."""
    from ..models.moe import moe_layer
    from ..models.transformer import attention_block, mlp_block, rms_norm

    positions = _positions(tokens, sp_axis, True)
    n_moe = sum(1 for i in range(model_cfg.n_layers)
                if model_cfg.is_moe_layer(i))
    auxes: list = []  # each MoE layer's, every rank's

    def apply_layer(i, layers, xs):
        h = attention_block(layers, xs, positions, model_cfg,
                            tp_axis=tp_axis, sp_axis=sp_axis)
        if not model_cfg.is_moe_layer(i):
            return mlp_block(layers, h, model_cfg, tp_axis=tp_axis), None
        y, aux = moe_layer(layers, [rms_norm(x, lr["ln2"]) for x, lr in
                                    zip(h, layers)], model_cfg,
                           tp_axis=tp_axis, ep_axis=ep_axis)
        auxes.append([a.detach() for a in aux])
        return [a + b for a, b in zip(h, y)], aux

    ce, grads, new_ef = _engine(state, tokens, targets, model_cfg, train_cfg,
                                plan, pspecs, mesh_axes, topos,
                                n_total_tokens, apply_layer, serialize,
                                zero_layout, comm, stream,
                                aux_cotangent(model_cfg, n_devices))
    aux_mean = []
    for r in range(len(tokens)):
        total = torch.zeros((), dtype=torch.float32, device=ce[r].device)
        for layer_aux in auxes:
            total = total + layer_aux[r]
        aux_mean.append(total / max(n_moe, 1))
    return ce, aux_mean, grads, new_ef


# ------------------------------------------------- whole-tree (pipeline)


# the pipeline's overlapped tail: one bucket a readiness part, in firing
# order (the JAX ``overlap_sync_with_feedback``)
PIPELINE_TAIL = ("ln_f", "layers", "embed")


def overlap_sync_with_feedback(state, grads, pspecs, mesh_axes, topos,
                               train_cfg, serialize: bool = False, *, comm,
                               stream=None):
    """The pipeline step's overlapped sync of whole gradient trees (the
    JAX ``overlap_sync_with_feedback``): its GPipe backward yields every
    gradient at once, so the buckets fire after it, one a readiness part
    (``ln_f``, the layer stack, ``embed``), each with
    ``sync_with_feedback``'s semantics, on the side stream on a card
    (``serialize``: on the current one, the twin).  ``grads``: every
    rank's tree (a mesh's list).  Returns ``(synced, new_ef or None)``,
    lists of the ranks' trees."""
    from ..ops.quantize import get_codec

    mesh = isinstance(comm, Mesh)
    trees = grads if mesh else [grads]
    lossy = get_codec(train_cfg.codec).lossy
    efs = _rank_efs(state, pspecs, comm, len(trees)) if lossy else None
    step = int(state["step"]) if lossy else 0
    dev = tree_leaves(trees[0])[0].device
    side = None if serialize or dev.type != "cuda" else \
        stream or torch.cuda.Stream(device=dev)
    main = torch.cuda.current_stream(dev) if side is not None else None
    synced: dict = {}
    ef_out: dict = {}
    for key in PIPELINE_TAIL:
        subs = [t[key] for t in trees]
        nbytes = sum(x.numel() * x.element_size()
                     for x in tree_leaves(subs[0]))
        args = ([{key: s} for s in subs], {key: pspecs[key]}, mesh_axes,
                topos, train_cfg, step,
                None if efs is None else [{key: e[key]} for e in efs],
                f"ft_overlap_tail_{key}_{nbytes}B")
        if side is None:
            got, res = _sync_fired_bucket(*args, comm=comm)
        else:
            side.wait_stream(main)  # the backward's gradients exist
            with torch.cuda.stream(side):
                got, res = _sync_fired_bucket(*args, comm=comm)
        synced[key] = [g[key] for g in got]
        if res is not None:
            ef_out[key] = [e[key] for e in res]
    if side is not None:
        main.wait_stream(side)  # before anything reads the synced trees
    out = [{k: synced[k][r] for k in trees[0]} for r in range(len(trees))]
    new_ef = [{k: ef_out[k][r] for k in trees[0]}
              for r in range(len(trees))] if ef_out else None
    if mesh:
        return out, new_ef
    return out[0], None if new_ef is None else new_ef[0]
