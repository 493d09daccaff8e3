"""The fold kernel's launches on the wide meshes, counted on the CPU: the
count ``chip_smoke.py`` phase 24 holds the card to.  Each sync of seeded
slices (the lossy replicated sync, ZeRO-1's reduce-scatter with its
secondary-axis block allreduces) calls the fold as often as
``bucketing.mesh_fold_launches`` derives, and its owned blocks are the
replicated sync's; a train step under each option calls it as often as
the replicated step, less its sync, plus the option's (the whole tree,
or each fired payload)."""

import pytest
import torch

from flextree_tpu_torch.parallel import train as ttrain
from flextree_tpu_torch.utils.tree import tree_leaves
from test_torch_wide import (
    AXES,
    BATCH,
    KW,
    OPTIONS,
    SHAPES,
    batches,
    port_cfg,
    port_layout,
    port_mesh,
    port_specs,
    port_state,
    port_step,
)


def _count_folds(monkeypatch):
    """Patch the walkers' ``reduce_sources`` to count the fold kernel's
    launches each call would make on a card (one a ``MAX_POINTERS //
    (W + 1)`` folds)."""
    from flextree_tpu_torch.ops import reduce_stacked as rs
    from flextree_tpu_torch.parallel import allreduce as ar
    from flextree_tpu_torch.parallel import compressed as cm

    seen = [0]
    real = rs.reduce_sources

    def counting(folds, op="sum", sources_tile=1):
        folds = [(list(src), out) for src, out in folds]
        if folds and folds[0][1].numel():
            per = rs.MAX_POINTERS // (len(folds[0][0]) + 1)
            seen[0] += -(-len(folds) // per)
        return real(folds, op, sources_tile)

    for mod in (ar, cm):
        monkeypatch.setattr(mod, "reduce_sources", counting)
    return seen


@pytest.mark.parametrize("codec", [None, "int8", "bf16"])
@pytest.mark.parametrize("family", list(SHAPES))
def test_fold_launches_are_the_codes_count(family, codec, monkeypatch):
    """The replicated (lossy) sync and the ZeRO-1 reduce-scatter of seeded
    slices on each wide mesh call the fold exactly as often as
    ``bucketing.mesh_fold_launches`` derives: the count the card run is
    held to;
    and the sharded sync's owned blocks are the replicated sync's blocks
    (bitwise for the identity codec)."""
    from flextree_tpu_torch.parallel import bucketing as bk
    from flextree_tpu_torch.parallel import zero as tzero
    from flextree_tpu_torch.parallel.spmd import shard_tree

    mesh, axes, specs = port_mesh(family), AXES[family], port_specs(family)
    params = port_state(family, None)["params"]
    gen = torch.Generator().manual_seed(3)
    trees = [ttrain.tree_map(lambda p: torch.randn(p.shape, generator=gen),
                             t) for t in shard_tree(params, specs, mesh)]
    sizes = dict(zip(axes, SHAPES[family]))
    topos = ttrain.resolve_axis_topos(sizes, axes, None)
    leaves = tree_leaves(trees[0])
    flat_specs = bk.spec_leaves(trees[0], specs)
    seen = _count_folds(monkeypatch)
    kw = dict(codec=codec or "f32", step=5)
    if codec:
        ttrain.sync_grads(trees, specs, axes, topos, bucket_bytes=None,
                          comm=mesh, **kw)
        assert seen[0] == bk.mesh_fold_launches(leaves, flat_specs, axes,
                                                sizes, topos, codec=codec)
    seen[0] = 0
    if codec == "bf16":
        return
    shards = tzero.zero_reduce_scatter_grads(trees, specs, axes, topos,
                                             comm=mesh, **kw)
    assert seen[0] == bk.mesh_fold_launches(leaves, flat_specs, axes, sizes,
                                            topos, codec=codec, sharded=True)
    if codec:
        return
    synced = ttrain.sync_grads(trees, specs, axes, topos, bucket_bytes=0,
                               comm=mesh)
    layout = port_layout(family, params)
    for r, (sh, full) in enumerate(zip(shards, synced)):
        for plan, s, g in zip(layout.leaves, tree_leaves(sh),
                              tree_leaves(full)):
            if not plan.sharded:
                continue
            perm = layout.perm_for(topos, plan.shard_ax)
            pos = mesh.axis_names.index(plan.shard_ax)
            from flextree_tpu_torch.parallel.spmd import rank_coords

            block = perm[rank_coords(mesh)[r][pos]]
            flat = g.reshape(-1)
            assert torch.equal(s.tile, flat[:plan.head].view(
                plan.n, plan.tile)[block])
            assert torch.equal(s.tail, flat[plan.head:])


def _sync_launches(family, option, params):
    """A step's sync launches under ``option``, as ``chip_smoke.py`` phase
    24(b) derives them (``train.step_sync_fold_launches``)."""
    tc = ttrain.TrainConfig(**OPTIONS.get(option, {}))
    return ttrain.step_sync_fold_launches(
        port_cfg(family), tc, params, port_specs(family), port_mesh(family),
        AXES[family], BATCH, pipeline=family == "pipeline")


_STEP_FOLDS: dict = {}  # a step's fold launches by (family, option)


@pytest.mark.parametrize("option", ["int8", "zero", "overlap",
                                    "zero_overlap"])
@pytest.mark.parametrize("family", list(SHAPES))
def test_step_fold_launches_are_the_codes_count(family, option,
                                                monkeypatch):
    """One step under ``option`` calls the fold as often as the replicated
    step, less its sync, plus the option's sync as phase 24(b) derives it
    (the forward and backward combines are the same in both)."""
    seen = _count_folds(monkeypatch)
    counts = {}
    for name in ("replicated", option):
        if (family, name) in _STEP_FOLDS:
            counts[name] = _STEP_FOLDS[family, name]
            continue
        tc = ttrain.TrainConfig(**KW, **OPTIONS.get(name, {}))
        state = port_state(family, tc)
        seen[0] = 0
        port_step(family, tc)(state, *batches()[0])
        counts[name] = _STEP_FOLDS[family, name] = seen[0]
    params = port_state(family, None)["params"]
    assert counts[option] - counts["replicated"] == \
        _sync_launches(family, option, params) - \
        _sync_launches(family, "replicated", params)
