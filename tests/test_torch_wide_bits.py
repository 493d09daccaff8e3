"""The port's own bitwise contracts on the wide meshes, the JAX package's
(``tests/test_sharded.py:183, 233, 260``, ``tests/test_overlap.py:287,
299, 321``): for each family of :mod:`test_torch_wide` (dense (2, 2, 2),
pipeline and MoE (1, 2, 2, 2)), two float32 steps of the sharded step
bitwise the replicated one with clipping off (the consolidated moments
too, and composed with overlap), the overlapped step and its twin
bitwise the replicated one, and the lossy overlapped step bitwise its
serialized twin, every rank's ``ef`` included."""

import pytest

from flextree_tpu_torch.parallel import train as ttrain
from flextree_tpu_torch.utils.tree import tree_leaves
from test_torch_wide import (
    KW,
    SHAPES,
    f32,
    port_layout,
    port_mesh,
    port_specs,
    run_cached,
    same_state,
    same_trees,
)


@pytest.mark.parametrize("family", list(SHAPES))
def test_sharded_step_is_the_replicated_step_bitwise(family):
    """ZeRO-1 on the wide mesh, float32 and clipping off, and (the JAX
    ``test_dense_overlap_composition_bitwise``) composed with overlap:
    the loss and parameters bitwise the replicated step's after two steps,
    and the consolidated moments bitwise the replicated ``mu``/``nu``."""
    from flextree_tpu_torch.parallel import zero as tzero

    rep, rep_losses, _ = run_cached(family, f32())
    for kw in (dict(shard_optimizer=True),
               dict(shard_optimizer=True, overlap=True)):
        sh, losses, _ = run_cached(family, f32(**kw))
        assert [x.item() for x in losses] == [x.item() for x in rep_losses]
        assert same_trees(sh["params"], rep["params"])
        cons = tzero.make_consolidate_fn(
            port_mesh(family), port_specs(family),
            port_layout(family, sh["params"]), None, False)(sh)
        assert same_trees(cons["mu"], rep["mu"])
        assert same_trees(cons["nu"], rep["nu"])


@pytest.mark.parametrize("family", list(SHAPES))
def test_overlapped_step_is_the_replicated_step_bitwise(family):
    """Overlap on the wide mesh, float32 with clipping on: the overlapped
    step, its serialized twin and the step without overlap, bitwise."""
    rep, rep_losses, _ = run_cached(family, ttrain.TrainConfig(**KW))
    tc = ttrain.TrainConfig(**KW, overlap=True)
    for serialize in (False, True):
        ovl, losses, _ = run_cached(family, tc, serialize)
        assert [x.item() for x in losses] == [x.item() for x in rep_losses]
        assert same_state(ovl, rep)


@pytest.mark.parametrize("codec", ["int8", "bf16"])
@pytest.mark.parametrize("family", list(SHAPES))
def test_lossy_overlap_is_its_serialized_twin_with_ef(family, codec):
    """A lossy codec under overlap: the overlapped step and its twin
    bitwise after two steps, every rank's ``ef`` included (and non-zero,
    a list of the ranks' slice trees)."""
    tc = ttrain.TrainConfig(**KW, codec=codec, overlap=True)
    ovl, _, _ = run_cached(family, tc)
    twin, _, _ = run_cached(family, tc, True)
    assert same_state({k: v for k, v in ovl.items() if k != "ef"},
                      {k: v for k, v in twin.items() if k != "ef"})
    assert isinstance(ovl["ef"], list) and len(ovl["ef"]) == 8
    assert all(same_trees(a, b) for a, b in zip(ovl["ef"], twin["ef"]))
    assert any(bool(x.abs().max() > 0) for x in tree_leaves(ovl["ef"][3]))


