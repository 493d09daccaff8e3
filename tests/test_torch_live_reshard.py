"""ZeRO-1's live reshard through a shrink (the JAX package's
``tests/test_sharded.py::TestLiveReshard`` on the port).

A dp=3 ZeRO-1 run loses a rank mid-run: ``fit`` rebuilds the dp=2 step
through ``on_shrink``'s 5-tuple, and the survivors continue from the old
world's state consolidated and recarved for the new one — the live state
when no checkpoint exists, the newest checkpoint (the consolidated
layout) when one does.  Either way the run is bitwise a fresh run of the
survivor world from the consolidated state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from flextree_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
    param_specs,
)
from flextree_tpu_torch.parallel.loop import FitConfig, Supervision, fit
from flextree_tpu_torch.parallel.mesh import flat_mesh
from flextree_tpu_torch.parallel.train import (
    TrainConfig,
    init_train_state,
    make_train_step,
    tree_leaves,
    zero_layout_for,
)
from flextree_tpu_torch.parallel.zero import (
    make_consolidate_fn,
    make_reshard_fn,
)

CFG = TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2,
                        d_ff=64)
TC = TrainConfig(shard_optimizer=True)
STEPS = 5


def _world(n, grad_topo=None):
    """``(step, pack, unpack)`` of a dp=``n`` ZeRO-1 world on the CPU."""
    tc = dataclasses.replace(TC, grad_topo=grad_topo)
    mesh = flat_mesh(n, "cpu", "dp")
    pspecs = param_specs(CFG)
    shapes = init_params(CFG, torch.Generator().manual_seed(0), device="cpu")
    layout = zero_layout_for(mesh, shapes, pspecs)
    return (make_train_step(CFG, tc, device="cpu", comm=mesh),
            make_consolidate_fn(mesh, pspecs, layout, grad_topo, False),
            make_reshard_fn(mesh, pspecs, layout, grad_topo, False))


class _Data:
    def batch_at(self, step):
        tok = (np.arange(6 * 16, dtype=np.int32).reshape(6, 16) + step) % 64
        return tok, tok


def _state(n):
    return init_train_state(CFG, torch.Generator().manual_seed(0), TC,
                            device="cpu", comm=flat_mesh(n, "cpu", "dp"))


@pytest.mark.parametrize("ckpt", [False, True])
def test_shrink_reshards_for_the_survivors(ckpt, tmp_path):
    step3, pack3, unpack3 = _world(3)
    polls = {"n": 0}

    def membership():
        polls["n"] += 1
        return {0: "healthy", 1: "healthy",
                2: "dead" if polls["n"] > 2 else "healthy"}

    topos = []

    def on_shrink(n_alive, plan):
        topos.append(plan.to_ft_topo())
        step2, pack2, unpack2 = _world(n_alive, plan.to_ft_topo())
        return step2, None, None, pack2, unpack2

    ck = str(tmp_path / "ck") if ckpt else None
    res = fit(_state(3), step3, _Data(),
              FitConfig(num_steps=STEPS, ckpt_dir=ck, ckpt_every=1,
                        log_every=0, prefetch=0),
              supervision=Supervision(membership=membership,
                                      configured_world=3,
                                      on_shrink=on_shrink),
              state_pack=pack3, state_unpack=unpack3)
    assert res.steps_run == STEPS
    epochs = res.report.membership_epochs
    assert [e["alive"] for e in epochs] == [3, 2] and epochs[1]["dead"] == [2]
    at = epochs[1]["step"]
    assert at == 1 and topos == [epochs[1]["topo"]]
    # the state is the survivor world's layout: a fresh dp=2 state's shapes
    assert [t.shape for t in tree_leaves(res.state)] == \
        [t.shape for t in tree_leaves(_state(2))]

    # the reference: the old world's steps, consolidated, recarved for
    # the survivors, and their steps from there
    state = _state(3)
    for s in range(at):
        state, _ = step3(state, *_Data().batch_at(s))
    step2, _, unpack2 = _world(2, topos[0])
    state = unpack2(pack3(state))
    for s in range(at, STEPS):
        state, _ = step2(state, *_Data().batch_at(s))
    assert sorted(state) == sorted(res.state)
    for a, b in zip(tree_leaves(state), tree_leaves(res.state)):
        assert a.shape == b.shape and torch.equal(a, b)
    assert all(torch.isfinite(t).all() for t in tree_leaves(res.state))
