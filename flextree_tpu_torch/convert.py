"""Weight and train-state carry-over from the JAX package.

``flextree_tpu.models.transformer.init_params`` returns a pytree of
``(in, out)``-shaped float32 arrays and ``parallel.train.init_train_state``
wraps it as ``{"params", "mu", "nu", "step"}`` (and ``"ef"``, param-shaped,
for a lossy codec; the MoE and pipeline steps' states are the same around
their own parameter trees), or, under ``shard_optimizer`` (ZeRO-1), as
``{"params", "step", "mu_shard", "mu_tail", "mu_rep", "nu_shard",
"nu_tail", "nu_rep"}`` (and ``"master_shard"``, ``"master_tail"``, ``"ef"``
for a lossy codec) in its host-global layout: a ``*_shard`` leaf is
``(N·M·tile,)`` float32, the block of shard position ``s`` and model
position ``m`` at slot ``s·M + m`` (``M`` the product of the sizes of the
mesh axes the leaf's own spec names; 1 on a data-parallel mesh, where rank
``r``'s block is at ``[r·tile, (r+1)·tile)``), a ``*_tail`` leaf
``(M·tail,)``, an empty slot ``(0,)``.  The port keeps these layouts (on
an in-process mesh the same host-global buffers; on a process group each
rank holds its own ``(tile,)``, as each JAX device does), so the
conversion is a copy.  A JAX state read with ``device_get`` holds each
device's per-rank buffer (``ef``, a wide mesh's shard slots) as the first
device that holds it; the port's state, after a step on a mesh, holds
``ef`` as the ranks' list, which :func:`train_state_to_numpy` assembles
the same way.  The caller turns the JAX arrays into numpy
(``jax.tree.map(np.asarray, tree)``) — this module imports neither JAX
nor the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_numpy", "train_state_from_numpy",
           "train_state_to_numpy"]

_ATTENTION_KEYS = ("ln1", "wq", "wk", "wv", "wo", "ln2")
_LAYER_KEYS = _ATTENTION_KEYS + ("w1", "w2")
_MOE_LAYER_KEYS = _ATTENTION_KEYS + ("router", "w1e", "w2e")


def params_from_numpy(tree: dict, device=None) -> dict:
    """The port's parameter dict from a JAX parameter pytree given as
    numpy arrays, as float32 tensors on ``device`` (default ``cuda``): the
    dense ``init_params`` tree, the MoE ``init_moe_params`` tree (a layer
    has the dense FFN's ``w1``/``w2`` or the MoE FFN's ``router``, ``w1e``
    and ``w2e``), or the pipeline's stacked tree (``layers`` one dict of
    ``(L, ...)`` leaves, ``stack_layer_params``).  Loud on a missing or
    extra key: a silently dropped weight would give a model that runs and
    computes something else."""
    from .device import resolve_device

    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(dev)  # a copy

    def layer_of(i, layer):
        keys = next((k for k in (_LAYER_KEYS, _MOE_LAYER_KEYS)
                     if set(layer) == set(k)), None)
        if keys is None:
            raise ValueError(f"layer {i}: unexpected keys {sorted(layer)}; "
                             f"want {list(_LAYER_KEYS)} or "
                             f"{list(_MOE_LAYER_KEYS)}")
        return {k: t(layer[k]) for k in keys}

    if set(tree) != {"embed", "ln_f", "layers"}:
        raise ValueError(f"unexpected top-level keys {sorted(tree)}")
    layers = tree["layers"]
    if isinstance(layers, dict):  # the stacked pipeline layout
        layers = layer_of("stack", layers)
    else:
        layers = [layer_of(i, layer) for i, layer in enumerate(layers)]
    return {"embed": t(tree["embed"]), "ln_f": t(tree["ln_f"]),
            "layers": layers}


_SHARDED_KEYS = ("mu_shard", "mu_tail", "mu_rep", "nu_shard", "nu_tail",
                 "nu_rep")
_MASTER_KEYS = ("master_shard", "master_tail")


def train_state_from_numpy(tree: dict, device=None) -> dict:
    """The port's train state from a JAX train state pytree given as numpy
    (``init_train_state``'s, replicated or sharded, see the module
    docstring): every tree through :func:`params_from_numpy` (a shard
    leaf keeps its 1-D shape), ``step`` a 0-d int32 tensor.  A state with
    keys of neither layout raises."""
    from .device import resolve_device

    dev = resolve_device(device)
    ef = ("ef",) if "ef" in tree else ()
    layouts = [("params", "mu", "nu") + ef,
               ("params",) + _SHARDED_KEYS + ef,
               ("params",) + _SHARDED_KEYS + _MASTER_KEYS + ef]
    trees = next((k for k in layouts if set(tree) == {*k, "step"}), None)
    if trees is None:
        raise ValueError(
            f"expected a train state with keys params, mu, nu, step (and "
            f"ef), or the sharded params, step, {', '.join(_SHARDED_KEYS)} "
            f"(and {', '.join(_MASTER_KEYS)}, ef); got {sorted(tree)}"
        )
    state = {k: params_from_numpy(tree[k], dev) for k in trees}
    state["step"] = torch.tensor(int(np.asarray(tree["step"])),
                                 dtype=torch.int32, device=dev)
    return state


def train_state_to_numpy(state: dict, pspecs=None, comm=None) -> dict:
    """The port's train state as the JAX pytree of numpy arrays (host
    copies; ``step`` a 0-d int32 array).  A residual held as the ranks'
    list (after a step on a mesh) becomes one tree, each slice from the
    first rank that holds it, as the JAX ``device_get`` reads it: give the
    step's ``pspecs`` and mesh ``comm`` for a mesh whose ranks hold
    slices (:func:`.parallel.zero.checkpoint_ef`)."""
    from .parallel.zero import checkpoint_ef
    from .utils.tree import tree_map

    if isinstance(state.get("ef"), list):
        state = dict(state, ef=checkpoint_ef(state["ef"], pspecs, comm))
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), state)
