"""Weight and train-state carry-over from the JAX package.

``flextree_tpu.models.transformer.init_params`` returns a pytree of
``(in, out)``-shaped float32 arrays and ``parallel.train.init_train_state``
wraps it as ``{"params", "mu", "nu", "step"}`` (and ``"ef"``, param-shaped,
for a lossy codec); the port keeps both layouts, so the conversion is a
copy.  The caller turns the JAX arrays
into numpy (``jax.tree.map(np.asarray, tree)``) — this module imports
neither JAX nor the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_numpy", "train_state_from_numpy",
           "train_state_to_numpy"]

_LAYER_KEYS = ("ln1", "wq", "wk", "wv", "wo", "ln2", "w1", "w2")


def params_from_numpy(tree: dict, device=None) -> dict:
    """The port's parameter dict from the JAX ``init_params`` pytree given
    as numpy arrays, as float32 tensors on ``device`` (default ``cuda``).
    Loud on a missing or extra key: a silently dropped weight would give a
    model that runs and computes something else."""
    from .device import resolve_device

    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(dev)  # a copy

    if set(tree) != {"embed", "ln_f", "layers"}:
        raise ValueError(f"unexpected top-level keys {sorted(tree)}")
    layers = []
    for i, layer in enumerate(tree["layers"]):
        if set(layer) != set(_LAYER_KEYS):
            raise ValueError(f"layer {i}: unexpected keys {sorted(layer)}")
        layers.append({k: t(layer[k]) for k in _LAYER_KEYS})
    return {"embed": t(tree["embed"]), "ln_f": t(tree["ln_f"]),
            "layers": layers}


def train_state_from_numpy(tree: dict, device=None) -> dict:
    """The port's train state from the JAX ``init_train_state`` pytree
    (or any JAX train state of the replicated layout) given as numpy:
    params, both moments and a lossy codec's ``"ef"`` residual through
    :func:`params_from_numpy`, ``step`` a 0-d int32 tensor.  A state with
    other entries (ZeRO shards) raises: the port does not run them."""
    from .device import resolve_device

    dev = resolve_device(device)
    trees = ("params", "mu", "nu") + (("ef",) if "ef" in tree else ())
    if set(tree) != {*trees, "step"}:
        raise ValueError(
            f"expected a replicated train state with keys params, mu, nu, "
            f"step (and ef); got {sorted(tree)}"
        )
    state = {k: params_from_numpy(tree[k], dev) for k in trees}
    state["step"] = torch.tensor(int(np.asarray(tree["step"])),
                                 dtype=torch.int32, device=dev)
    return state


def train_state_to_numpy(state: dict) -> dict:
    """The port's train state as the JAX pytree of numpy arrays (host
    copies; ``step`` a 0-d int32 array)."""
    from .utils.tree import tree_map

    return tree_map(lambda t: t.detach().cpu().numpy().copy(), state)
