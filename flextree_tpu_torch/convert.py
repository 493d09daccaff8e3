"""Weight carry-over from the JAX package.

``flextree_tpu.models.transformer.init_params`` returns a pytree of
``(in, out)``-shaped float32 arrays; the port keeps that layout, so the
conversion is a copy.  The caller turns the JAX arrays into numpy
(``jax.tree.map(np.asarray, params)``) — this module imports neither JAX
nor the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_numpy"]

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
