"""The Mixture-of-Experts transformer, with expert parallelism over ``ep``.

PyTorch counterpart of ``flextree_tpu/models/moe.py``, the JAX package's
second model family:

- **Router**: top-k gating (softmax over experts in float32, k greedy
  picks) with a static per-shard expert capacity ``C = ceil(S k
  capacity_factor / E)``; a token beyond an expert's capacity is dropped
  (combine weight 0, the residual stream carries it).  Everything is dense
  einsums over (tokens, experts, capacity) one-hots, as in the JAX module.
- **Expert parallelism**: the stacked expert weights shard their leading
  expert axis over ``ep``; dispatch is one tiled all-to-all
  (:meth:`..parallel.spmd.Axis.all_to_all`, split 0, concat 1) that sends
  each rank's capacity slots to the experts' owners, and a second brings
  the outputs back.
- **Composition**: the expert FFN's hidden dimension is over ``tp``, its
  row-parallel partials summed by the FlexTree allreduce on the fold
  kernel (:func:`.transformer._tp_combine`); attention is the dense
  model's (the sequence-parallel attentions over ``sp``), so one MoE mesh
  runs dp x ep x sp x tp.
- **Load balancing**: the Switch-style auxiliary loss ``E sum_e(
  token_frac_e prob_mass_e)`` (1.0 at perfect balance), a mean over the
  MoE layers, weighted into the train loss by ``router_aux_weight``.

Routing is greedy argmax with first-come-first-served slots (a token's
slot is the running count of earlier tokens routed to that expert), so a
sharded run equals the single-device oracle exactly when no shard exceeds
its capacity.

With no axis every function is a single-device function; with axes (each
a :class:`..parallel.spmd.Axis` of one in-process mesh) it runs every rank
in lock-step on per-rank lists, as :mod:`.transformer` does.  The expert
products are plain matrix products (the JAX package computes them outside
any Pallas kernel).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from .transformer import (
    TransformerConfig,
    _sharded,
    _tp_combine,
    attention_block,
    final_logits,
    global_positions,
    mlp_block,
    rms_norm,
)

__all__ = [
    "MoEConfig",
    "init_moe_params",
    "moe_param_specs",
    "moe_forward",
    "moe_layer",
    "route_topk",
    "expert_capacity",
]


@dataclasses.dataclass(frozen=True)
class MoEConfig(TransformerConfig):
    """The JAX ``MoEConfig``, field for field."""

    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 2.0
    # every ``moe_every``-th block has an MoE FFN (1: all); blocks count
    # from 1, so moe_every=2 makes layers 1, 3, ... MoE
    moe_every: int = 1
    router_aux_weight: float = 1e-2

    def is_moe_layer(self, i: int) -> bool:
        return (i % self.moe_every) == (self.moe_every - 1)


def expert_capacity(n_tokens: int, cfg: MoEConfig) -> int:
    """The static per-shard, per-expert capacity."""
    return max(1, math.ceil(n_tokens * cfg.top_k * cfg.capacity_factor
                            / cfg.n_experts))


def init_moe_params(cfg: MoEConfig, generator: torch.Generator,
                    device=None) -> dict:
    """Fresh float32 parameters drawn from ``generator`` (on the CPU) and
    placed on ``device`` (default ``cuda``): the JAX ``init_moe_params``'s
    shapes and scales, a dense layer's keys with ``router`` ``(d, E)``,
    ``w1e`` ``(E, d, d_ff)`` and ``w2e`` ``(E, d_ff, d)`` in place of
    ``w1``/``w2`` on each MoE layer.  Not the JAX numbers: to compute the
    JAX model's function use :func:`..convert.params_from_numpy`."""
    from ..device import resolve_device

    dev = resolve_device(device)
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts

    def dense(shape, scale):
        return (torch.randn(shape, generator=generator) * scale).to(dev)

    out_scale = 1.0 / math.sqrt(d * 2 * cfg.n_layers)
    params = {
        "embed": dense((cfg.vocab_size, d), 1.0 / math.sqrt(d)),
        "ln_f": torch.ones(d, device=dev),
        "layers": [],
    }
    for i in range(cfg.n_layers):
        layer = {
            "ln1": torch.ones(d, device=dev),
            "wq": dense((d, d), 1.0 / math.sqrt(d)),
            "wk": dense((d, d), 1.0 / math.sqrt(d)),
            "wv": dense((d, d), 1.0 / math.sqrt(d)),
            "wo": dense((d, d), out_scale),
            "ln2": torch.ones(d, device=dev),
        }
        if cfg.is_moe_layer(i):
            layer["router"] = dense((d, e), 1.0 / math.sqrt(d))
            layer["w1e"] = dense((e, d, ff), 1.0 / math.sqrt(d))
            layer["w2e"] = dense((e, ff, d), out_scale)
        else:
            layer["w1"] = dense((d, ff), 1.0 / math.sqrt(d))
            layer["w2"] = dense((ff, d), out_scale)
        params["layers"].append(layer)
    return params


def moe_param_specs(cfg: MoEConfig, tp_axis: str | None = "tp",
                    ep_axis: str | None = "ep") -> dict:
    """The JAX ``moe_param_specs`` in the port's tuple form: the expert
    leaves shard their expert axis over ``ep_axis`` and their hidden
    dimension over ``tp_axis``; the router is replicated; the rest is the
    dense model's."""
    t, e = tp_axis, ep_axis
    layers = []
    for i in range(cfg.n_layers):
        layer = {"ln1": (None,), "wq": (None, t), "wk": (None, t),
                 "wv": (None, t), "wo": (t, None), "ln2": (None,)}
        if cfg.is_moe_layer(i):
            layer.update(router=(None, None), w1e=(e, None, t),
                         w2e=(e, t, None))
        else:
            layer.update(w1=(None, t), w2=(t, None))
        layers.append(layer)
    return {"embed": (None, None), "ln_f": (None,), "layers": layers}


# ------------------------------------------------------------------ router


def route_topk(probs, k: int, capacity: int):
    """Greedy top-k routing with first-come-first-served capacity.

    ``probs``: (S, E) router probabilities.  Returns ``(dispatch,
    combine)``, each (S, E, C): ``dispatch`` in {0, 1}, token s in slot c
    of expert e; ``combine`` the normalized gate weights there.  Pick i
    routes each token to its i-th most probable expert; its slot is the
    count of earlier tokens routed to that expert at this pick and all
    earlier ones, so a dropped token still takes a position (a prefix sum,
    no compaction)."""
    s, e = probs.shape
    if k > e:
        raise ValueError(f"top_k={k} cannot exceed n_experts={e}")
    dev, dtype = probs.device, probs.dtype
    dispatch = torch.zeros((s, e, capacity), dtype=dtype, device=dev)
    gates = torch.zeros((s, e), dtype=dtype, device=dev)
    counts = torch.zeros((e,), dtype=torch.int64, device=dev)
    slots = torch.arange(capacity, device=dev)
    masked = probs
    for _ in range(k):
        sel = torch.argmax(masked, dim=-1)  # (S,), the first of equal maxima
        oh_i = F.one_hot(sel, e)  # (S, E) int64
        onehot = oh_i.to(dtype)
        pos = counts[None, :] + torch.cumsum(oh_i, dim=0) - oh_i
        pos_sel = torch.gather(pos, 1, sel[:, None])[:, 0]
        keep = (pos_sel < capacity).to(dtype)
        # a position past the capacity has an all-zero slot row, as
        # jax.nn.one_hot gives it
        slot = (pos_sel[:, None] == slots[None, :]).to(dtype)  # (S, C)
        dispatch = dispatch + (onehot[:, :, None] * slot[:, None, :]
                               * keep[:, None, None])
        gates = gates + probs * onehot * keep[:, None]
        counts = counts + oh_i.sum(dim=0)
        masked = masked * (1.0 - onehot)
    denom = gates.sum(dim=-1, keepdim=True)
    norm = gates / torch.where(denom > 0, denom, torch.ones_like(denom))
    return dispatch, dispatch * norm[:, :, None]


def _aux_loss(probs, dispatch):
    """The Switch-style load-balance loss on the local tokens, ``E
    sum_e(token_frac_e prob_mass_e)``: 1.0 at perfect balance."""
    e = probs.shape[1]
    token_frac = dispatch.sum(dim=(0, 2)) / torch.clamp(dispatch.sum(),
                                                        min=1.0)
    return e * torch.sum(token_frac * probs.mean(dim=0))


# ------------------------------------------------------------------- layer


def _dispatch(layer, x, cfg: MoEConfig):
    """One rank's routing: ``(slots (E, C, d), combine, aux)``."""
    b, t, d = x.shape
    tokens = x.reshape(b * t, d)
    probs = torch.softmax(tokens.float() @ layer["router"].float(), dim=-1)
    dispatch, combine = route_topk(probs, cfg.top_k,
                                   expert_capacity(b * t, cfg))
    aux = _aux_loss(probs, dispatch)
    slots = torch.einsum("sec,sd->ecd", dispatch.to(cfg.dtype),
                         tokens.to(cfg.dtype))
    return slots, combine, aux


def _experts(layer, slots, cfg: MoEConfig):
    """The local experts' two products (tanh GELU between) on their
    inboxes ``(E_local, C', d)``: this rank's partial over its hidden
    slice."""
    hidden = F.gelu(torch.einsum("ecd,edf->ecf", slots,
                                 layer["w1e"].to(cfg.dtype)),
                    approximate="tanh")
    return torch.einsum("ecf,efd->ecd", hidden, layer["w2e"].to(cfg.dtype))


def _combine(combine, out_slots, x):
    b, t, d = x.shape
    out = torch.einsum("sec,ecd->sd", combine.float(), out_slots.float())
    return out.reshape(b, t, d).to(x.dtype)


def moe_layer(layer, x, cfg: MoEConfig, *, tp_axis=None, ep_axis=None):
    """The MoE FFN on hidden states ``x`` (B, T_local, d): ``(out, aux)``.

    Dispatch, the all-to-all to the experts' owners over ``ep_axis``, the
    local experts (hidden over ``tp_axis``, the partials summed by the
    FlexTree allreduce on the fold kernel), the all-to-all back, and the
    float32 combine.  With no axis all experts are local and the
    all-to-alls vanish: the single-device oracle.  With axes, ``layer``,
    ``x`` and the results are lists, one entry a rank."""
    if not _sharded(x, tp_axis, ep_axis):
        slots, combine, aux = _dispatch(layer, x, cfg)
        return _combine(combine, _experts(layer, slots, cfg), x), aux
    n_ep = ep_axis.size if ep_axis is not None else 1
    if cfg.n_experts % n_ep:
        raise ValueError(f"n_experts={cfg.n_experts} must be divisible by "
                         f"ep axis size {n_ep}")
    routed = [_dispatch(lr, xr, cfg) for lr, xr in zip(layer, x)]
    slots = [r[0] for r in routed]
    if n_ep > 1:
        # (E, C, d) -> (E/n, n C, d): each rank keeps its own experts'
        # slots from every source rank
        slots = ep_axis.all_to_all(slots, split_axis=0, concat_axis=1)
    out = _tp_combine([_experts(lr, sl, cfg) for lr, sl in zip(layer, slots)],
                      tp_axis, cfg)
    if n_ep > 1:
        out = ep_axis.all_to_all(out, split_axis=1, concat_axis=0)
    return ([_combine(r[1], o, xr) for r, o, xr in zip(routed, out, x)],
            [r[2] for r in routed])


def moe_forward(params, tokens, cfg: MoEConfig, *, tp_axis=None,
                sp_axis=None, ep_axis=None):
    """``(logits, aux_mean)`` for ``tokens`` (B, T_local) int: the dense
    model's attention blocks, the FFNs dense or MoE by ``cfg.moe_every``,
    the router aux loss meaned over the MoE layers.  With axes,
    ``params`` and ``tokens`` are every rank's and so are the results."""
    if not _sharded(tokens, tp_axis, sp_axis, ep_axis):
        positions = global_positions(tokens.shape[1], device=tokens.device)
        x = params["embed"][tokens].to(cfg.dtype)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        n_moe = 0
        for i, layer in enumerate(params["layers"]):
            x = attention_block(layer, x, positions, cfg)
            if cfg.is_moe_layer(i):
                y, aux = moe_layer(layer, rms_norm(x, layer["ln2"]), cfg)
                x = x + y
                aux_total = aux_total + aux
                n_moe += 1
            else:
                x = mlp_block(layer, x, cfg)
        return (final_logits(params["embed"], params["ln_f"], x),
                aux_total / max(n_moe, 1))
    t_local = tokens[0].shape[1]
    positions = global_positions(t_local, sp_axis) if sp_axis is not None \
        else [torch.arange(t_local, device=t.device) for t in tokens]
    x = [p["embed"][t].to(cfg.dtype) for p, t in zip(params, tokens)]
    aux_total = [torch.zeros((), dtype=torch.float32, device=t.device)
                 for t in tokens]
    n_moe = 0
    lock_step = tp_axis is not None or sp_axis is not None
    for i in range(len(params[0]["layers"])):
        layer = [p["layers"][i] for p in params]
        if lock_step:
            x = attention_block(layer, x, positions, cfg, tp_axis=tp_axis,
                                sp_axis=sp_axis)
        else:  # ep alone: each rank's attention is its own
            x = [attention_block(lr, xr, pos, cfg)
                 for lr, xr, pos in zip(layer, x, positions)]
        if cfg.is_moe_layer(i):
            h = [rms_norm(xr, lr["ln2"]) for lr, xr in zip(layer, x)]
            y, aux = moe_layer(layer, h, cfg, tp_axis=tp_axis,
                               ep_axis=ep_axis)
            x = [xr + yr for xr, yr in zip(x, y)]
            aux_total = [a + b for a, b in zip(aux_total, aux)]
            n_moe += 1
        elif lock_step:
            x = mlp_block(layer, x, cfg, tp_axis=tp_axis)
        else:
            x = [mlp_block(lr, xr, cfg) for lr, xr in zip(layer, x)]
    return ([final_logits(p["embed"], p["ln_f"], xr)
             for p, xr in zip(params, x)],
            [a / max(n_moe, 1) for a in aux_total])
