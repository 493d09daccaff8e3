"""The dense train step on one card.

The single-device branch of ``flextree_tpu/parallel/train.py``'s
``make_train_step``: forward, the summed cross entropy over the batch's
token count, backward, the gradient sync, global-norm clipping and an
inline AdamW (decoupled weight decay), all in float32 on the state.

The train state is the JAX package's pytree in the port's types —
``{"params", "mu", "nu", "step"}``, the moments param-shaped float32,
``step`` a 0-d int32 tensor — so it converts to and from the JAX state by
copy (:mod:`..convert`) and checkpoints in the same file format
(:mod:`..utils.checkpoint`).

The gradient sync is the seam the bucketed data-parallel sync fills, on
the FlexTree collectives of :mod:`.allreduce`: :func:`sync_grads` at
world size 1 is the identity, as the JAX sync is on a mesh of one device
(``allreduce`` returns its input for ``n <= 1``).  What needs an unported
module raises, naming its ROADMAP item: a lossy ``codec``, ``overlap``,
``shard_optimizer`` and ``autotune``, and a sync over more than one rank
(the bucketing of ``flextree_tpu/parallel/bucketing.py``).
``grad_topo``, ``bucket_bytes`` and ``grad_chunks`` shape a multi-rank
sync only and are inert here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from ..models.transformer import (
    TransformerConfig,
    cross_entropy_loss,
    forward,
    init_params,
)

__all__ = [
    "TrainConfig",
    "make_train_state",
    "init_train_state",
    "make_train_step",
    "sync_grads",
    "schedule_lr",
    "global_grad_norm",
    "clip_by_global_norm",
    "maybe_clip_grads",
    "adamw_apply",
    "tree_map",
    "tree_leaves",
]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX ``TrainConfig``, field for field (see its comments)."""

    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_topo: Any = None
    grad_clip_norm: float = 0.0
    schedule: str = "constant"
    warmup_steps: int = 0
    total_steps: int = 0
    min_lr_frac: float = 0.1
    bucket_bytes: int | None = None
    grad_chunks: int = 1
    codec: str = "f32"
    autotune: bool = False
    overlap: bool = False
    shard_optimizer: bool = False


_BUCKETED_SYNC = ("ROADMAP.md, Queue 1: 'Bucketed data-parallel sync on the "
                  "collectives'")


def _refuse_unported(train_cfg: TrainConfig) -> None:
    """Raise for a config that needs a module the port does not have yet,
    naming the ROADMAP item it waits on."""
    refusals = (
        (train_cfg.codec != "f32", f"codec={train_cfg.codec!r}",
         "'Compressed collectives and error feedback'"),
        (train_cfg.overlap, "overlap=True", "'Overlap'"),
        (train_cfg.shard_optimizer, "shard_optimizer=True", "'ZeRO-1'"),
        (train_cfg.autotune, "autotune=True",
         "'Checkpoint, supervision and feedback plumbing' (autotune)"),
    )
    for bad, what, item in refusals:
        if bad:
            raise NotImplementedError(
                f"TrainConfig {what} is not ported yet (ROADMAP.md, "
                f"Queue 1: {item})"
            )


# ------------------------------------------------------------- tree helpers


def tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of dict/list/tuple trees of one
    structure (the JAX ``jax.tree.map`` on the train-state layout)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a dict/list/tuple tree, in ``tree_map`` order."""
    out: list = []
    tree_map(out.append, tree)
    return out


# ------------------------------------------------------------------- state


def make_train_state(params: dict, train_cfg: TrainConfig | None = None
                     ) -> dict:
    """Fresh AdamW state around ``params``: zero moments and step 0 on
    the params' device."""
    if train_cfg is not None:
        _refuse_unported(train_cfg)
    dev = params["embed"].device
    return {
        "params": params,
        "mu": tree_map(torch.zeros_like, params),
        "nu": tree_map(torch.zeros_like, params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def init_train_state(cfg: TransformerConfig, generator: torch.Generator,
                     train_cfg: TrainConfig | None = None,
                     device=None) -> dict:
    """Parameters from ``init_params(cfg, generator, device)`` (default
    device ``cuda``) in a fresh AdamW state."""
    return make_train_state(init_params(cfg, generator, device=device),
                            train_cfg)


# ---------------------------------------------------------------- the step


def sync_grads(grads, world_size: int = 1):
    """The gradient sync: each leaf summed over the ranks it is
    replicated on.  At world size 1 that sum is the leaf itself, so the
    grads come back unchanged; more ranks need the bucketed sync, which is
    not ported yet."""
    if world_size > 1:
        raise NotImplementedError(
            f"gradient sync over {world_size} ranks is not ported yet "
            f"({_BUCKETED_SYNC})"
        )
    return grads


def schedule_lr(train_cfg: TrainConfig, step):
    """Learning rate at (1-based) ``step`` as a 0-d float32 tensor (on
    ``step``'s device when it is a tensor).  "constant": ``lr``.
    "warmup_cosine": linear 0 -> lr over ``warmup_steps``, then cosine
    down to ``min_lr_frac * lr`` at ``total_steps`` (flat beyond)."""
    dev = step.device if isinstance(step, torch.Tensor) else None
    if train_cfg.schedule == "constant":
        return torch.tensor(train_cfg.lr, dtype=torch.float32, device=dev)
    if train_cfg.schedule != "warmup_cosine":
        raise ValueError(f"unknown schedule {train_cfg.schedule!r}")
    if train_cfg.total_steps <= 0:
        raise ValueError("schedule='warmup_cosine' needs total_steps > 0")
    t = torch.as_tensor(step, device=dev).to(torch.float32)
    warm = float(train_cfg.warmup_steps)
    ramp = torch.clamp(t / max(warm, 1.0), max=1.0)
    span = float(max(train_cfg.total_steps - train_cfg.warmup_steps, 1))
    frac = torch.clamp((t - warm) / span, 0.0, 1.0)
    floor = float(train_cfg.min_lr_frac)
    cos = floor + (1.0 - floor) * 0.5 * (1.0 + torch.cos(math.pi * frac))
    one = torch.ones((), dtype=torch.float32, device=dev)
    return train_cfg.lr * ramp * torch.where(t <= warm, one, cos)


def global_grad_norm(grads):
    """L2 norm over every leaf, in float32 (one device holds every leaf
    whole, so no partial sums cross ranks)."""
    total = sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads))
    return torch.sqrt(total)


def clip_by_global_norm(grads, norm, clip: float):
    """Scale the tree so its global norm is at most ``clip`` (> 0)."""
    if clip <= 0:
        raise ValueError(f"clip must be positive, got {clip}")
    scale = torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads)


def maybe_clip_grads(grads, train_cfg: TrainConfig, metrics: dict):
    """When ``grad_clip_norm`` is set (must be positive), clip ``grads``
    to it and record the pre-clip norm in ``metrics['grad_norm']``."""
    if not train_cfg.grad_clip_norm:
        return grads
    if train_cfg.grad_clip_norm < 0:
        raise ValueError(
            f"grad_clip_norm must be positive, got {train_cfg.grad_clip_norm}"
        )
    norm = global_grad_norm(grads)
    metrics["grad_norm"] = norm
    return clip_by_global_norm(grads, norm, train_cfg.grad_clip_norm)


def adamw_apply(state: dict, grads, train_cfg: TrainConfig) -> dict:
    """One AdamW update; returns a new state (the input is not
    modified)."""
    step = state["step"] + 1
    t = step.to(torch.float32)
    c1 = 1.0 - train_cfg.b1 ** t
    c2 = 1.0 - train_cfg.b2 ** t
    lr = schedule_lr(train_cfg, step)
    b1, b2 = train_cfg.b1, train_cfg.b2
    mu = tree_map(lambda m, g: b1 * m + (1.0 - b1) * g, state["mu"], grads)
    nu = tree_map(lambda v, g: b2 * v + (1.0 - b2) * (g * g), state["nu"],
                  grads)

    def update(p, m, v):
        delta = (m / c1) / (torch.sqrt(v / c2) + train_cfg.eps)
        if train_cfg.weight_decay:
            delta = delta + train_cfg.weight_decay * p
        return p - lr * delta

    return {"params": tree_map(update, state["params"], mu, nu), "mu": mu,
            "nu": nu, "step": step}


def make_train_step(model_cfg: TransformerConfig,
                    train_cfg: TrainConfig = TrainConfig(), device=None):
    """The train step ``(state, tokens, targets) -> (state, metrics)`` on
    one device (default ``cuda``).

    ``tokens``/``targets``: (B, T) integer arrays or tensors.  ``metrics``:
    ``{"loss"}`` the mean token loss, plus ``{"grad_norm"}`` (pre-clip)
    when clipping is on, as 0-d float32 tensors on the device.  The step
    reads ``state`` and returns a new one."""
    from ..device import resolve_device

    _refuse_unported(train_cfg)
    if model_cfg.d_model % model_cfg.n_heads:
        raise ValueError(f"n_heads={model_cfg.n_heads} must divide "
                         f"d_model={model_cfg.d_model}")
    dev = resolve_device(device)

    def step(state, tokens, targets):
        tokens = torch.as_tensor(tokens, device=dev)
        targets = torch.as_tensor(targets, device=dev)
        with torch.enable_grad():
            params = tree_map(lambda p: p.detach().requires_grad_(),
                              state["params"])
            logits = forward(params, tokens.long(), model_cfg)
            loss_sum, _ = cross_entropy_loss(logits, targets)
            loss = loss_sum / tokens.numel()
            leaves = tree_leaves(params)
            flat = torch.autograd.grad(loss, leaves)
        it = iter(flat)
        grads = sync_grads(tree_map(lambda _: next(it), params))
        metrics = {"loss": loss.detach()}
        grads = maybe_clip_grads(grads, train_cfg, metrics)
        return adamw_apply(state, grads, train_cfg), metrics

    return step
