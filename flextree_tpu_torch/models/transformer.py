"""The dense decoder-only transformer LM, on one device or sharded.

PyTorch counterpart of ``flextree_tpu/models/transformer.py``: the config,
parameter init, RMSNorm, split-half RoPE, the attention and GELU MLP
residual halves, the tied-embedding LM head, the forward and the summed
cross-entropy loss.  Full-sequence-local attention dispatches through
:func:`..parallel.ring_attention.local_attention` by
``TransformerConfig.attn_impl``: ``"reference"`` (full matrix) or
``"flash"`` (the CUDA flash kernels).

With no axis every function is a plain single-device function.  Given a
``tp_axis`` or ``sp_axis`` (a :class:`..parallel.spmd.Axis` of an
in-process mesh, where the JAX module takes an axis name bound by
``shard_map``), it runs every rank of the mesh in lock-step: the
per-rank arguments (``layer``, ``x``, ``positions``, ``params``,
``tokens``) are lists with one entry a rank, and so are the results.

- **Tensor parallelism** over ``tp_axis``: QKV and MLP-up are
  column-parallel (each rank holds a contiguous slice of heads or hidden
  units, as :func:`param_specs` shards them), attention-out and MLP-down
  row-parallel, their partial sums combined by the FlexTree allreduce on
  the fold kernel (:func:`_tp_combine`), whose backward is the same sum of
  the cotangents.
- **Sequence parallelism** over ``sp_axis``, by ``sp_impl``:
  :func:`..parallel.ring_attention.ring_attention`,
  :func:`..parallel.zigzag.zigzag_ring_attention` or
  :func:`..parallel.ulysses.ulysses_attention`; RoPE positions are offset
  by the rank's sequence index (:func:`global_positions`).

Parameters are a plain dict in the JAX pytree's layout — ``{"embed",
"ln_f", "layers": [{"ln1", "wq", "wk", "wv", "wo", "ln2", "w1", "w2"}]}``
— with every matrix stored ``(in, out)`` so that ``h @ w`` is the product
in both packages and weights convert by copy (:mod:`..convert`).  Params
stay float32; the compute dtype is ``TransformerConfig.dtype`` (matrices
are cast at use, as the JAX module does), with normalisation, softmax and
the logits in float32.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

__all__ = [
    "TransformerConfig",
    "init_params",
    "param_specs",
    "cast_params",
    "rms_norm",
    "apply_rope",
    "attention_block",
    "layer_forward",
    "mlp_block",
    "final_logits",
    "global_positions",
    "forward",
    "cross_entropy_loss",
]

_MATRICES = ("wq", "wk", "wv", "wo", "w1", "w2")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 256
    d_model: int = 128
    n_heads: int = 8
    n_layers: int = 2
    d_ff: int = 512
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.float32  # compute dtype; params stay float32
    # topology spec of the tensor-parallel combine's allreduce (None:
    # FT_TOPO or flat)
    tp_topo: object = None
    # sequence-parallel attention: "ring", "zigzag" (the ring on the
    # load-balanced chunk-pair layout; even local length) or "ulysses"
    # (two all-to-alls; heads divisible by the sp axis size)
    sp_impl: str = "ring"
    # local attention compute: "reference" (full matrix) or "flash" (the
    # CUDA flash kernels, ops.flash_attention)
    attn_impl: str = "reference"
    # extra kwargs for the flash kernel (block_q / block_k / variant) as a
    # hashable tuple of (key, value) pairs, as in the JAX config
    attn_opts: tuple = ()

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError("d_model must be divisible by n_heads")
        return self.d_model // self.n_heads


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None) -> dict:
    """Fresh float32 parameters drawn from ``generator`` (a CPU
    ``torch.Generator``; the draws are made on the CPU, so the same seed
    gives the same weights on every device) and placed on ``device``
    (default ``cuda``).  Same shapes and scales as the JAX ``init_params``
    — not the same numbers, since ``torch`` and ``jax.random`` differ;
    to compute the JAX model's function use :func:`..convert.params_from_numpy`."""
    from ..device import resolve_device

    dev = resolve_device(device)
    d, ff = cfg.d_model, cfg.d_ff

    def dense(shape, scale):
        return (torch.randn(shape, generator=generator) * scale).to(dev)

    out_scale = 1.0 / math.sqrt(d * 2 * cfg.n_layers)
    params = {
        "embed": dense((cfg.vocab_size, d), 1.0 / math.sqrt(d)),
        "ln_f": torch.ones(d, device=dev),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "ln1": torch.ones(d, device=dev),
            "wq": dense((d, d), 1.0 / math.sqrt(d)),
            "wk": dense((d, d), 1.0 / math.sqrt(d)),
            "wv": dense((d, d), 1.0 / math.sqrt(d)),
            "wo": dense((d, d), out_scale),
            "ln2": torch.ones(d, device=dev),
            "w1": dense((d, ff), 1.0 / math.sqrt(d)),
            "w2": dense((ff, d), out_scale),
        })
    return params


def param_specs(cfg: TransformerConfig, tp_axis: str | None = "tp") -> dict:
    """The JAX ``param_specs`` in the port's spec form, a tuple of mesh-axis
    names or ``None`` a dimension (JAX's ``PartitionSpec``), in the params'
    layout: column-parallel weights name ``tp_axis`` on their output dim,
    row-parallel ones on their input dim, the rest is replicated.  The
    gradient sync reads from it which axes each leaf is replicated on."""
    t = tp_axis
    layer = {"ln1": (None,), "wq": (None, t), "wk": (None, t),
             "wv": (None, t), "wo": (t, None), "ln2": (None,),
             "w1": (None, t), "w2": (t, None)}
    return {"embed": (None, None), "ln_f": (None,),
            "layers": [dict(layer) for _ in range(cfg.n_layers)]}


def cast_params(params: dict, dtype: torch.dtype, device) -> dict:
    """The params on ``device`` with every layer matrix pre-cast to the
    compute dtype.

    Every function here casts a matrix with ``.to(cfg.dtype)`` at use,
    which returns the tensor itself when it already has that dtype — so a
    caller that runs many steps (the serving engine) casts once here and
    computes exactly the same function without re-casting each step.
    Norm scales and the embedding stay float32, as the math reads them."""
    return {
        "embed": params["embed"].to(device),
        "ln_f": params["ln_f"].to(device),
        "layers": [
            {k: v.to(device, dtype if k in _MATRICES else v.dtype)
             for k, v in layer.items()}
            for layer in params["layers"]
        ],
    }


def rms_norm(x, scale, eps: float = 1e-6):
    x32 = x.float()
    rms = torch.sqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return ((x32 / rms) * scale).to(x.dtype)


def apply_rope(x, positions, theta: float):
    """Rotary embedding on (B, T, H, Dh), split-half layout, with global
    ``positions`` — (T,) shared across the batch or (B, T) per sequence
    (the ragged decode batches of the serving path)."""
    half = x.shape[-1] // 2
    exponent = -torch.arange(half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device),
                      exponent)
    ang = positions.to(torch.float32)[..., None] * freqs  # (..., T, half)
    if ang.dim() == 2:
        ang = ang[None]  # shared positions broadcast over the batch
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rotated.to(x.dtype)


def _check_axis(a) -> None:
    from ..parallel.spmd import Axis

    if not isinstance(a, Axis):
        raise TypeError(
            f"an axis is a parallel.spmd.Axis of an in-process mesh (the "
            f"port's counterpart of a shard_map axis name), got {a!r}")


def _sharded(x, *axes) -> bool:
    """Whether a call runs every rank of a mesh: an axis is given.  Each
    axis must be a :class:`..parallel.spmd.Axis`, all of one mesh, and
    ``x`` then a list with one entry a rank of it."""
    given = [a for a in axes if a is not None]
    for a in given:
        _check_axis(a)
    if given:
        if len({a.mesh for a in given}) != 1 or \
                not isinstance(x, (list, tuple)) or len(x) != given[0].mesh.size:
            raise ValueError(
                f"with axes {given} the inputs are one entry a rank of the "
                f"axes' mesh")
        return True
    if isinstance(x, (list, tuple)):
        raise ValueError("per-rank lists need an axis")
    return False


def _tp_combine(partial, tp_axis, cfg: TransformerConfig):
    """The row-parallel partial sums, one a rank, summed over each tp group
    with the FlexTree allreduce on ``cfg.tp_topo`` (the fold kernel);
    differentiable, its backward the same allreduce of the cotangents.
    No axis: the partials as they are."""
    if tp_axis is None:
        return list(partial)
    return tp_axis.allreduce(partial, topo=cfg.tp_topo)


def _local_qkv(layer, h, cfg: TransformerConfig):
    """Q, K and V (B, T, heads, Dh) of this rank's column-parallel slice."""
    b, t = h.shape[:2]
    return tuple((h @ layer[w].to(cfg.dtype)).reshape(b, t, -1, cfg.head_dim)
                 for w in ("wq", "wk", "wv"))


def _check_attn_opts(cfg: TransformerConfig) -> dict:
    attn_opts = dict(cfg.attn_opts)
    if attn_opts and cfg.attn_impl != "flash":
        raise ValueError(
            f"attn_opts {sorted(attn_opts)} require attn_impl='flash', "
            f"got {cfg.attn_impl!r}"
        )
    return attn_opts


def _sequence_attention(q, k, v, cfg: TransformerConfig, sp_axis,
                        attn_opts: dict):
    """Every rank's causal attention by ``cfg.sp_impl`` (the JAX
    ``attention_block``'s dispatch); no ``sp_axis``: each rank's
    full-sequence-local attention."""
    from ..parallel.ring_attention import local_attention, ring_attention
    from ..parallel.ulysses import ulysses_attention
    from ..parallel.zigzag import zigzag_ring_attention

    if sp_axis is None:
        return [local_attention(a, b, c, causal=True, impl=cfg.attn_impl,
                                **attn_opts) for a, b, c in zip(q, k, v)]
    if cfg.sp_impl == "ulysses":
        # the inner attention is full-sequence-local: tuned opts apply
        return ulysses_attention(q, k, v, sp_axis, causal=True,
                                 impl=cfg.attn_impl, **attn_opts)
    if attn_opts:
        # the ring and zigzag hop kernels take no tuned config; one that
        # cannot be honoured fails rather than runs the defaults
        raise ValueError(
            f"attn_opts {sorted(attn_opts)} are not supported by "
            f"sp_impl={cfg.sp_impl!r} (only the full-sequence-local and "
            f"ulysses paths take flash kwargs)"
        )
    if cfg.sp_impl == "ring":
        return ring_attention(q, k, v, sp_axis, causal=True,
                              impl=cfg.attn_impl)
    if cfg.sp_impl == "zigzag":
        # contiguous layout at the model boundary: the RoPE positions are
        # contiguous-shard positions, so convert around the attention only
        return zigzag_ring_attention(q, k, v, sp_axis, layout="contiguous",
                                     impl=cfg.attn_impl)
    raise ValueError(f"unknown sp_impl {cfg.sp_impl!r}")


def attention_block(layer, x, positions, cfg: TransformerConfig, *,
                    tp_axis=None, sp_axis=None):
    """Pre-norm attention residual half: ``x + W_o attn(RoPE(QKV(norm
    x)))``, causal.  With no axis, one device with the attention from
    ``cfg.attn_impl``; with axes, every rank (lists), the attention by
    ``cfg.sp_impl`` over ``sp_axis`` and the row-parallel output combined
    over ``tp_axis``."""
    from ..parallel.ring_attention import local_attention
    from .generate import _qkv

    sharded = _sharded(x, tp_axis, sp_axis)
    attn_opts = _check_attn_opts(cfg)
    if not sharded:
        b, t = x.shape[:2]
        h = rms_norm(x, layer["ln1"])
        q, k, v = _qkv(layer, h, cfg)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        attn = local_attention(q, k, v, causal=True, impl=cfg.attn_impl,
                               **attn_opts)
        return x + attn.reshape(b, t, -1) @ layer["wo"].to(cfg.dtype)
    qs, ks, vs = [], [], []
    for lr, xr, pos in zip(layer, x, positions):
        q, k, v = _local_qkv(lr, rms_norm(xr, lr["ln1"]), cfg)
        qs.append(apply_rope(q, pos, cfg.rope_theta))
        ks.append(apply_rope(k, pos, cfg.rope_theta))
        vs.append(v)
    attn = _sequence_attention(qs, ks, vs, cfg, sp_axis, attn_opts)
    o = [a.reshape(*a.shape[:2], -1) @ lr["wo"].to(cfg.dtype)
         for a, lr in zip(attn, layer)]
    return [xr + c for xr, c in zip(x, _tp_combine(o, tp_axis, cfg))]


def mlp_block(layer, x, cfg: TransformerConfig, *, tp_axis=None):
    """Pre-norm GELU MLP residual half.  The GELU is the tanh
    approximation: ``jax.nn.gelu``'s default, which the JAX model uses.
    Given per-rank lists (a sharded forward), each rank's column- and
    row-parallel slice, the partials combined over ``tp_axis``."""
    if not isinstance(x, (list, tuple)):
        _sharded(x, tp_axis, None)
        h = rms_norm(x, layer["ln2"])
        u = F.gelu(h @ layer["w1"].to(cfg.dtype), approximate="tanh")
        return x + u @ layer["w2"].to(cfg.dtype)
    ys = []
    for lr, xr in zip(layer, x):
        h = rms_norm(xr, lr["ln2"])
        u = F.gelu(h @ lr["w1"].to(cfg.dtype), approximate="tanh")
        ys.append(u @ lr["w2"].to(cfg.dtype))
    return [xr + c for xr, c in zip(x, _tp_combine(ys, tp_axis, cfg))]


def layer_forward(layer, x, positions, cfg: TransformerConfig, *,
                  tp_axis=None, sp_axis=None):
    """One transformer block on hidden states ``x`` (B, T_local, d) at
    global ``positions`` (T_local,); per-rank lists with axes."""
    x = attention_block(layer, x, positions, cfg, tp_axis=tp_axis,
                        sp_axis=sp_axis)
    return mlp_block(layer, x, cfg, tp_axis=tp_axis)


def final_logits(embed, ln_f, h):
    """The LM head: final RMSNorm + tied-embedding projection to float32
    logits."""
    x = rms_norm(h, ln_f)
    return x.float() @ embed.T.float()


def global_positions(t_local: int, sp_axis=None, device=None):
    """(T_local,) global positions of a rank's sequence shard: with no
    ``sp_axis`` the whole sequence on ``device`` (the one definition
    :func:`forward` and the overlap engine share); with one, a list of
    every rank's, offset by its index along the axis times ``t_local``,
    on its own device."""
    if sp_axis is None:
        return torch.arange(t_local, device=device)
    _check_axis(sp_axis)
    return [i * t_local + torch.arange(t_local, device=dev)
            for i, dev in zip(sp_axis.index, sp_axis.mesh.devices)]


def forward(params, tokens, cfg: TransformerConfig, *, tp_axis=None,
            sp_axis=None):
    """Logits (B, T_local, vocab) float32 for ``tokens`` (B, T_local) int.

    With no axis, one device.  With axes, ``params`` and ``tokens`` are
    every rank's (lists): each rank's parameter slices
    (:func:`param_specs`) and its block of the batch and sequence; returns
    every rank's logits, replicated over ``tp_axis``."""
    if not _sharded(tokens, tp_axis, sp_axis):
        positions = global_positions(tokens.shape[1], device=tokens.device)
        x = params["embed"][tokens].to(cfg.dtype)
        for layer in params["layers"]:
            x = layer_forward(layer, x, positions, cfg)
        return final_logits(params["embed"], params["ln_f"], x)
    t_local = tokens[0].shape[1]
    positions = global_positions(t_local, sp_axis) if sp_axis is not None \
        else [torch.arange(t_local, device=t.device) for t in tokens]
    x = [p["embed"][t].to(cfg.dtype) for p, t in zip(params, tokens)]
    for i in range(len(params[0]["layers"])):
        x = layer_forward([p["layers"][i] for p in params], x, positions,
                          cfg, tp_axis=tp_axis, sp_axis=sp_axis)
    return [final_logits(p["embed"], p["ln_f"], xr)
            for p, xr in zip(params, x)]


def cross_entropy_loss(logits, targets):
    """Per-token cross entropy, summed: ``(loss_sum, token_count)``.
    Summed, not meaned, so the caller normalizes by the batch's token
    count, as the JAX train step does."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return (logz - gold).sum(), float(targets.numel())
