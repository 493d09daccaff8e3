"""The dense decoder-only transformer LM on one device.

PyTorch counterpart of ``flextree_tpu/models/transformer.py``: the config,
parameter init, RMSNorm, split-half RoPE, the attention and GELU MLP
residual halves, the tied-embedding LM head, the single-device forward
and the summed cross-entropy loss.  Attention dispatches through
:func:`..parallel.ring_attention.local_attention` by
``TransformerConfig.attn_impl``: ``"reference"`` (full matrix) or
``"flash"`` (the CUDA flash kernels).  The tensor- and sequence-parallel
axes of the JAX module wait on the port's collectives: a ``tp_axis`` or
``sp_axis`` argument raises.

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


def mlp_block(layer, x, cfg: TransformerConfig):
    """Pre-norm GELU MLP residual half.  The GELU is the tanh
    approximation: ``jax.nn.gelu``'s default, which the JAX model uses."""
    h = rms_norm(x, layer["ln2"])
    u = F.gelu(h @ layer["w1"].to(cfg.dtype), approximate="tanh")
    y = u @ layer["w2"].to(cfg.dtype)
    return x + y


def final_logits(embed, ln_f, h):
    """The LM head: final RMSNorm + tied-embedding projection to float32
    logits."""
    x = rms_norm(h, ln_f)
    return x.float() @ embed.T.float()


def _single_device(tp_axis, sp_axis) -> None:
    if tp_axis is not None or sp_axis is not None:
        raise NotImplementedError(
            f"tp_axis={tp_axis!r} / sp_axis={sp_axis!r}: tensor and "
            f"sequence parallelism are not ported yet (ROADMAP.md, Queue 1: "
            f"'Sequence, pipeline and expert parallelism')"
        )


def attention_block(layer, x, positions, cfg: TransformerConfig, *,
                    tp_axis=None, sp_axis=None):
    """Pre-norm attention residual half: ``x + W_o attn(RoPE(QKV(norm
    x)))``, causal, with the attention from ``cfg.attn_impl``."""
    from ..parallel.ring_attention import local_attention
    from .generate import _qkv

    _single_device(tp_axis, sp_axis)
    attn_opts = dict(cfg.attn_opts)
    if attn_opts and cfg.attn_impl != "flash":
        raise ValueError(
            f"attn_opts {sorted(attn_opts)} require attn_impl='flash', "
            f"got {cfg.attn_impl!r}"
        )
    b, t = x.shape[:2]
    h = rms_norm(x, layer["ln1"])
    q, k, v = _qkv(layer, h, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    attn = local_attention(q, k, v, causal=True, impl=cfg.attn_impl,
                           **attn_opts)
    return x + attn.reshape(b, t, -1) @ layer["wo"].to(cfg.dtype)


def layer_forward(layer, x, positions, cfg: TransformerConfig, *,
                  tp_axis=None, sp_axis=None):
    """One transformer block on hidden states ``x`` (B, T, d) at global
    ``positions`` (T,)."""
    x = attention_block(layer, x, positions, cfg, tp_axis=tp_axis,
                        sp_axis=sp_axis)
    return mlp_block(layer, x, cfg)


def global_positions(t_local: int, sp_axis=None, device=None):
    """(T_local,) global positions of this rank's sequence shard, on
    ``device``: the whole sequence, as no sequence axis is ported (an
    ``sp_axis`` raises).  The one definition :func:`forward` and the
    overlap engine (:mod:`..parallel.overlap`) share."""
    _single_device(None, sp_axis)
    return torch.arange(t_local, device=device)


def forward(params, tokens, cfg: TransformerConfig, *, tp_axis=None,
            sp_axis=None):
    """Logits (B, T, vocab) float32 for ``tokens`` (B, T) int on one
    device, with causal attention from ``cfg.attn_impl``."""
    _single_device(tp_axis, sp_axis)
    positions = global_positions(tokens.shape[1], sp_axis,
                                 device=tokens.device)
    x = params["embed"][tokens].to(cfg.dtype)
    for layer in params["layers"]:
        x = layer_forward(layer, x, positions, cfg)
    return final_logits(params["embed"], params["ln_f"], x)


def cross_entropy_loss(logits, targets):
    """Per-token cross entropy, summed: ``(loss_sum, token_count)``.
    Summed, not meaned, so the caller normalizes by the batch's token
    count, as the JAX train step does."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    return (logz - gold).sum(), float(targets.numel())
