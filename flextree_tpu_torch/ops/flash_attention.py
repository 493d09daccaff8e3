"""Fused causal flash attention, forward and backward.

PyTorch counterpart of ``flextree_tpu/ops/pallas_attention.py``.  Queries
``(B, Tq, H, D)`` attend over keys/values ``(B, Tk, H, D)`` with causality
by global position (``q_offset``/``k_offset`` place the two blocks on one
axis), an online softmax in the exp2 domain and, for backward, the per-row
logsumexp, so neither direction materializes the ``(Tq, Tk)`` score
matrix.  Three functions carry the work, each a hand-written CUDA kernel
beside its plain PyTorch version:

- :func:`flash_fwd` — out and lse (``csrc/flash_fwd.cu``; replaces the
  Pallas ``_flash_kernel`` and ``_flash_kernel_kvgrid``);
- :func:`flash_bwd_dq` — dq (``csrc/flash_bwd_dq.cu``; replaces
  ``_flash_bwd_dq_kernel``);
- :func:`flash_bwd_dkv` — dk and dv (``csrc/flash_bwd_dkv.cu``; replaces
  ``_flash_bwd_dkv_kernel``).

On a CUDA tensor each launches its kernel or raises; on a CPU tensor it
computes its plain version (:func:`flash_fwd_plain`,
:func:`flash_bwd_dq_plain`, :func:`flash_bwd_dkv_plain`), which forms the
full matrices — the only reason it ever does.  Two autograd Functions wire
them together as the JAX module's two ``custom_vjp`` cores: one returns
the output, one also a differentiable lse.

Numerics follow the TPU kernels, which bf16 parity depends on:

- q is pre-scaled by ``scale * log2(e)`` in q's own dtype (the constant
  rounded to that dtype too, as JAX rounds a weakly typed Python scalar);
  the dk/dv kernel puts the pre-scale on k instead, since q appears raw in
  ``ds^T q``;
- probabilities drop to v's dtype before ``p @ v``, each taken against
  the running max of the online softmax after its key tile — the plain
  forward rounds them at the same points (:func:`_tile_rounded`), so a
  bf16 comparison sees the kernel's own rounding; in dq, ds is cast to
  k's dtype, in dk to q's; dv takes ``p`` in float32, because the JAX
  kernel reads ``do`` as float32 and casts ``p`` to that;
- ``do`` and ``o`` are read as float32 for ``delta = rowsum(do * o)``;
  every product accumulates in float32;
- a row that sees no key gives exactly 0 and the lse sentinel ``+1e30``
  inside (so the backward's ``exp2(s - lse)`` is exactly 0 and its
  gradients are exactly 0); the public lse of :func:`flash_attention`
  turns the sentinel into ``-1e30`` ("no mass").

``block_q``/``block_k`` keep the JAX meaning for validation
(:func:`_blocks`); the CUDA kernels choose their own tiles (64 rows by 64
keys; in bfloat16 all three run on the tensor cores, in float32 on the
float32 cores), and the plain versions use only the
forward's key tile, :data:`KERNEL_TILE_K`, for where p is rounded.  ``variant`` is
validated as in JAX; its three values are schedules of identical math on
the TPU, and on Hopper all three run the one forward kernel.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = [
    "VARIANTS",
    "attention_with_offsets",
    "flash_attention",
    "flash_fwd",
    "flash_bwd_dq",
    "flash_bwd_dkv",
    "flash_fwd_plain",
    "flash_bwd_dq_plain",
    "flash_bwd_dkv_plain",
]

_NEG_INF = -1e30
_LOG2E = 1.4426950408889634
_LN2 = 0.6931471805599453  # 1 / log2(e), the lse's base change

#: Forward k-walk schedules of the JAX module; one kernel here.
VARIANTS = ("loop", "pipelined", "kvgrid")
DEFAULT_FWD_VARIANT = "loop"

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: Keys per tile of the forward kernels' walk (``kRows`` in
#: ``csrc/flash_common.cuh``, the k/v tile of both the float32 and the
#: bfloat16 kernel): where the online softmax rounds p.
KERNEL_TILE_K = 64
#: Largest head dim the kernels take (any multiple of 8 up to it).
KERNEL_MAX_HEAD_DIM = 128
_MAX_GRID_Y = 65535  # B * H rides the grid's y axis


def attention_with_offsets(q, k, v, *, causal: bool, scale: float,
                           q_offset=0, k_offset=0):
    """Full-matrix oracle on ``(BH, Tq, D)`` / ``(BH, Tk, D)`` with
    positional causal masking (the JAX module's A/B reference)."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        mask = _visible(q.shape[1], k.shape[1], q_offset, k_offset, q.device)
        s = s.masked_fill(~mask, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    if causal:
        p = p.masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bqk,bkd->bqd", p, v.float())
    out = torch.where(l > 0, out / torch.where(l > 0, l, 1.0), 0.0)
    return out.to(q.dtype)


def _blocks(tq: int, tk: int, block_q: int, block_k: int):
    """Resolved ``(bq, bk, tq_pad, tk_pad)`` of the JAX kernels: each
    block clamped to its sequence and rounded up to a multiple of 8, each
    sequence padded to a whole number of blocks."""
    if block_q <= 0 or block_k <= 0:
        raise ValueError(
            f"block_q and block_k must be positive, got {block_q}, {block_k}"
        )
    bq = -(-min(block_q, max(tq, 8)) // 8) * 8
    bk = -(-min(block_k, max(tk, 8)) // 8) * 8
    return bq, bk, -(-tq // bq) * bq, -(-tk // bk) * bk


def _visible(tq, tk, q_offset, k_offset, device):
    """(Tq, Tk) causal visibility by global position."""
    qpos = q_offset + torch.arange(tq, device=device)
    kpos = k_offset + torch.arange(tk, device=device)
    return qpos[:, None] >= kpos[None, :]


def _prescaled(x, scale: float):
    """``x * (scale * log2 e)`` in x's dtype, the constant rounded to it."""
    c = torch.tensor(scale * _LOG2E, dtype=torch.float32, device=x.device)
    return x * c.to(x.dtype)


def _probs(s, lse, causal, q_offset, k_offset):
    """``exp2(s - lse * log2 e)`` on log2-domain scores (B, H, Tq, Tk),
    exactly 0 where masked; lse (B, H, Tq)."""
    p = torch.exp2(s - (lse * _LOG2E)[..., None])
    if causal:
        mask = _visible(s.shape[2], s.shape[3], q_offset, k_offset, s.device)
        p = p.masked_fill(~mask, 0.0)
    return p


def _ds(p, v, o, do, glse):
    """``ds = p * (dp - delta + glse)`` with ``dp = do @ v^T`` and
    ``delta = rowsum(do * o)``, all float32; (B, H, Tq, Tk)."""
    dof = do.float()
    delta = (dof * o.float()).sum(dim=-1).transpose(1, 2)  # (B, H, Tq)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, v.float())
    g = dp - delta[..., None]
    if glse is not None:
        g = g + glse[..., None]
    return p * g


def _tile_rounded(s, m, p, dtype):
    """The p of ``p @ v`` as the forward kernel forms it: each key's
    ``exp2(s - m_t)`` rounded to ``dtype``, where ``m_t`` is the running
    max after the key's :data:`KERNEL_TILE_K`-key tile, then carried to
    the row max ``m`` (the kernel's rescaling of its accumulator).  On
    log2-domain scores (B, H, Tq, Tk); 0 where ``p`` is 0."""
    tk = s.shape[-1]
    n_tiles = -(-tk // KERNEL_TILE_K)
    tiles = torch.nn.functional.pad(s, (0, n_tiles * KERNEL_TILE_K - tk),
                                    value=_NEG_INF)
    m_t = tiles.unflatten(-1, (n_tiles, KERNEL_TILE_K)).amax(dim=-1)
    m_t = m_t.cummax(dim=-1).values.repeat_interleave(
        KERNEL_TILE_K, dim=-1)[..., :tk]
    rounded = torch.exp2(s - m_t).to(dtype).float()
    return torch.where(p > 0, rounded * torch.exp2(m_t - m[..., None]), 0.0)


def flash_fwd_plain(q, k, v, *, causal: bool, scale: float, q_offset=0,
                    k_offset=0):
    """The forward kernel's function from full matrices: ``(out, lse)``,
    out ``(B, Tq, H, D)`` in q's dtype and lse ``(B, H, Tq)`` float32 in
    natural-log units with ``+1e30`` for rows that see no key."""
    s = torch.einsum("bqhd,bkhd->bhqk", _prescaled(q, scale).float(),
                     k.float())
    if causal:
        mask = _visible(q.shape[1], k.shape[1], q_offset, k_offset, q.device)
        s = s.masked_fill(~mask, _NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp2(s - m[..., None])
    if causal:
        p = p.masked_fill(~mask, 0.0)
    l = p.sum(dim=-1)  # (B, H, Tq)
    pv = p if v.dtype == torch.float32 else _tile_rounded(s, m, p, v.dtype)
    acc = torch.einsum("bhqk,bkhd->bqhd", pv, v.float())
    lt = l.transpose(1, 2)[..., None]  # (B, Tq, H, 1)
    out = torch.where(lt > 0, acc / torch.where(lt > 0, lt, 1.0), 0.0)
    lse = torch.where(l > 0, (m + torch.log2(l.clamp_min(1e-38))) * _LN2,
                      -_NEG_INF)
    return out.to(q.dtype), lse


def flash_bwd_dq_plain(q, k, v, o, do, lse, glse=None, *, causal: bool,
                       scale: float, q_offset=0, k_offset=0):
    """The dq kernel's function from full matrices: dq ``(B, Tq, H, D)``
    in q's dtype from the forward's ``o``, its cotangent ``do``, the
    internal lse ``(B, H, Tq)`` and the lse cotangent ``glse`` (or
    None)."""
    s = torch.einsum("bqhd,bkhd->bhqk", _prescaled(q, scale).float(),
                     k.float())
    p = _probs(s, lse, causal, q_offset, k_offset)
    ds = _ds(p, v, o, do, glse)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    return (dq * scale).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, o, do, lse, glse=None, *, causal: bool,
                        scale: float, q_offset=0, k_offset=0):
    """The dk/dv kernel's function from full matrices: ``(dk, dv)``, each
    ``(B, Tk, H, D)`` in k's and v's dtypes."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     _prescaled(k, scale).float())
    p = _probs(s, lse, causal, q_offset, k_offset)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    ds = _ds(p, v, o, do, glse)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    return (dk * scale).to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------------ kernels


def _check_kernel_inputs(name, q, k, v, *rest):
    """What every flash kernel takes: CUDA tensors on one device, q/k/v
    (and o/do) of one dtype in float32 or bfloat16, contiguous
    ``(B, T, H, D)`` with matching B, H, D, and D a multiple of 8 up to
    :data:`KERNEL_MAX_HEAD_DIM`."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name} kernel runs on CUDA tensors, got {dev}")
    tensors = (q, k, v, *rest)
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: every input must be on one device")
    if q.dtype not in _KERNEL_DTYPES or any(t.dtype != q.dtype
                                            for t in tensors):
        raise TypeError(
            f"{name} kernel takes float32 or bfloat16 inputs of one dtype; "
            f"got {[str(t.dtype) for t in tensors]}"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} kernel needs contiguous inputs")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[2:] != q.shape[2:]:
        raise ValueError(
            f"{name}: q {tuple(q.shape)} and k {tuple(k.shape)} differ in "
            f"batch, heads or head dim"
        )
    if d % 8 or not 0 < d <= KERNEL_MAX_HEAD_DIM:
        raise ValueError(
            f"{name} kernel takes a head dim that is a multiple of 8 up to "
            f"{KERNEL_MAX_HEAD_DIM}, got {d}"
        )
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"{name} kernel takes B*H <= {_MAX_GRID_Y}, "
                         f"got {b * h}")


def _check_aligned(name, *tensors):
    """The bfloat16 kernels copy their inputs 16 bytes at a time with
    ``cp.async``, which needs 16-byte-aligned sources: rows are
    ``H * D * 2`` bytes apart (a multiple of 16), but a contiguous view
    may start anywhere."""
    if tensors[0].dtype != torch.bfloat16:
        return
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(
                f"{name} kernel reads bfloat16 inputs 16 bytes at a time; "
                f"got one that starts at {t.data_ptr() % 16} bytes past a "
                f"16-byte boundary (copy it with .clone())"
            )


def _check_rows(name, t, q):
    """lse and its cotangent: contiguous float32 (B, H, Tq) on q's
    device."""
    shape = (q.shape[0], q.shape[2], q.shape[1])
    if (t.device != q.device or t.dtype != torch.float32
            or tuple(t.shape) != shape or not t.is_contiguous()):
        raise ValueError(
            f"{name}: expected a contiguous float32 {shape} tensor on "
            f"{q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
        )


def _call(name, fn, *args):
    """Launch on the current stream of the inputs' device; raise on a
    CUDA error from the C entry point."""
    dev = args[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                  for a in args]
        rc = fn(*c_args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def flash_fwd(q, k, v, *, causal: bool, scale: float, q_offset=0,
              k_offset=0, return_lse: bool = True):
    """``(out, lse)`` of :func:`flash_fwd_plain` (lse None unless
    ``return_lse``).  On a CUDA tensor launches ``csrc/flash_fwd.cu``
    (counted in ``flash_fwd.launches``), which writes the lse only when
    asked; on a CPU tensor computes the plain version.

    The kernel replaces ``_flash_kernel`` (``pallas_attention.py:79``)
    and ``_flash_kernel_kvgrid`` (``:212``).  Bound: at the training
    shape its least time is its ~34 MB over the memory rate (~0.010 ms on
    an H100; its 8.6 GFLOP take ~0.009 ms at the bf16 tensor-core rate).
    Design: one CTA per 64 query rows of one (b, h), the online softmax
    carried in registers across 64-key k/v tiles up to the causal bound.
    In bfloat16 the products run on the tensor cores (``mma.sync`` with
    ``ldmatrix`` operands, k/v tiles through a two-stage ``cp.async``
    ring, p passed from the score registers into ``p @ v``); each input
    must start on a 16-byte boundary, or this raises.  In float32 they run
    on the float32 cores, which keep the JAX package's float32 bars (the
    source's note)."""
    if q.device.type == "cpu":
        out, lse = flash_fwd_plain(q, k, v, causal=causal, scale=scale,
                                   q_offset=q_offset, k_offset=k_offset)
        return out, (lse if return_lse else None)
    _check_kernel_inputs("flash_fwd", q, k, v)
    if k.shape != v.shape:
        raise ValueError(f"k/v shapes differ: {k.shape} vs {v.shape}")
    _check_aligned("flash_fwd", q, k, v)
    from ..kernels import load

    b, tq, h, d = q.shape
    tk = k.shape[1]
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if b * h * tq == 0:
        if lse is not None:
            lse.fill_(-_NEG_INF)
        return out, lse
    _call("flash_fwd", load("flash_fwd").ft_flash_fwd,
          q, k, v, out, lse, b, h, tq, tk, d,
          ctypes.c_float(scale * _LOG2E), int(causal), int(q_offset),
          int(k_offset), _KERNEL_DTYPES[q.dtype])
    flash_fwd.launches += 1
    return out, lse


def _bwd_checks(name, q, k, v, o, do, lse, glse):
    _check_kernel_inputs(name, q, k, v, o, do)
    if k.shape != v.shape or o.shape != q.shape or do.shape != q.shape:
        raise ValueError(
            f"{name}: expected k == v and q == o == do shapes, got "
            f"{[tuple(t.shape) for t in (q, k, v, o, do)]}"
        )
    _check_rows(name, lse, q)
    if glse is not None:
        _check_rows(name, glse, q)


def flash_bwd_dq(q, k, v, o, do, lse, glse=None, *, causal: bool,
                 scale: float, q_offset=0, k_offset=0):
    """dq of :func:`flash_bwd_dq_plain`.  On a CUDA tensor launches
    ``csrc/flash_bwd_dq.cu`` (counted in ``flash_bwd_dq.launches``); on a
    CPU tensor computes the plain version.

    The kernel replaces ``_flash_bwd_dq_kernel``
    (``pallas_attention.py:524``).  Bound: at the training shape ~50 MB
    over the memory rate (~0.015 ms on an H100).  Design: one CTA per 64
    query rows, p recomputed tile by tile from the lse, dq in registers.
    In bfloat16 the three products run on the tensor cores (``mma.sync``;
    q and do held as fragments, k/v through a two-stage ``cp.async``
    ring, ds rounded once and multiplied with k through
    ``ldmatrix.trans``); each input must start on a 16-byte boundary, or
    this raises.  In float32 they run on the float32 cores (the source's
    note)."""
    kw = dict(causal=causal, scale=scale, q_offset=q_offset,
              k_offset=k_offset)
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, o, do, lse, glse, **kw)
    _bwd_checks("flash_bwd_dq", q, k, v, o, do, lse, glse)
    _check_aligned("flash_bwd_dq", q, k, v, o, do)
    from ..kernels import load

    b, tq, h, d = q.shape
    dq = torch.empty_like(q)
    if b * h * tq == 0:
        return dq
    _call("flash_bwd_dq", load("flash_bwd_dq").ft_flash_bwd_dq,
          q, k, v, o, do, lse, glse, dq, b, h, tq, k.shape[1],
          d, ctypes.c_float(scale * _LOG2E), ctypes.c_float(scale),
          int(causal), int(q_offset), int(k_offset), _KERNEL_DTYPES[q.dtype])
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, o, do, lse, glse=None, *, causal: bool,
                  scale: float, q_offset=0, k_offset=0):
    """``(dk, dv)`` of :func:`flash_bwd_dkv_plain`.  On a CUDA tensor
    launches ``csrc/flash_bwd_dkv.cu`` (counted in
    ``flash_bwd_dkv.launches``); on a CPU tensor computes the plain
    version.

    The kernel replaces ``_flash_bwd_dkv_kernel``
    (``pallas_attention.py:601``).  Bound: at the training shape ~59 MB
    over the memory rate (~0.018 ms on an H100).  Design: one CTA per 64
    key rows, walking the query tiles from the causal bound, dk and dv in
    registers.  In bfloat16 the four products run on the tensor cores
    (``mma.sync``; q, do, o and the row vectors through a two-stage
    ``cp.async`` ring), with p entering dv as three bf16 terms, which
    are float32 p exactly; each input must start on a 16-byte boundary,
    or this raises.  In float32 they run on the float32 cores (the source's
    note)."""
    kw = dict(causal=causal, scale=scale, q_offset=q_offset,
              k_offset=k_offset)
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, o, do, lse, glse, **kw)
    _bwd_checks("flash_bwd_dkv", q, k, v, o, do, lse, glse)
    _check_aligned("flash_bwd_dkv", q, k, v, o, do)
    from ..kernels import load

    b, tk, h, d = k.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if b * h * tk == 0:
        return dk, dv
    if q.shape[1] == 0:
        return dk.zero_(), dv.zero_()
    _call("flash_bwd_dkv", load("flash_bwd_dkv").ft_flash_bwd_dkv,
          q, k, v, o, do, lse, glse, dk, dv, b, h, q.shape[1],
          tk, d, ctypes.c_float(scale * _LOG2E), ctypes.c_float(scale),
          int(causal), int(q_offset), int(k_offset), _KERNEL_DTYPES[q.dtype])
    flash_bwd_dkv.launches += 1
    return dk, dv


#: Kernel launches since each count was last reset (set it to 0 to reset).
flash_fwd.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


# ----------------------------------------------------------------- autograd


def _backward(ctx, g, glse):
    q, k, v, out, lse = ctx.saved_tensors
    kw = ctx.kw
    g = g.contiguous()
    dq = flash_bwd_dq(q, k, v, out, g, lse, glse, **kw)
    dk, dv = flash_bwd_dkv(q, k, v, out, g, lse, glse, **kw)
    return dq, dk, dv, None, None, None, None


class _FlashCore(torch.autograd.Function):
    """``_flash_attention_core``: the output only.  The forward writes the
    lse only when an input needs a gradient (the backward's residual)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset, k_offset):
        ctx.kw = dict(causal=causal, scale=scale, q_offset=q_offset,
                      k_offset=k_offset)
        need = any(ctx.needs_input_grad[:3])
        out, lse = flash_fwd(q, k, v, return_lse=need, **ctx.kw)
        if need:
            ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        return _backward(ctx, g, None)


class _FlashLseCore(torch.autograd.Function):
    """``_flash_attention_lse_core``: ``(out, lse)`` with a differentiable
    lse in its public form, ``(B, Tq, H)`` float32 with ``-1e30`` for
    rows that see no key; its cotangent flows into both backward kernels
    in the internal ``(B, H, Tq)`` layout."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, q_offset, k_offset):
        ctx.kw = dict(causal=causal, scale=scale, q_offset=q_offset,
                      k_offset=k_offset)
        out, lse = flash_fwd(q, k, v, return_lse=True, **ctx.kw)
        ctx.save_for_backward(q, k, v, out, lse)
        public = lse.transpose(1, 2)
        return out, torch.where(public >= -_NEG_INF, _NEG_INF, public)

    @staticmethod
    def backward(ctx, g_out, g_lse):
        glse = g_lse.transpose(1, 2).float().contiguous()
        return _backward(ctx, g_out, glse)


def flash_attention(q, k, v, *, causal: bool = True, scale: float | None = None,
                    q_offset: int = 0, k_offset: int = 0, block_q: int = 256,
                    block_k: int = 512, return_lse: bool = False,
                    variant: str | None = None):
    """Fused attention on ``(B, Tq, H, D)`` queries and ``(B, Tk, H, D)``
    keys/values, differentiable in q, k and v.

    Same contract as the JAX ``flash_attention``: the output in q's dtype,
    causality by global position (``q_offset``/``k_offset``), and with
    ``return_lse=True`` also the per-row logsumexp of the masked scores,
    ``(B, Tq, H)`` float32 with ``-1e30`` for rows that see no key —
    differentiable, as blockwise consumers merging partial attentions
    need.  ``block_q``/``block_k`` are validated with the JAX geometry
    rules; the CUDA kernels tile for themselves.  ``variant`` is one of
    :data:`VARIANTS` (default ``"loop"``): the TPU's forward schedules,
    numerically identical, all one kernel here."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"expected (B, T, H, D) inputs, got {tuple(q.shape)}")
    if k.shape != v.shape:
        raise ValueError(f"k/v shapes differ: {tuple(k.shape)} vs "
                         f"{tuple(v.shape)}")
    variant = DEFAULT_FWD_VARIANT if variant is None else str(variant)
    if variant not in VARIANTS:
        raise ValueError(f"unknown flash variant {variant!r}")
    _blocks(q.shape[1], k.shape[1], int(block_q), int(block_k))
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    core = _FlashLseCore if return_lse else _FlashCore
    return core.apply(q, k, v, bool(causal), float(scale), int(q_offset),
                      int(k_offset))
