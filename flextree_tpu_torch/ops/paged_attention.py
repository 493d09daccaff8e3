"""Paged decode attention: one new token per slot over a block-paged cache.

PyTorch counterpart of ``flextree_tpu/ops/paged_attention.py``.  Per slot
``s`` and head ``h`` the function attends the slot's query over the pool
positions ``< lengths[s]`` (reached through the slot's block-table row)
plus the new token's K/V at position ``lengths[s]``.  Three versions, one
contract:

- :func:`paged_attention_gather` — the oracle: gather every table block
  into a contiguous ``(S, P*bs, H, D)`` view, splice the new token in and
  attend with the full-row softmax (``models.generate.cached_attention``);
- :func:`paged_attention_stream` — the plain streaming twin of the JAX
  module's ``_stream_jnp`` at ``block_chunk=1``: walk the table one block
  at a time with an online softmax, batched over all slots, stopping at
  the batch's causal frontier;
- :func:`paged_attention` — the wrapper the serving path calls.  On a CUDA
  tensor it launches the hand-written kernel ``csrc/paged_attention.cu``
  (which replaces the Pallas ``_paged_kernel``) or raises; on a CPU tensor
  it computes the plain stream, the only reason it ever does.

The streamed versions differ from the oracle only in float summation
order, so they are held to it within :data:`FUSED_DECODE_ATOL` (float32),
not bitwise.  Masking follows ``cached_attention``: a position at or past
a row's length gets score ``-1e30`` before the running max and
probability exactly 0.0 after it, so whatever an unwritten or null block
holds contributes nothing — and the kernel never even loads it.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..models.generate import cached_attention

__all__ = [
    "FUSED_DECODE_ATOL",
    "paged_attention",
    "paged_attention_gather",
    "paged_attention_stream",
]

_NEG_INF = -1e30

#: Tolerance of the streamed versions against the gather oracle on the
#: attention output (float32 compute): they differ only in summation
#: order, which moves the output by ~1e-7; a masking or indexing defect
#: moves it by O(1).
FUSED_DECODE_ATOL = 2e-5

#: Head dims the CUDA kernel is instantiated for (one warp per 32 dims).
KERNEL_HEAD_DIMS = (32, 64, 128, 256)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check_shapes(q, k_new, v_new, k_pool, v_pool, tables, lengths):
    if q.dim() != 3:
        raise ValueError(f"expected (S, H, D) queries, got {tuple(q.shape)}")
    if k_new.shape != q.shape or v_new.shape != q.shape:
        raise ValueError(
            f"new-token K/V must match q's shape {tuple(q.shape)}, got "
            f"{tuple(k_new.shape)} / {tuple(v_new.shape)}"
        )
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(
            f"expected matching (N, bs, H, D) pools, got "
            f"{tuple(k_pool.shape)} vs {tuple(v_pool.shape)}"
        )
    if k_pool.shape[2:] != q.shape[1:]:
        raise ValueError(
            f"pool head/dim {tuple(k_pool.shape[2:])} != query "
            f"{tuple(q.shape[1:])}"
        )
    if tables.dim() != 2 or tables.shape[0] != q.shape[0]:
        raise ValueError(f"expected (S, P) tables, got {tuple(tables.shape)}")
    if tuple(lengths.shape) != (q.shape[0],):
        raise ValueError(f"expected (S,) lengths, got {tuple(lengths.shape)}")


def paged_attention_gather(q, k_new, v_new, k_pool, v_pool, tables, lengths):
    """The gather-materialize oracle: gather every table block into a
    contiguous ``(S, P*bs, H, D)`` view, splice the new token's K/V at
    each row's ``length`` (clamped to the last position, as JAX's
    ``dynamic_update_slice`` clamps), and attend with
    ``cached_attention`` over the whole view."""
    _check_shapes(q, k_new, v_new, k_pool, v_pool, tables, lengths)
    s = q.shape[0]
    idx = tables.long()
    kc = k_pool[idx].reshape(s, -1, *k_pool.shape[2:])
    vc = v_pool[idx].reshape(s, -1, *v_pool.shape[2:])
    rows = torch.arange(s, device=q.device)
    at = lengths.long().clamp(max=kc.shape[1] - 1)
    kc[rows, at] = k_new
    vc[rows, at] = v_new
    return cached_attention(q[:, None], kc, vc, lengths.long()[:, None])[:, 0]


def paged_attention_stream(q, k_new, v_new, k_pool, v_pool, tables, lengths,
                           scale: float):
    """The plain streaming version: one table column per step over all
    slots, online softmax in float32, scores in the compute dtype then
    float32 — the same order of operations the CUDA kernel follows."""
    s, h, d = q.shape
    bs = k_pool.shape[1]
    idx = tables.long()
    lengths_b = lengths.long()[:, None]  # (S, 1)
    frontier = min(tables.shape[1],
                   -(-int(lengths.max()) // bs) if s else 0)
    m = torch.full((s, h), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((s, h), dtype=torch.float32, device=q.device)
    acc = torch.zeros((s, h, d), dtype=torch.float32, device=q.device)
    offsets = torch.arange(bs, device=q.device)
    for i in range(frontier):
        kb = k_pool[idx[:, i]]  # (S, bs, H, D)
        vb = v_pool[idx[:, i]]
        sc = torch.einsum("shd,sbhd->shb", q, kb).float() * scale
        valid = (i * bs + offsets)[None, :] < lengths_b  # (S, bs)
        sc = sc.masked_fill(~valid[:, None, :], _NEG_INF)
        m_new = torch.maximum(m, sc.amax(dim=-1))
        pr = torch.exp(sc - m_new[..., None])
        # explicit zero: while a row's m is still the -1e30 sentinel,
        # exp(0) = 1 would leak masked content
        pr = pr.masked_fill(~valid[:, None, :], 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + pr.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("shb,sbhd->shd", pr,
                                                   vb.float())
        m = m_new
    # the new token's K/V — position `length`, always visible to itself
    s_new = torch.einsum("shd,shd->sh", q, k_new).float() * scale
    m_fin = torch.maximum(m, s_new)
    p_new = torch.exp(s_new - m_fin)
    corr = torch.exp(m - m_fin)
    l = l * corr + p_new
    acc = acc * corr[..., None] + p_new[..., None] * v_new.float()
    return (acc / l[..., None]).to(q.dtype)


def _launch(q, k_new, v_new, k_pool, v_pool, tables, lengths, scale):
    """Validate what the kernel takes, allocate the output and launch
    ``csrc/paged_attention.cu`` on the current stream."""
    from ..kernels import load

    dev = q.device
    tensors = (q, k_new, v_new, k_pool, v_pool, tables, lengths)
    if any(t.device != dev for t in tensors):
        raise ValueError("paged_attention: every input must be on one device")
    if q.dtype not in _KERNEL_DTYPES or any(
        t.dtype != q.dtype for t in (k_new, v_new, k_pool, v_pool)
    ):
        raise TypeError(
            f"paged_attention kernel takes float32 or bfloat16 for q, the "
            f"new K/V and the pools alike; got {q.dtype}, {k_new.dtype}, "
            f"{v_new.dtype}, {k_pool.dtype}, {v_pool.dtype}"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention kernel needs contiguous inputs")
    s, h, d = q.shape
    n, bs = k_pool.shape[:2]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"paged_attention kernel supports head_dim in "
            f"{KERNEL_HEAD_DIMS}, got {d}"
        )
    out = torch.empty_like(q)
    if s == 0 or h == 0:
        return out
    fn = load("paged_attention").ft_paged_attention_decode
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
                lengths.data_ptr(), out.data_ptr(), s, h, d, n, bs,
                tables.shape[1], ctypes.c_float(scale),
                _KERNEL_DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"paged_attention kernel launch failed: CUDA error {rc}"
        )
    paged_attention.launches += 1
    return out


def paged_attention(q, k_new, v_new, k_pool, v_pool, tables, lengths, *,
                    scale: float | None = None, impl: str = "cuda"):
    """Paged decode attention for one token per slot.

    ``q`` / ``k_new`` / ``v_new``: (S, H, D), the decode step's query and
    the new token's K/V, already RoPE'd at each row's position.
    ``k_pool`` / ``v_pool``: (N, bs, H, D) one layer's pools; ``tables``
    (S, P) block ids in ``[0, N)``; ``lengths`` (S,) cache positions
    already written per row, each ``< P*bs`` (a row at the table's
    capacity has no position left to decode into).  Returns (S, H, D) in
    ``q``'s dtype, equal to :func:`paged_attention_gather` within
    :data:`FUSED_DECODE_ATOL` in float32.

    ``impl="cuda"`` (the default) launches the CUDA kernel on a CUDA
    tensor, and counts the launch in ``paged_attention.launches``; on a
    CPU tensor it computes :func:`paged_attention_stream`.
    ``impl="torch"`` computes :func:`paged_attention_stream` on any
    device.
    """
    _check_shapes(q, k_new, v_new, k_pool, v_pool, tables, lengths)
    if impl not in ("cuda", "torch"):
        raise ValueError(f"unknown paged-attention impl {impl!r}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    tables = tables.to(torch.int32)
    lengths = lengths.to(torch.int32)
    if impl == "torch" or q.device.type == "cpu":
        return paged_attention_stream(q, k_new, v_new, k_pool, v_pool,
                                      tables, lengths, float(scale))
    if q.device.type != "cuda":
        raise ValueError(
            f"paged_attention kernel runs on CUDA tensors, got {q.device}"
        )
    return _launch(q, k_new, v_new, k_pool, v_pool, tables, lengths,
                   float(scale))


#: Kernel launches since the count was last reset (set it to 0 to reset).
paged_attention.launches = 0
