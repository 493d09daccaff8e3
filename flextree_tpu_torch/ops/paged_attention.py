"""Paged decode attention: one new token per slot over a block-paged cache.

PyTorch counterpart of ``flextree_tpu/ops/paged_attention.py``.  Per slot
``s`` and head ``h`` the function attends the slot's query over the pool
positions ``< lengths[s]`` (reached through the slot's block-table row)
plus the new token's K/V at position ``lengths[s]``.  Four versions, one
contract:

- :func:`paged_attention_gather` — the oracle: gather every table block
  into a contiguous ``(S, P*bs, H, D)`` view, splice the new token in and
  attend with the full-row softmax (``models.generate.cached_attention``);
- :func:`paged_attention_stream` — the plain streaming twin of the JAX
  module's ``_stream_jnp`` at ``block_chunk=1``: walk the table one block
  at a time with an online softmax, batched over all slots, stopping at
  the batch's causal frontier;
- :func:`paged_attention_split_plain` — the plain version of the CUDA
  kernel's split-K: each run of :data:`KERNEL_BLOCKS_PER_SPLIT` table
  blocks gives a float32 partial, merged in split order, the new token
  last (for the tests and ``chip_smoke.py``);
- :func:`paged_attention` — the wrapper the serving path calls.  On a CUDA
  tensor it launches the hand-written kernel ``csrc/paged_attention.cu``
  (which replaces the Pallas ``_paged_kernel``) or raises; on a CPU tensor
  it computes the plain stream, the only reason it ever does.

The streamed and split versions differ from the oracle only in float
summation order, so they are held to it within :data:`FUSED_DECODE_ATOL`
(float32), not bitwise.  Masking follows ``cached_attention``: a position
at or past a row's length gets score ``-1e30`` before the running max and
probability exactly 0.0 after it, so whatever an unwritten or null block
holds contributes nothing — and the kernel never even loads it.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from ..models.generate import cached_attention

__all__ = [
    "FUSED_DECODE_ATOL",
    "paged_attention",
    "paged_attention_gather",
    "paged_attention_split_plain",
    "paged_attention_stream",
]

_NEG_INF = -1e30

#: Tolerance of the streamed versions against the gather oracle on the
#: attention output (float32 compute): they differ only in summation
#: order, which moves the output by ~1e-7; a masking or indexing defect
#: moves it by O(1).
FUSED_DECODE_ATOL = 2e-5

#: Head dims the CUDA kernel is instantiated for (8 dims a thread, D / 8
#: threads a position).
KERNEL_HEAD_DIMS = (32, 64, 128, 256)
#: Table blocks per split of the CUDA kernel (``kBlocksPerSplit`` in
#: ``csrc/paged_attention.cu``): where its float32 partials are cut.
KERNEL_BLOCKS_PER_SPLIT = 4
#: Shared memory a CTA of the kernel may use (the H100's 227 KB).
_KERNEL_SMEM_BYTES = 232_448
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


def paged_attention_split_plain(q, k_new, v_new, k_pool, v_pool, tables,
                                lengths, scale: float,
                                blocks_per_split: int = KERNEL_BLOCKS_PER_SPLIT):
    """The plain version of the CUDA kernel's split-K.  Split ``c`` of a
    row covers table blocks ``[c*C, (c+1)*C)`` (``C = blocks_per_split``)
    and, if it holds a position ``< length``, gives a float32 partial: the
    max ``m_c`` of its scores (compute dtype, then float32, times
    ``scale``), ``l_c = sum exp(s - m_c)`` and ``acc_c = sum exp(s - m_c)
    v`` over its positions ``< length``.  The partials merge in split order
    against their common max ``M``; the new token folds last, as in
    :func:`paged_attention_stream`."""
    _check_shapes(q, k_new, v_new, k_pool, v_pool, tables, lengths)
    if blocks_per_split <= 0:
        raise ValueError(f"blocks_per_split must be positive, got "
                         f"{blocks_per_split}")
    s, h, d = q.shape
    bs = k_pool.shape[1]
    width = tables.shape[1]
    span = blocks_per_split * bs
    idx = tables.long()
    lengths_b = lengths.long().clamp(0, width * bs)[:, None]  # (S, 1)
    n_splits = -(-int(lengths_b.max()) // span) if s else 0
    parts = []
    for c in range(n_splits):
        cols = idx[:, c * blocks_per_split:(c + 1) * blocks_per_split]
        kb = k_pool[cols].reshape(s, -1, h, d)  # (S, J, H, D)
        vb = v_pool[cols].reshape(s, -1, h, d)
        sc = torch.einsum("shd,sjhd->shj", q, kb).float() * scale
        pos = c * span + torch.arange(kb.shape[1], device=q.device)
        valid = (pos[None, :] < lengths_b)[:, None, :]  # (S, 1, J)
        sc = sc.masked_fill(~valid, _NEG_INF)
        m_c = sc.amax(dim=-1)
        pr = torch.exp(sc - m_c[..., None]).masked_fill(~valid, 0.0)
        acc_c = torch.einsum("shj,sjhd->shd", pr, vb.float())
        has = (c * span < lengths_b)  # (S, 1): the split holds a position
        parts.append((m_c, pr.sum(dim=-1), acc_c, has))
    big = torch.full((s, h), _NEG_INF, dtype=torch.float32, device=q.device)
    for m_c, _, _, has in parts:
        big = torch.where(has, torch.maximum(big, m_c), big)
    l = torch.zeros((s, h), dtype=torch.float32, device=q.device)
    acc = torch.zeros((s, h, d), dtype=torch.float32, device=q.device)
    for m_c, l_c, acc_c, has in parts:
        w = torch.where(has, torch.exp(m_c - big), 0.0)
        l = l + l_c * w
        acc = acc + acc_c * w[..., None]
    # the new token's K/V — position `length`, always visible to itself
    s_new = torch.einsum("shd,shd->sh", q, k_new).float() * scale
    m_fin = torch.maximum(big, s_new)
    p_new = torch.exp(s_new - m_fin)
    corr = torch.exp(big - m_fin)
    l = l * corr + p_new
    acc = acc * corr[..., None] + p_new[..., None] * v_new.float()
    return (acc / l[..., None]).to(q.dtype)


def _launch(q, k_new, v_new, k_pool, v_pool, tables, lengths, scale):
    """Validate what the kernel takes, allocate the output and the float32
    workspace of the split partials, and launch ``csrc/paged_attention.cu``
    (its split and combine kernels) on the current stream."""
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
    for t in (q, k_new, v_new, k_pool, v_pool):
        if t.data_ptr() % 16:
            raise ValueError(
                f"paged_attention kernel reads q, the new K/V and the pools "
                f"16 bytes at a time; got one that starts at "
                f"{t.data_ptr() % 16} bytes past a 16-byte boundary (copy it "
                f"with .clone())"
            )
    width = tables.shape[1]
    span = KERNEL_BLOCKS_PER_SPLIT * bs
    # K and V of a split, its scores, the (positions x 8 dims) p.v sums
    smem = 2 * span * d * q.element_size() + 4 * (span + 128 * 8 + 4)
    if smem > _KERNEL_SMEM_BYTES:
        raise ValueError(
            f"paged_attention kernel keeps {KERNEL_BLOCKS_PER_SPLIT} blocks "
            f"of K and V in shared memory: block size {bs} at head dim {d} "
            f"needs {smem} bytes, over {_KERNEL_SMEM_BYTES}"
        )
    out = torch.empty_like(q)
    if s == 0 or h == 0:
        return out
    n_split = -(-width // KERNEL_BLOCKS_PER_SPLIT)
    # float32 partials (acc, then m and l) of every split, written by the
    # split kernel and read in split order by the combine kernel
    workspace = torch.empty(s * h * n_split * (d + 2), dtype=torch.float32,
                            device=dev)
    fn = load("paged_attention").ft_paged_attention_decode
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
                k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
                lengths.data_ptr(), out.data_ptr(), workspace.data_ptr(), s,
                h, d, n, bs, width, ctypes.c_float(scale),
                _KERNEL_DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(
            f"paged_attention kernel launch failed: CUDA error {rc}"
        )
    with _COUNT_LOCK:  # replicas may launch from threads of their own
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
    tensor, and counts the launch in ``paged_attention.launches`` (one a
    call: its split and combine kernels go together); on a CPU tensor it
    computes :func:`paged_attention_stream`.  The kernel reads q, the new
    K/V and the pools 16 bytes at a time, so each must start on a 16-byte
    boundary, or this raises.  Bound: bytes, the K/V rows below each
    length once (~3.6 MB, ~1 us on an H100 at the flagship decode), under
    one launch's latency; design: split-K over the sequence, float32
    partials merged in split order (the source's note).
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
_COUNT_LOCK = threading.Lock()
