"""Zigzag (load-balanced) causal ring attention.

PyTorch counterpart of ``flextree_tpu/parallel/zigzag.py``.  The causal
ring leaves some rank facing a fully visible block at every hop.  The
zigzag layout splits the global sequence into ``2n`` chunks and gives
rank ``i`` of the axis the pair ``(i, 2n-1-i)``, one early and one late
chunk, so under the causal mask every rank has the same visible work at
every hop.  Chunk pairs align with the chunks, so each (q-chunk, kv-chunk)
block is exactly future, diagonal or past (:func:`hop_branches`): the
three branches of the flash ring, the masked one launching nothing.

Functions that take an axis take lists, one tensor a rank of the axis'
mesh, and move chunks with :meth:`~.spmd.Axis.ppermute` (:mod:`.spmd`).
"""

from __future__ import annotations

import torch

from .ring_attention import (
    attention_reference,
    hop_finalize,
    hop_init,
    hop_merge,
    masked_hop,
)

__all__ = ["zigzag_split", "zigzag_merge", "hop_branches",
           "zigzag_ring_attention"]


def _owner(g: int, n: int) -> int:
    """The zigzag owner of global chunk ``g``: rank ``g`` for the early
    half, rank ``2n-1-g`` for the late half."""
    return g if g < n else 2 * n - 1 - g


def _even_local(t_local: int) -> None:
    if t_local % 2:
        raise ValueError(f"zigzag needs an even local length, got {t_local}")


def zigzag_split(x, axis):
    """Contiguous sequence shards -> zigzag shards, by two permutes.

    ``x``: one (B, T_local, ...) tensor a rank, rank ``i`` of the axis
    holding chunks ``(2i, 2i+1)``; T_local even.  Returns the same shapes
    holding chunks ``(i, 2n-1-i)``.  A rank's two chunks have opposite
    parity, as do a zigzag owner's, so each permute is a bijection."""
    n = axis.size
    _even_local(x[0].shape[1])
    if n == 1:
        return list(x)
    c = x[0].shape[1] // 2
    recv_even = axis.ppermute([t[:, :c] for t in x],
                              [(i, _owner(2 * i, n)) for i in range(n)])
    recv_odd = axis.ppermute([t[:, c:] for t in x],
                             [(i, _owner(2 * i + 1, n)) for i in range(n)])
    # a rank's early chunk g = idx is even iff idx is; its late chunk has
    # the other parity
    out = []
    for r, (e, o) in enumerate(zip(recv_even, recv_odd)):
        early, late = (e, o) if axis.index[r] % 2 == 0 else (o, e)
        out.append(torch.cat([early, late], dim=1))
    return out


def zigzag_merge(x, axis):
    """The inverse of :func:`zigzag_split`: zigzag shards -> contiguous,
    by two parity-separated permutes (each rank holds one even and one odd
    chunk, and contiguous owner ``i`` wants ``2i`` and ``2i+1``)."""
    n = axis.size
    _even_local(x[0].shape[1])
    if n == 1:
        return list(x)
    c = x[0].shape[1] // 2

    def even_chunk_of(j):
        return j if j % 2 == 0 else 2 * n - 1 - j

    def odd_chunk_of(j):
        return j if j % 2 == 1 else 2 * n - 1 - j

    send_e, send_o = [], []
    for r, t in enumerate(x):
        early, late = t[:, :c], t[:, c:]
        even_first = axis.index[r] % 2 == 0
        send_e.append(early if even_first else late)
        send_o.append(late if even_first else early)
    recv_e = axis.ppermute(send_e, [(j, even_chunk_of(j) // 2)
                                    for j in range(n)])
    recv_o = axis.ppermute(send_o, [(j, odd_chunk_of(j) // 2)
                                    for j in range(n)])
    return [torch.cat([e, o], dim=1) for e, o in zip(recv_e, recv_o)]


def hop_branches(src: int, idx: int) -> tuple[int, int]:
    """The visibility of one hop's two chunk pairs, for the visiting
    source ``src`` on rank ``idx``: ``(early, late)``, each 0 (diagonal),
    1 (past, fully visible) or 2 (future, masked).  The early pair
    compares chunk ``src`` with ``idx``, the late pair ``2n-1-src`` with
    ``2n-1-idx``, so its order flips."""
    br_e = 0 if src == idx else (1 if src < idx else 2)
    br_l = 0 if src == idx else (1 if src > idx else 2)
    return br_e, br_l


def zigzag_ring_attention(q, k, v, axis, *, scale: float | None = None,
                          layout: str = "contiguous", impl: str = "flash"):
    """Causal exact attention, sequence-parallel and load-balanced.

    ``q``/``k``/``v``: one (B, T_local, H, D) tensor a rank.
    ``layout="contiguous"`` (the model's sharding) converts in and out with
    :func:`zigzag_split`/:func:`zigzag_merge`; ``layout="zigzag"`` takes
    and returns zigzag shards.  Causal only.  ``impl``: ``"flash"`` (the
    CUDA kernels a chunk pair) or ``"reference"`` (full-matrix chunk
    blocks)."""
    from ..ops.flash_attention import flash_attention

    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown layout {layout!r}")
    if impl not in ("flash", "reference"):
        raise ValueError(f"unknown attention impl {impl!r}")
    n = axis.size
    b, t_local, _, d = q[0].shape
    if scale is None:
        scale = 1.0 / (d ** 0.5)

    def local(qb, kb, vb, causal):
        if impl == "flash":
            return flash_attention(qb, kb, vb, causal=causal, scale=scale,
                                   return_lse=True)
        return attention_reference(qb, kb, vb, causal=causal, scale=scale,
                                   return_lse=True)

    if n == 1:  # no split: an odd local length is fine here
        if impl == "flash":
            return [flash_attention(a, b_, c_, causal=True, scale=scale)
                    for a, b_, c_ in zip(q, k, v)]
        return [attention_reference(a, b_, c_, causal=True, scale=scale)
                for a, b_, c_ in zip(q, k, v)]
    _even_local(t_local)
    if layout == "contiguous":
        # one split for all three: 2 permutes of 3x the payload
        qkv = zigzag_split([torch.cat(t, dim=0) for t in zip(q, k, v)], axis)
        q = [t[:b] for t in qkv]
        k = [t[b:2 * b] for t in qkv]
        v = [t[2 * b:] for t in qkv]
    c = t_local // 2

    def halves(t):  # the kernels take contiguous tensors
        return t[:, :c].contiguous(), t[:, c:].contiguous()

    q_e, q_l = zip(*(halves(t) for t in q))
    acc_e = [hop_init(t) for t in q_e]
    acc_l = [hop_init(t) for t in q_l]
    k_blk, v_blk = list(k), list(v)
    right = [(j, (j + 1) % n) for j in range(n)]
    for s in range(n):
        for r in range(len(q)):
            idx = axis.index[r]
            src = (idx - s) % n
            k_e, k_l = halves(k_blk[r])
            v_e, v_l = halves(v_blk[r])
            for (qb, kb, vb, acc), br in zip(
                    ((q_e[r], k_e, v_e, acc_e), (q_l[r], k_l, v_l, acc_l)),
                    hop_branches(src, idx)):
                got = masked_hop(qb) if br == 2 else local(qb, kb, vb, br == 0)
                acc[r] = hop_merge(acc[r], *got)
            # the late chunk always sees the visiting early chunk
            # (2n-1-idx >= n > src); the early chunk never sees a late one
            acc_l[r] = hop_merge(acc_l[r], *local(q_l[r], k_e, v_e, False))
        if s + 1 < n:
            k_blk = axis.ppermute(k_blk, right)
            v_blk = axis.ppermute(v_blk, right)
    out = [torch.cat([hop_finalize(e), hop_finalize(l_)], dim=1).to(t.dtype)
           for e, l_, t in zip(acc_e, acc_l, q)]
    if layout == "contiguous":
        out = zigzag_merge(out, axis)
    return out
