"""Ring attention: exact attention with the sequence sharded over an axis.

PyTorch counterpart of ``flextree_tpu/parallel/ring_attention.py``.  The
sequence is split over a sequence-parallel :class:`~.spmd.Axis`; queries
stay on their rank and each K/V block walks the ring, one neighbour hop a
step (:meth:`~.spmd.Axis.ppermute`), so that at step ``s`` rank ``i`` of
a group holds the block that started on rank ``(i - s) mod n``.  Two
per-hop computes, as in the JAX module:

- ``impl="reference"``: an online softmax over each visiting block
  (:func:`local_attention_block`), causality by global position;
- ``impl="flash"``: one flash call a hop (the CUDA kernels,
  :func:`..ops.flash_attention.flash_attention` with ``return_lse=True``)
  whose ``(out, lse)`` pairs merge by :func:`hop_merge`.  Where the block
  came from decides the call: the resident block is causal at equal
  offsets, a block from an earlier rank is fully visible (non-causal), and
  a block from a later rank is masked.  The source is known on the host,
  so a masked hop is a Python branch that launches nothing and contributes
  zeros and the ``-1e30`` sentinel, as JAX's ``lax.switch`` runs only its
  ``masked_hop``.

Functions that take an axis take lists, one tensor a rank of the axis'
mesh (:mod:`.spmd`), and run every rank in lock-step.  The module also
holds the full-sequence-local pieces one rank runs alone:
:func:`local_attention`, the switch between the full-matrix reference and
the flash kernels that the model forward and the Ulysses inner attention
share, and :func:`attention_reference`, the full-matrix oracle.
"""

from __future__ import annotations

import torch

__all__ = [
    "attention_reference",
    "local_attention",
    "local_attention_block",
    "ring_attention",
    "hop_merge",
    "hop_finalize",
    "varying_zeros",
]

_NEG_INF = -1e30


def varying_zeros(ref, dtype=None):
    """Exact zeros of ``ref``'s shape: finite even where ``ref`` is not (a
    masked hop must contribute exact zeros whatever the queries hold)."""
    return torch.zeros_like(ref, dtype=ref.dtype if dtype is None else dtype)


def local_attention_block(q, k, v, q_pos, k_pos, *, causal: bool,
                          scale: float, m, l, acc):
    """One online-softmax step over one K/V block.

    ``q`` (B, Tq, H, D), ``k``/``v`` (B, Tk, H, D), ``q_pos`` (Tq,) and
    ``k_pos`` (Tk,) global positions; ``m``/``l`` (B, H, Tq) the running
    max and normaliser, ``acc`` (B, Tq, H, D) the running weighted value
    sum.  Returns the updated ``(m, l, acc)``."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]
        s = torch.where(mask, s, _NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # mask the probabilities too: a row with no visible key keeps m_new at
    # the sentinel, where exp(s - m_new) would be 1
    p = torch.exp(s - m_new[..., None])
    if causal:
        p = torch.where(mask, p, 0.0)
    correction = torch.exp(m - m_new)
    l_new = l * correction + p.sum(dim=-1)
    acc_new = acc * correction.transpose(1, 2)[..., None] + torch.einsum(
        "bhqk,bkhd->bqhd", p, v.float())
    return m_new, l_new, acc_new


def _finalize(acc, l):
    """The weighted value sum over the normaliser; rows with no mass give
    zeros, not NaN."""
    denom = l.transpose(1, 2)[..., None]
    return torch.where(denom > 0, acc / torch.where(denom > 0, denom, 1.0),
                       0.0)


def hop_merge(carry, out_j, lse_j):
    """Fold one hop's ``(out, lse)`` into the running ``(m, so, sd)``: the
    per-hop online softmax, shared by the flash ring and the zigzag ring.
    ``m``/``sd`` (B, Tq, H) running max and normaliser, ``so`` (B, Tq, H, D)
    the scaled value sum, all float32."""
    m, so, sd = carry
    m_new = torch.maximum(m, lse_j)
    c_old = torch.exp(m - m_new)
    c_new = torch.exp(lse_j - m_new)
    so = so * c_old[..., None] + out_j.float() * c_new[..., None]
    sd = sd * c_old + c_new
    return m_new, so, sd


def hop_finalize(carry):
    """Normalise merged hops; rows no hop touched (``sd == 0``) give zeros,
    not NaN."""
    _, so, sd = carry
    denom = sd[..., None]
    return torch.where(denom > 0, so / torch.where(denom > 0, denom, 1.0),
                       0.0)


def hop_init(q):
    """The ``(m, so, sd)`` of no hop yet, for queries ``q``."""
    zero = varying_zeros(q[..., 0], torch.float32)
    return zero + _NEG_INF, varying_zeros(q, torch.float32), zero


def masked_hop(q):
    """A hop that sees nothing: zeros and the ``-1e30`` lse sentinel."""
    return varying_zeros(q), varying_zeros(q[..., 0], torch.float32) + _NEG_INF


def _right(n: int):
    """The ring's hop: each rank's block to its right neighbour."""
    return [(j, (j + 1) % n) for j in range(n)]


def ring_attention(q, k, v, axis, *, causal: bool = True,
                   scale: float | None = None, impl: str = "reference"):
    """Exact attention with the sequence sharded over ``axis``.

    ``q``/``k``/``v``: one (B, T_local, H, D) tensor a rank of the axis'
    mesh, each its shard of the sequence (the global sequence is the
    shards in axis-index order).  Returns each rank's (B, T_local, H, D)
    output for its queries, in q's dtype.  ``impl``: ``"reference"`` or
    ``"flash"`` (see the module docstring)."""
    if impl == "flash":
        return _ring_attention_flash(q, k, v, axis, causal=causal,
                                     scale=scale)
    if impl != "reference":
        raise ValueError(f"unknown attention impl {impl!r}")
    n = axis.size
    b, t_local, h, d = q[0].shape
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    ranks = range(len(q))
    q_pos = [axis.index[r] * t_local + torch.arange(t_local,
                                                     device=q[r].device)
             for r in ranks]
    state = []
    for r in ranks:
        zero = varying_zeros(q[r][..., 0], torch.float32).transpose(1, 2)
        state.append((zero + _NEG_INF, zero,
                      varying_zeros(q[r], torch.float32)))
    k_blk, v_blk = list(k), list(v)
    for s in range(n):
        for r in ranks:
            src = (axis.index[r] - s) % n
            k_pos = src * t_local + torch.arange(t_local, device=q[r].device)
            m, l, acc = state[r]
            state[r] = local_attention_block(
                q[r], k_blk[r], v_blk[r], q_pos[r], k_pos, causal=causal,
                scale=scale, m=m, l=l, acc=acc)
        if s + 1 < n:
            k_blk = axis.ppermute(k_blk, _right(n))
            v_blk = axis.ppermute(v_blk, _right(n))
    return [_finalize(acc, l).to(q[r].dtype)
            for r, (_, l, acc) in zip(ranks, state)]


def _ring_attention_flash(q, k, v, axis, *, causal: bool,
                          scale: float | None):
    """The ring with one flash call a hop, merged by :func:`hop_merge`."""
    from ..ops.flash_attention import flash_attention

    n = axis.size
    d = q[0].shape[-1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)

    def hop(qr, kb, vb, hop_causal):
        return flash_attention(qr, kb, vb, causal=hop_causal, scale=scale,
                               return_lse=True)

    if n == 1:
        return [hop(qr, kr, vr, causal)[0] for qr, kr, vr in zip(q, k, v)]
    ranks = range(len(q))
    acc = [hop_init(qr) for qr in q]
    k_blk, v_blk = list(k), list(v)
    for s in range(n):
        for r in ranks:
            idx = axis.index[r]
            src = (idx - s) % n
            if not causal or src < idx:  # a past block: fully visible
                got = hop(q[r], k_blk[r], v_blk[r], False)
            elif src == idx:  # the resident block: causal, equal offsets
                got = hop(q[r], k_blk[r], v_blk[r], True)
            else:  # a future block
                got = masked_hop(q[r])
            acc[r] = hop_merge(acc[r], *got)
        if s + 1 < n:
            k_blk = axis.ppermute(k_blk, _right(n))
            v_blk = axis.ppermute(v_blk, _right(n))
    return [hop_finalize(a).to(qr.dtype) for a, qr in zip(acc, q)]


def attention_reference(q, k, v, *, causal: bool = True,
                        scale: float | None = None,
                        return_lse: bool = False):
    """Single-device full-matrix attention on (B, T, H, D): the oracle of
    the ring.  Causal at the default scale it is
    ``models.generate.cached_attention`` over the sequence's own positions,
    the model's reference attention; otherwise the JAX function's softmax.
    ``return_lse=True`` also returns each row's logsumexp of the masked
    scores, (B, T, H) float32 with ``-1e30`` for a row that sees no key
    (the contract of ``flash_attention(return_lse=True)``), so the zigzag
    ring can take either as its hop compute."""
    if causal and scale is None and not return_lse:
        from ..models.generate import cached_attention

        return cached_attention(q, k, v, torch.arange(q.shape[1],
                                                      device=q.device))
    t = q.shape[1]
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        pos = torch.arange(t, device=q.device)
        mask = pos[:, None] >= pos[None, :]
        s = torch.where(mask, s, _NEG_INF)
    if not return_lse:
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
        return out.to(q.dtype)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    if causal:
        p = torch.where(mask, p, 0.0)
    l = p.sum(dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    out = _finalize(out, l)
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-38)),
                      _NEG_INF).transpose(1, 2)
    return out.to(q.dtype), lse


def local_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None, impl: str = "reference",
                    **flash_kwargs):
    """Full-sequence-local attention by implementation name:
    ``"reference"`` (:func:`attention_reference`) or ``"flash"``
    (:func:`..ops.flash_attention.flash_attention`, the CUDA kernels on a
    CUDA tensor).  ``flash_kwargs`` (``block_q``, ``block_k``,
    ``variant``, ...) go to the flash kernel; the reference impl has no
    such knobs and rejects them."""
    if impl == "flash":
        from ..ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal, scale=scale,
                               **flash_kwargs)
    if flash_kwargs:
        raise TypeError(
            f"attention impl {impl!r} takes no flash kwargs: "
            f"{sorted(flash_kwargs)}"
        )
    if impl == "reference":
        return attention_reference(q, k, v, causal=causal, scale=scale)
    raise ValueError(f"unknown attention impl {impl!r}")
