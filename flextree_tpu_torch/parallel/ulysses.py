"""Ulysses sequence parallelism: all-to-all head/sequence re-sharding.

PyTorch counterpart of ``flextree_tpu/parallel/ulysses.py``.  Where the
ring keeps queries on their rank and walks K/V around it, Ulysses
re-shards once each way: an all-to-all turns the sequence-sharded layout
(every head) into a head-sharded one (the full sequence), exact attention
runs locally over the full sequence, and a second all-to-all restores the
sequence shards.  Both all-to-alls are :meth:`~.spmd.Axis.all_to_all`, so
the gradients re-shard by the inverse all-to-all.  Functions that take an
axis take lists, one tensor a rank of the axis' mesh (:mod:`.spmd`).
"""

from __future__ import annotations

from .ring_attention import local_attention

__all__ = ["ulysses_attention", "seq_to_heads", "heads_to_seq"]


def seq_to_heads(x, axis):
    """(B, T/n, H, D) sequence shards -> (B, T, H/n, D) head shards: each
    rank's heads split into ``n`` groups, the group's sequence shards
    concatenated, so each rank holds the whole sequence for ``H/n``
    heads."""
    n = axis.size
    if n == 1:
        return list(x)
    if x[0].shape[2] % n:
        raise ValueError(
            f"Ulysses needs heads ({x[0].shape[2]}) divisible by the sequence "
            f"axis size ({n}); use ring attention for head-poor models"
        )
    return axis.all_to_all(x, split_axis=2, concat_axis=1)


def heads_to_seq(x, axis):
    """The inverse of :func:`seq_to_heads`: back to sequence shards."""
    if axis.size == 1:
        return list(x)
    return axis.all_to_all(x, split_axis=1, concat_axis=2)


def ulysses_attention(q, k, v, axis, *, causal: bool = True,
                      scale: float | None = None, impl: str = "reference",
                      **flash_kwargs):
    """Exact attention with the sequence sharded over ``axis``: the
    contract of :func:`.ring_attention.ring_attention`, with ``H``
    divisible by the axis size.  After the re-shard the whole sequence is
    local, so the plain causal mask is the global one.  ``impl`` and
    ``flash_kwargs`` go to the inner :func:`.ring_attention.local_attention`
    (a full-sequence-local call, so a tuned flash config applies)."""
    qh = seq_to_heads(q, axis)
    kh = seq_to_heads(k, axis)
    vh = seq_to_heads(v, axis)
    out = [local_attention(a, b, c, causal=causal, scale=scale, impl=impl,
                           **flash_kwargs) for a, b, c in zip(qh, kh, vh)]
    return heads_to_seq(out, axis)
