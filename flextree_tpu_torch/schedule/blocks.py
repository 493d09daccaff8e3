"""Block layout math: how a flat buffer of ``count`` elements is split into
``num_nodes`` equal blocks, including the possibly-empty tail blocks.

A copy of ``flextree_tpu/schedule/blocks.py`` (the port imports nothing of
the JAX package).

Mirrors ``FlexTree_Context`` in the reference
(``allreduce_over_mpi/mpi_mod.hpp:216-243``): ``split_size =
ceil(count / num_nodes)`` and ``data_size_aligned = split_size * num_nodes``,
so with N=10 and count=1 nine of the ten blocks are empty — tail clamping is
therefore a first-class concern (``mpi_mod.hpp:236``, and the clamp sites at
``:679-696``, ``:725-760``, ``:791-800``).

On TPU we instead *pad* the buffer up to ``data_size_aligned`` (XLA
collectives want uniform shards), but the schedule layer still exposes exact
(start, length) spans so the NumPy simulator can reproduce the reference's
clamped semantics bit-for-bit and tests can check the tail handling.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["BlockLayout", "owned_block", "shard_layout"]


@dataclass(frozen=True)
class BlockLayout:
    """Splits ``count`` elements into ``num_nodes`` blocks of ``split_size``.

    Attributes mirror the reference context fields:
      split_size        -> ``mpi_mod.hpp:231``
      count_aligned     -> ``data_size_aligned`` (``mpi_mod.hpp:232``)
    """

    num_nodes: int
    count: int
    split_size: int = field(init=False)
    count_aligned: int = field(init=False)

    def __post_init__(self):
        if self.num_nodes < 1:
            raise ValueError(f"num_nodes must be >= 1, got {self.num_nodes}")
        if self.count < 0:
            raise ValueError(f"count must be >= 0, got {self.count}")
        split = -(-self.count // self.num_nodes) if self.count else 0
        object.__setattr__(self, "split_size", split)
        object.__setattr__(self, "count_aligned", split * self.num_nodes)

    @property
    def pad(self) -> int:
        """Elements of padding needed to reach the aligned size."""
        return self.count_aligned - self.count

    def span(self, block: int) -> tuple[int, int]:
        """(start, length) of ``block`` within the *unpadded* buffer.

        Tail blocks are clamped to the true data size and may be empty —
        the reference's ``start + split_size > data_size`` truncation
        (``mpi_mod.hpp:679-696``).
        """
        if not 0 <= block < self.num_nodes:
            raise IndexError(f"block {block} out of range [0, {self.num_nodes})")
        start = block * self.split_size
        if start >= self.count:
            return (min(start, self.count), 0)
        return (start, min(self.split_size, self.count - start))

    def is_empty(self, block: int) -> bool:
        return self.span(block)[1] == 0

    def slices(self) -> list[slice]:
        """Python slices for every block, clamped to the unpadded buffer."""
        return [slice(s, s + l) for s, l in (self.span(b) for b in range(self.num_nodes))]


# ---------------------------------------------------------------------------
# shard-layout contract: which block each rank OWNS after phase 1
# ---------------------------------------------------------------------------
#
# The standalone ``reduce_scatter`` leaves every rank holding exactly one
# fully-reduced 1/N block of the (padded) buffer; ``all_gather`` reassembles
# the blocks in BLOCK order.  Which block a rank owns is a pure function of
# the width vector — the residue-chain ownership of SURVEY §3.2:
#
# - **tree** (widths ``(w0, .., wk)``): stage ``i`` splits the current slice
#   into ``wi`` tiles and the rank at group position ``p_i = (r // gap_i) %
#   wi`` keeps tile ``p_i`` (``lax.psum_scatter(tiled=True)`` ownership), so
#   the final block index is the mixed-radix composition
#   ``sum_i p_i * prod(widths[i+1:])``.  Flat ``(N,)`` degenerates to
#   ``owned_block(r) == r``.
# - **ring** (sentinel ``(1,)``): after ``N-1`` fold steps of the reference
#   block walk (send ``(r - s) % N``, fold ``(r - s - 1) % N``), rank ``r``
#   holds the fully-reduced block ``(r + 1) % N`` (``mpi_mod.hpp:1149``:
#   the gather phase starts by forwarding exactly that block).
# - **lonely** (``m`` tree ranks + ``l`` lonely): only tree ranks own
#   blocks; lonely rank ``m + i`` MIRRORS its buddy ``i``'s block (the
#   reduce-scatter ships the buddy's reduced tile over, so both hold
#   identical bits).  The ``l`` mirrored blocks are duplicates, not a
#   partition — ``all_gather`` ignores the lonely ranks' copies.
#
# This module is imported by the JAX-less static verifier, so everything
# here must stay pure Python.


def owned_block(topo, rank: int) -> int:
    """Block index rank ``rank`` owns after a standalone reduce-scatter
    with ``topo`` (a resolved ``Topology`` or ``LonelyTopology``)."""
    n = topo.num_nodes
    if not 0 <= rank < n:
        raise IndexError(f"rank {rank} out of range [0, {n})")
    if hasattr(topo, "tree"):  # LonelyTopology: buddies mirror
        m = topo.tree.num_nodes
        return owned_block(topo.tree, rank if rank < m else rank - m)
    if topo.is_ring:
        return (rank + 1) % n
    block = 0
    for i, w in enumerate(topo.widths):
        tiles_below = 1
        for wj in topo.widths[i + 1:]:
            tiles_below *= wj
        p = (rank // topo.gaps[i]) % w
        block += p * tiles_below
    return block


def shard_layout(topo) -> tuple[int, ...]:
    """Owned block per rank: ``shard_layout(topo)[r] == owned_block(topo,
    r)``.  For tree/ring shapes this is a permutation of ``range(N)``; for
    lonely shapes the last ``l`` entries duplicate their buddies' blocks
    and the first ``m`` entries form the true partition."""
    return tuple(owned_block(topo, r) for r in range(topo.num_nodes))
