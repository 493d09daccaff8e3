"""Per-rank, per-stage send/recv schedule generation for the k-ary tree.

A copy of ``flextree_tpu/schedule/plan.py`` (the port imports nothing of
the JAX package).

This is the pure-logic heart of the framework — the reference keeps this layer
deliberately transport-free ("topology generation must depend only on
(total_peers, node_label, stages), not on MPI", ``mpi_mod.hpp:78``) and so do
we: nothing here imports JAX.  The JAX backend lowers these plans to
``axis_index_groups`` collectives; the NumPy simulator executes them directly.

Semantics reimplemented from ``allreduce_over_mpi/mpi_mod.hpp``:

- ``Operation`` (``:45-75``): one peer plus the block indices to exchange.
  Tree constructor: the strided set ``{p % gap, p%gap + gap, ...} < total``.
- ``Send_Ops::generate_ops`` (``:152-179``): at stage ``i`` with width ``w``
  and accumulated gap ``g``, rank ``r``'s group is ``{base + j*g}`` with
  ``base = (r // (g*w)) * (g*w) + r % g``; ``r`` sends to each group peer
  ``p`` the block set ``{b : b ≡ p (mod g*w)}``.
- ``Recv_Ops::generate_ops`` (``:187-213``): same peers, but every op carries
  ``r``'s own block set ``{b : b ≡ r (mod g*w)}``.

Invariants (property-tested in ``tests/test_schedule.py``):
- at stage ``i`` the send sets of a group partition ``{b : b ≡ r (mod g)}``;
- after all stages rank ``r`` exclusively owns ``{b : b ≡ r (mod N)}``,
  i.e. exactly one block per rank when widths multiply to N;
- phase 2 (reversed stages, send/recv roles swapped) restores full ownership.

The JAX package keeps the residue-chain block math in ``schedule/ir.py``
(``stage_send_blocks`` / ``stage_keep_blocks``); the port, which has no IR
yet, keeps a copy of those two functions here.
"""

from __future__ import annotations

from dataclasses import dataclass

from .stages import Topology

__all__ = [
    "stage_send_blocks",
    "stage_keep_blocks",
    "Operation",
    "tree_block_set",
    "send_plan",
    "recv_plan",
    "owned_blocks",
    "ring_plan",
    "format_plan",
]


def stage_send_blocks(total: int, gap: int, width: int, dst: int) -> tuple[int, ...]:
    """Blocks a group member sends ``dst`` at a (gap, width) tree stage:
    ``{b : b = dst (mod gap*width), b < total}`` — the reference's
    ``Operation.strided`` chain (``mpi_mod.hpp:56-64``)."""
    stride = gap * width
    return tuple(range(dst % stride, total, stride))


def stage_keep_blocks(total: int, gap: int, width: int, rank: int) -> tuple[int, ...]:
    """Blocks ``rank`` keeps (receives partials for) at a (gap, width)
    stage: its own residue chain ``{b : b = rank (mod gap*width)}``."""
    return stage_send_blocks(total, gap, width, rank)


@dataclass(frozen=True)
class Operation:
    """One point-to-point exchange: a peer and the block indices involved."""

    peer: int
    blocks: tuple[int, ...]

    @classmethod
    def strided(cls, peer: int, total: int, gap: int) -> "Operation":
        """Tree-stage op: blocks ``{peer % gap, peer%gap+gap, ...} < total``
        (the reference's first ``Operation`` ctor, ``mpi_mod.hpp:56-64``) —
        the residue chain of :func:`stage_send_blocks` with the stride pre-folded."""
        return cls(peer, stage_send_blocks(total, gap, 1, peer))

    @classmethod
    def single(cls, peer: int, block: int) -> "Operation":
        """Ring-step op carrying one block (``mpi_mod.hpp:70-74``)."""
        return cls(peer, (block,))


def tree_block_set(rank: int, total: int, stride: int) -> tuple[int, ...]:
    """``{b : b ≡ rank (mod stride), b < total}`` — the residue chain
    (:func:`stage_keep_blocks`)."""
    return stage_keep_blocks(total, stride, 1, rank)


def send_plan(topo: Topology, rank: int) -> list[list[Operation]]:
    """Phase-1 send ops per stage for ``rank``: ``plan[stage][j]`` sends
    ``plan[stage][j].blocks`` to ``plan[stage][j].peer`` — a per-rank view
    over :func:`stage_send_blocks`.

    Self-ops (peer == rank) are *included*, as in the reference (the transport
    skips them at ``mpi_mod.hpp:676``); the simulator/backends decide.
    """
    n = topo.num_nodes
    plan: list[list[Operation]] = []
    for i, w in enumerate(topo.widths):
        g = topo.gaps[i]
        stage_ops = [
            Operation(peer, stage_send_blocks(n, g, w, peer))
            for peer in topo.group_members(i, rank)
        ]
        plan.append(stage_ops)
    return plan


def recv_plan(topo: Topology, rank: int) -> list[list[Operation]]:
    """Phase-1 recv ops per stage: same peers as ``send_plan`` but every op
    carries ``rank``'s own residue chain ``{b : b ≡ rank (mod g*w)}``
    (``Recv_Ops::generate_ops``, ``mpi_mod.hpp:192-209``; the chain is
    :func:`stage_keep_blocks`)."""
    n = topo.num_nodes
    plan: list[list[Operation]] = []
    for i, w in enumerate(topo.widths):
        g = topo.gaps[i]
        mine = stage_keep_blocks(n, g, w, rank)
        stage_ops = [Operation(peer, mine) for peer in topo.group_members(i, rank)]
        plan.append(stage_ops)
    return plan


def owned_blocks(topo: Topology, rank: int, upto_stage: int | None = None) -> tuple[int, ...]:
    """Blocks whose partial sum ``rank`` holds after stages ``[0, upto_stage)``.

    After all stages this is ``{b : b ≡ rank (mod N)}`` — exactly one block
    when the widths multiply to N (SURVEY §3.2 invariant).
    """
    k = len(topo.widths) if upto_stage is None else upto_stage
    stride = 1
    for w in topo.widths[:k]:
        stride *= w
    return tree_block_set(rank, topo.num_nodes, stride)


def ring_plan(num_nodes: int, rank: int) -> list[tuple[Operation, Operation]]:
    """The 2(N-1)-step ring schedule for ``rank``.

    Returns ``[(send_op, recv_op), ...]`` — first N-1 entries are the
    reduce-scatter steps, last N-1 the allgather steps.  Neighbors and the
    decrementing block indices mirror ``ring_allreduce``
    (``mpi_mod.hpp:1119-1159``): send right, receive from left; the block sent
    starts at ``rank`` (reduce phase) and walks backwards mod N.
    """
    n = num_nodes
    left, right = (rank - 1) % n, (rank + 1) % n
    steps: list[tuple[Operation, Operation]] = []
    block_send, block_recv = rank, left
    for _ in range(n - 1):  # reduce-scatter
        steps.append((Operation.single(right, block_send), Operation.single(left, block_recv)))
        block_send = (block_send - 1) % n
        block_recv = (block_recv - 1) % n
    block_send, block_recv = (rank + 1) % n, rank
    for _ in range(n - 1):  # allgather
        steps.append((Operation.single(right, block_send), Operation.single(left, block_recv)))
        block_send = (block_send - 1) % n
        block_recv = (block_recv - 1) % n
    return steps


def format_plan(topo: Topology, rank: int) -> str:
    """ASCII dump of a rank's schedule, in the spirit of
    ``Operations::print_ops`` (``mpi_mod.hpp:105-131``)."""
    lines = [f"send/recv plan of node {rank} in total {topo.num_nodes} peers (topo {topo}):"]
    sp, rp = send_plan(topo, rank), recv_plan(topo, rank)
    for i in range(topo.num_stages):
        tag = "┕" if i == topo.num_stages - 1 else "┝"
        send_part = " ".join(
            f"| ->{op.peer}: {','.join(map(str, op.blocks))}" for op in sp[i]
        )
        recv_part = " ".join(
            f"| <-{op.peer}: {','.join(map(str, op.blocks))}" for op in rp[i]
        )
        lines.append(f"{tag} stage{i} {send_part}")
        lines.append(f"          {recv_part}")
    return "\n".join(lines)
