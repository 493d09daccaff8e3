"""Schedule validator: static race/consistency checking for tree and ring
schedules.

A copy of ``flextree_tpu/schedule/validate.py`` (the port imports nothing
of the JAX package).

The reference has no sanitizer — correctness rests on ``MPI_Waitall`` before
each reduce and per-stage barriers (``mpi_mod.hpp:1003, 1028``; SURVEY §5
"Race detection" row).  In a pure-functional XLA program the *execution* can't
race, but a malformed schedule can still silently mis-reduce (a block counted
twice, a block never delivered, send/recv plans that disagree).  This module
proves the invariants that make a schedule an allreduce, before it ever
touches a device:

1. **Partition** — at stage ``i``, the blocks rank ``r`` sends to its group
   peers partition ``r``'s currently-owned residue set ``{b : b ≡ r mod g}``:
   every owned block goes to exactly one peer (no duplicate contribution, no
   dropped block).
2. **Send/recv agreement** — for every (sender, receiver, stage), the blocks
   the sender plans to send equal the blocks the receiver expects — the
   static analog of matching ``MPI_Isend``/``MPI_Irecv`` pairs.
3. **Convergence** — after all stages each rank exclusively owns
   ``{b : b ≡ r mod N}`` and the per-rank owned sets tile ``[0, N)``; phase 2
   (stages reversed, roles swapped) restores full ownership everywhere.
4. **Ring walk** — the 2(N−1)-step ring schedule's send/recv block indices
   chain correctly (block received at step s is the block sent at step s+1)
   and every rank ends owning all N blocks.

``validate_topology`` runs 1-3 for a tree shape; ``validate_ring`` runs 4;
``validate`` dispatches on the topology.  All raise :class:`ScheduleError`
with a precise description on the first violation, and return a small stats
summary otherwise (used by tests and the planner's sanity mode).
"""

from __future__ import annotations

from dataclasses import dataclass

from .plan import recv_plan, ring_plan, send_plan
from .stages import Topology

__all__ = [
    "ScheduleError",
    "ValidationStats",
    "validate",
    "validate_topology",
    "validate_ring",
    "stage_matches",
]


class ScheduleError(AssertionError):
    """A schedule violates an allreduce invariant."""


@dataclass(frozen=True)
class ValidationStats:
    num_nodes: int
    widths: tuple[int, ...]
    stages: int
    p2p_messages: int  # total cross-rank (peer != self) ops, both phases


def validate(topo) -> ValidationStats:
    """Validate any topology (ring sentinel, k-ary tree, or tree+lonely)."""
    from .stages import LonelyTopology

    if isinstance(topo, LonelyTopology):
        # the tree part carries all schedule structure; the lonely protocol
        # adds one fold ppermute and one restore ppermute per lonely rank,
        # each a distinct (buddy, lonely) pair — structurally race-free by
        # construction (validated here as message accounting)
        tree_stats = validate_topology(topo.tree)
        return ValidationStats(
            num_nodes=topo.num_nodes,
            widths=tree_stats.widths,
            stages=tree_stats.stages,
            p2p_messages=tree_stats.p2p_messages + 2 * topo.lonely,
        )
    if topo.is_ring:
        return validate_ring(topo.num_nodes)
    return validate_topology(topo)


def validate_topology(topo: Topology) -> ValidationStats:
    n = topo.num_nodes
    messages = 0
    # generate every rank's plans once (the agreement loop below indexes
    # into peers' plans, so recomputing per-op would be O(n^2) plan builds)
    sends = [send_plan(topo, r) for r in range(n)]
    recvs = [recv_plan(topo, r) for r in range(n)]

    # ownership derived from the PLANS (not from widths arithmetic, which
    # Topology already enforces): after stage i, rank r holds the partial
    # sums of exactly the blocks its stage-i recv ops name.
    owned = [set(range(n)) for _ in range(n)]  # before stage 0: all blocks

    for r in range(n):
        sp, rp = sends[r], recvs[r]
        if len(sp) != topo.num_stages or len(rp) != topo.num_stages:
            raise ScheduleError(f"rank {r}: plan has wrong stage count")
        for i in range(topo.num_stages):
            sent: dict[int, int] = {}
            for op in sp[i]:
                for b in op.blocks:
                    if b in sent:
                        raise ScheduleError(
                            f"rank {r} stage {i}: block {b} sent to both "
                            f"peer {sent[b]} and peer {op.peer} (double count)"
                        )
                    sent[b] = op.peer
            if set(sent) != owned[r]:
                missing = owned[r] - set(sent)
                extra = set(sent) - owned[r]
                raise ScheduleError(
                    f"rank {r} stage {i}: send set != owned block set "
                    f"(missing {sorted(missing)}, extra {sorted(extra)})"
                )
            kept: set[int] = set()
            for op in rp[i]:
                kept |= set(op.blocks)
            if not kept <= owned[r]:
                raise ScheduleError(
                    f"rank {r} stage {i}: recv plan claims blocks "
                    f"{sorted(kept - owned[r])} the rank does not hold"
                )
            owned[r] = kept

    for i in range(topo.num_stages):
        # each stage's message count: cross-rank sends, both phases
        for r in range(n):
            messages += sum(1 for op in sends[r][i] if op.peer != r) * 2

    # send/recv agreement: sender's blocks for peer p == p's expected set
    # (stage_matches raises on the first asymmetry; the walk itself is the
    # check, and its match table is what analysis.schedule_check builds its
    # per-rank message program from)
    for _ in stage_matches(topo, sends=sends, recvs=recvs):
        pass

    # convergence: the plan-derived final ownership tiles [0, N) exclusively
    seen: set[int] = set()
    for r, s in enumerate(owned):
        if seen & s:
            raise ScheduleError(f"rank {r}: final owned blocks {sorted(s)} overlap")
        seen |= s
    if seen != set(range(n)):
        raise ScheduleError(f"final ownership covers {sorted(seen)}, not [0, {n})")

    # phase 2 (stages reversed, roles swapped): replay forwarding and prove
    # every rank ends holding all N blocks, never forwarding a block the
    # sender doesn't hold at that point — the docstring's invariant 3.
    holdings = [set(s) for s in owned]
    for i in reversed(range(topo.num_stages)):
        new_holdings = [set(h) for h in holdings]
        for r in range(n):
            # phase-2: rank r receives, via its *send*-plan ops, each peer's
            # currently-held slice of those blocks (roles swap; the blocks
            # land at final offsets — mpi_mod.hpp:1056-1057 with
            # accordingly=true)
            for op in sends[r][i]:
                if op.peer == r:
                    continue
                inbound = set(recvs[op.peer][i][0].blocks)
                if not inbound <= holdings[op.peer]:
                    raise ScheduleError(
                        f"phase2 stage {i}: rank {op.peer} forwards blocks "
                        f"{sorted(inbound - holdings[op.peer])} it does not hold"
                    )
                new_holdings[r] |= inbound
        holdings = new_holdings
    for r in range(n):
        if holdings[r] != set(range(n)):
            raise ScheduleError(
                f"rank {r}: phase 2 restored only {len(holdings[r])}/{n} blocks"
            )

    return ValidationStats(n, topo.widths, topo.num_stages, messages)


def stage_matches(topo: Topology, sends=None, recvs=None):
    """Yield every matched (stage, src, dst, blocks) phase-1 exchange.

    The static analog of pairing each ``MPI_Isend`` with its ``MPI_Irecv``:
    for every cross-rank send op, the receiver must hold *exactly one*
    recv op naming the sender, with the identical block set — the
    agreement invariant (docstring item 2) exposed as an iterable so
    downstream analyses (``flextree_tpu.analysis.schedule_check``'s match
    graph, traffic accounting) can walk the matched pairs instead of
    re-deriving them.  Raises :class:`ScheduleError` on the first
    unmatched or disagreeing pair.  ``sends``/``recvs`` accept
    precomputed plan lists (the validator passes its own to avoid
    rebuilding O(n) plans).
    """
    n = topo.num_nodes
    if sends is None:
        sends = [send_plan(topo, r) for r in range(n)]
    if recvs is None:
        recvs = [recv_plan(topo, r) for r in range(n)]
    for r in range(n):
        for i in range(topo.num_stages):
            for op in sends[r][i]:
                match = [o for o in recvs[op.peer][i] if o.peer == r]
                if len(match) != 1 or set(match[0].blocks) != set(op.blocks):
                    raise ScheduleError(
                        f"stage {i}: rank {r} sends {sorted(op.blocks)} to "
                        f"{op.peer}, but {op.peer} expects "
                        f"{sorted(match[0].blocks) if match else None} from {r}"
                    )
                if op.peer != r:
                    yield i, r, op.peer, tuple(op.blocks)


def validate_ring(n: int) -> ValidationStats:
    if n < 1:
        raise ScheduleError(f"ring needs n >= 1, got {n}")
    plans = [ring_plan(n, r) for r in range(n)]  # build once: O(n^2) total
    for r in range(n):
        steps = plans[r]
        left_steps = plans[(r - 1) % n]
        if len(steps) != 2 * (n - 1):
            raise ScheduleError(f"rank {r}: ring has {len(steps)} steps, want {2*(n-1)}")
        owned = {r}  # blocks whose partial this rank has folded (reduce phase)
        for s, (snd, rcv) in enumerate(steps[: n - 1]):
            if snd.peer != (r + 1) % n or rcv.peer != (r - 1) % n:
                raise ScheduleError(f"rank {r} step {s}: wrong ring neighbors")
            # what the left neighbor sends at step s must be what we receive
            if left_steps[s][0].blocks != rcv.blocks:
                raise ScheduleError(
                    f"rank {r} step {s}: expects block {rcv.blocks} from left, "
                    f"left sends {left_steps[s][0].blocks}"
                )
            owned.add(rcv.blocks[0])
        if owned != set(range(n)):
            raise ScheduleError(
                f"rank {r}: reduce phase touched blocks {sorted(owned)}, "
                f"expected all of [0, {n})"
            )
        # allgather phase: after n-1 forwarding steps every block arrives
        have = {(r + 1) % n}  # the block fully reduced here after phase 1...
        for s, (snd, rcv) in enumerate(steps[n - 1 :]):
            if left_steps[n - 1 + s][0].blocks != rcv.blocks:
                raise ScheduleError(f"rank {r} gather step {s}: send/recv mismatch")
            have.add(rcv.blocks[0])
        if len(have) != n:
            raise ScheduleError(
                f"rank {r}: allgather delivered {len(have)} distinct blocks, want {n}"
            )
    return ValidationStats(n, (1,), 1, 2 * (n - 1) * n)
