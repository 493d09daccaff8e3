"""NumPy simulator backend: executes a FlexTree schedule over N per-rank
arrays in a single process, at message granularity.

A copy of ``flextree_tpu/backends/simulator.py`` (the port imports nothing
of the JAX package), so the port carries its own oracle onto machines
without JAX.

This is the ground-truth oracle for every other backend (the rebuild's answer
to the reference's missing test suite, SURVEY §4) and a faithful model of the
reference execution:

- phase 1 = per-stage send -> recv -> reduce, sends sourced from ``data`` at
  stage 0 and from ``dst`` afterwards (``tree_allreduce``,
  ``mpi_mod.hpp:988-1029``);
- phase 2 = reversed stages with send/recv op lists swapped, received blocks
  landing at their final offsets (``accordingly=true``,
  ``mpi_mod.hpp:1050-1060``);
- tail blocks clamped to the true element count, possibly empty
  (``mpi_mod.hpp:679-696``), rather than padded;
- ring = the 2(N-1)-step neighbor schedule (``mpi_mod.hpp:1113-1163``).

Every transfer goes through an explicit :class:`Mailbox` so tests catch
schedule bugs (sending a block the sender doesn't hold, receiving one nobody
sent) instead of silently reading global state.

Chaos mode: the mailbox is also a *fault-injection* point.  A
:class:`FaultPlan` can drop, duplicate, reorder, corrupt, delay, or hang
any (phase, stage, src, dst, block) message, or kill a rank at a given
stage,
turning the simulator from a correctness oracle into a chaos oracle: every
injected fault is either **recovered** (duplicates are deduplicated by
message tag and record a ``recovered`` event; reorders are absorbed
implicitly because receives match on tag, not arrival order, so only
their injection is recorded) or **detected** with a :class:`FaultDetected` diagnostic
naming the faulty (phase, stage, src, dst, block).  No injected fault can
yield a silently wrong allreduce result: payloads carry CRC32 checksums
computed at send time, verified at receive time (see docs/FAILURE_MODEL.md).
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Mapping

import numpy as np

from ..ops.reduce import ReduceOp, get_op
from ..schedule.blocks import BlockLayout
from ..schedule.plan import owned_blocks, recv_plan, ring_plan, send_plan
from ..schedule.stages import LonelyTopology, Topology

__all__ = [
    "simulate_allreduce",
    "simulate_tree_allreduce",
    "simulate_ring_allreduce",
    "Fault",
    "FaultPlan",
    "FaultEvent",
    "FaultDetected",
    "StageTimeout",
    "ScheduleViolation",
    "FAULT_KINDS",
    "WHOLE_PAYLOAD",
]


class ScheduleViolation(AssertionError):
    """A rank tried to send data it does not hold, or a receive had no
    matching send — the simulator's race/consistency detector."""


class FaultDetected(ScheduleViolation):
    """An injected transport fault was caught by the receiver.

    Carries the structured coordinates of the faulty message so harnesses
    (and tests) can assert the diagnostic names the right (stage, src, dst)
    rather than pattern-matching prose.
    """

    def __init__(self, kind, phase, stage, src, dst, block, note=""):
        self.kind, self.phase, self.stage = kind, phase, stage
        self.src, self.dst, self.block = src, dst, block
        blk = "whole payload" if block == WHOLE_PAYLOAD else f"block {block}"
        super().__init__(
            f"{kind} fault detected at phase {phase} stage {stage}: "
            f"src {src} -> dst {dst}, {blk}" + (f" ({note})" if note else "")
        )


class StageTimeout(FaultDetected):
    """A per-recv deadline expired waiting on a *hung* sender — the
    watchdog conversion of an infinite block into a typed error.

    A ``hang`` fault models a stalled-but-alive peer (SIGSTOP, a wedged
    host): unlike ``drop`` the message was never even posted, and unlike
    ``kill`` the sender still holds its lease.  With
    ``FaultPlan.recv_timeout`` configured the receive bounds its wait and
    raises this (``code == "FT_STEP_TIMEOUT"``, the same taxonomy tag the
    step-level watchdog in ``runtime.watchdog`` uses); without a deadline
    the simulator refuses to model an infinite block silently and raises
    :class:`ScheduleViolation` naming the missing watchdog.
    """

    code = "FT_STEP_TIMEOUT"

    def __init__(self, phase, stage, src, dst, block, timeout_s):
        self.timeout_s = timeout_s
        super().__init__(
            "hang", phase, stage, src, dst, block,
            note=f"recv deadline {timeout_s:g}s exceeded ({self.code})",
        )


FAULT_KINDS = ("drop", "duplicate", "reorder", "corrupt", "delay", "hang")

# block sentinel for single-message transfers carrying a rank's whole buffer
# (the lonely-topology buddy fold/return hops)
WHOLE_PAYLOAD = -1

# execution phases, in time order: 0 = lonely buddy fold, 1 = reduce-scatter
# (ring: every step), 2 = allgather, 3 = lonely buddy return
_PHASE_NAMES = {0: "lonely-fold", 1: "reduce", 2: "gather", 3: "lonely-return"}


@dataclass(frozen=True)
class Fault:
    """One injected transport fault.  ``None`` coordinates match anything,
    so ``Fault("corrupt")`` corrupts every message while
    ``Fault("drop", stage=1, src=2, dst=0, block=3)`` snipes one block."""

    kind: str
    stage: int | None = None
    src: int | None = None
    dst: int | None = None
    block: int | None = None
    phase: int | None = None

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; choose from {FAULT_KINDS}"
            )

    def matches(self, phase, stage, src, dst, block) -> bool:
        return (
            (self.phase is None or self.phase == phase)
            and (self.stage is None or self.stage == stage)
            and (self.src is None or self.src == src)
            and (self.dst is None or self.dst == dst)
            and (self.block is None or self.block == block)
        )


@dataclass(frozen=True)
class FaultEvent:
    """What the transport did about one injected fault occurrence."""

    kind: str
    action: str  # "injected" | "recovered" | "detected"
    phase: int
    stage: int
    src: int
    dst: int
    block: int
    note: str = ""


@dataclass
class FaultPlan:
    """A chaos scenario: transport faults plus rank kills.

    ``faults``: :class:`Fault` specs matched against every message.
    ``kill``: ``{rank: stage}`` — the rank stops sending *and* receiving
    from phase-1 stage ``stage`` onward (stage ``0`` kills it before its
    first tree message; for the ring, ``stage`` is the step index).  Kills
    at or past the schedule's last step are never observable and therefore
    never detected.
    ``recv_timeout``: the modeled per-recv deadline in seconds (the
    message-granularity twin of the step watchdog's ``FT_STEP_TIMEOUT``).
    With it set, a receive whose sender *hung* (a ``hang`` fault) raises
    a typed :class:`StageTimeout` instead of blocking forever; without
    it, the hang surfaces as a :class:`ScheduleViolation` naming the
    missing deadline — the simulator never silently models an infinite
    block.
    ``events``: populated during simulation — one entry per injection,
    plus one per dedup recovery or detection (reorder recovery is implicit
    in tag matching and records injection only), so harnesses can assert
    faults were *exercised*, not silently unmatched.
    """

    faults: tuple[Fault, ...] = ()
    kill: Mapping[int, int] = field(default_factory=dict)
    recv_timeout: float | None = None
    events: list[FaultEvent] = field(default_factory=list)

    def __post_init__(self):
        self.faults = tuple(
            Fault(**f) if isinstance(f, dict) else f for f in self.faults
        )

    def find(self, kind, phase, stage, src, dst, block) -> Fault | None:
        for f in self.faults:
            if f.kind == kind and f.matches(phase, stage, src, dst, block):
                return f
        return None

    def dead_at(self, rank: int, time: int) -> bool:
        """Whether ``rank`` is dead at schedule time ``time`` (phase-1 stage
        index; phase-2 stage ``i`` of a k-stage tree is time ``2k-1-i``)."""
        s = self.kill.get(rank)
        return s is not None and time >= s

    def record(self, kind, action, phase, stage, src, dst, block, note=""):
        self.events.append(
            FaultEvent(kind, action, phase, stage, src, dst, block, note)
        )


class Mailbox:
    """The per-stage message transport: tag-matched, checksummed, and the
    single fault-injection point.

    Every message is addressed by the tag (phase, stage, src, dst, block)
    and carries a CRC32 of its payload computed at *send* time — the
    receive path re-verifies it, so in-flight corruption is detected, not
    absorbed.  Duplicate deliveries of the same tag are deduplicated
    (recovered); reordered deliveries are absorbed because receives match
    on the tag, not arrival order.  Dropped, delayed, and dead-sender
    messages surface as :class:`FaultDetected` at the receive that needed
    them, naming the faulty coordinates.
    """

    def __init__(self, plan: FaultPlan, phase: int, stage: int, time: int):
        self.plan, self.phase, self.stage, self.time = plan, phase, stage, time
        # (dst, src) -> list of (block, data, crc) in delivery order
        self._queues: dict[tuple[int, int], list] = {}
        self._lost: dict[tuple[int, int, int], str] = {}  # tag tail -> cause
        self._boxes: dict[tuple[int, int], dict] = {}

    # ---- send side --------------------------------------------------------

    def open(self, src: int, dst: int) -> bool:
        """Announce a (possibly empty) message from ``src`` to ``dst``;
        returns False when the sender is dead (nothing will arrive)."""
        if self.plan.dead_at(src, self.time):
            return False
        self._queues.setdefault((dst, src), [])
        return True

    def post(self, src: int, dst: int, block: int, data: np.ndarray):
        args = (self.phase, self.stage, src, dst, block)
        if not self.open(src, dst):
            return
        crc = zlib.crc32(np.ascontiguousarray(data).tobytes())
        if self.plan.find("hang", *args):
            # a stalled sender: the message is never posted at all (vs drop,
            # where it was sent and lost) — the receive path converts this
            # into StageTimeout when a recv deadline is configured
            self.plan.record(
                "hang", "injected", *args, note="sender stalled mid-stage"
            )
            self._lost[(src, dst, block)] = "sender hung mid-stage"
            return
        if self.plan.find("drop", *args):
            self.plan.record("drop", "injected", *args, note="message lost")
            self._lost[(src, dst, block)] = "dropped in transit"
            return
        if self.plan.find("delay", *args):
            self.plan.record(
                "delay", "injected", *args, note="held past stage deadline"
            )
            self._lost[(src, dst, block)] = "delayed past the stage deadline"
            return
        if self.plan.find("corrupt", *args) and data.size:
            # a real in-flight bit flip, post-checksum; zero-length payloads
            # (empty tail blocks when count < n) have no bytes to flip, so
            # the fault is unobservable there and not recorded as injected
            data = np.array(data, copy=True)
            raw = data.view(np.uint8)
            raw.flat[0] ^= 0xFF
            self.plan.record("corrupt", "injected", *args, note="bit flip")
        q = self._queues[(dst, src)]
        q.append((block, data, crc))
        if self.plan.find("duplicate", *args):
            self.plan.record("duplicate", "injected", *args)
            q.append((block, data, crc))
        if self.plan.find("reorder", *args):
            self.plan.record(
                "reorder", "injected", *args, note="delivery order scrambled"
            )
            q.reverse()

    # ---- receive side -----------------------------------------------------

    def _box(self, dst: int, src: int) -> dict:
        """Tag-match the delivery queue into {block: (data, crc)} once."""
        key = (dst, src)
        if key not in self._boxes:
            box = {}
            for block, data, crc in self._queues.get(key, ()):
                if block in box:  # same tag delivered twice: dedup
                    self.plan.record(
                        "duplicate", "recovered",
                        self.phase, self.stage, src, dst, block,
                        note="deduplicated by message tag",
                    )
                    continue
                box[block] = (data, crc)
            self._boxes[key] = box
        return self._boxes[key]

    def expect(self, dst: int, src: int):
        """The receiver's handshake: raise when no message was announced."""
        if (dst, src) in self._queues:
            return
        if self.plan.dead_at(src, self.time):
            raise FaultDetected(
                "kill", self.phase, self.stage, src, dst, WHOLE_PAYLOAD,
                note=f"rank {src} died at stage {self.plan.kill[src]}",
            )
        raise ScheduleViolation(
            f"stage {self.stage}: rank {dst} expects data from {src}, none sent"
        )

    def fetch(self, dst: int, src: int, block: int) -> np.ndarray:
        self.expect(dst, src)
        box = self._box(dst, src)
        if block not in box:
            cause = self._lost.get((src, dst, block))
            if cause is not None:
                if "hung" in cause:
                    if self.plan.recv_timeout is None:
                        # refusing to model an infinite block silently: a
                        # hung sender with no recv deadline IS the hang-
                        # forever bug the watchdog exists to prevent
                        raise ScheduleViolation(
                            f"{_PHASE_NAMES[self.phase]} stage {self.stage}: "
                            f"rank {dst} would block FOREVER on hung sender "
                            f"{src} (block {block}) — no recv deadline "
                            f"configured (FaultPlan.recv_timeout / "
                            f"FT_STEP_TIMEOUT)"
                        )
                    self.plan.record(
                        "hang", "detected", self.phase, self.stage, src, dst,
                        block, note=cause,
                    )
                    raise StageTimeout(
                        self.phase, self.stage, src, dst, block,
                        self.plan.recv_timeout,
                    )
                kind = "delay" if "delay" in cause else "drop"
                self.plan.record(
                    kind, "detected", self.phase, self.stage, src, dst, block,
                    note=cause,
                )
                raise FaultDetected(
                    kind, self.phase, self.stage, src, dst, block, note=cause
                )
            raise ScheduleViolation(
                f"{_PHASE_NAMES[self.phase]} stage {self.stage}: rank {dst} "
                f"needs block {block} from {src}, not sent"
            )
        data, crc = box[block]
        if zlib.crc32(np.ascontiguousarray(data).tobytes()) != crc:
            self.plan.record(
                "corrupt", "detected", self.phase, self.stage, src, dst,
                block, note="checksum mismatch",
            )
            raise FaultDetected(
                "corrupt", self.phase, self.stage, src, dst, block,
                note="checksum mismatch",
            )
        return data


_NO_FAULTS = None  # lazily-built shared empty plan


def _resolve_plan(faults) -> FaultPlan:
    global _NO_FAULTS
    if faults is None:
        if _NO_FAULTS is None:
            _NO_FAULTS = FaultPlan()
        return _NO_FAULTS
    if isinstance(faults, FaultPlan):
        return faults
    return FaultPlan(faults=tuple(faults))


def _as_matrix(inputs) -> np.ndarray:
    arr = np.asarray(inputs)
    if arr.ndim != 2:
        raise ValueError(
            f"inputs must be 2-D (num_ranks, count), one row per rank; got shape {arr.shape}"
        )
    return arr


def simulate_allreduce(inputs, topo=None, op="sum", faults=None) -> np.ndarray:
    """Allreduce over ``inputs[r]`` per rank; returns the (N, count) result
    (every row identical).  Routes ring vs tree exactly like the reference
    entry point (``MPI_Allreduce_FT``, ``mpi_mod.hpp:1193-1215``).

    ``faults``: an optional :class:`FaultPlan` (or iterable of
    :class:`Fault`) driving the transport through failure — see the module
    docstring for the detect/recover contract.
    """
    data = _as_matrix(inputs)
    n = data.shape[0]
    topo = Topology.resolve(n, topo)
    rop = get_op(op)
    rop.check_dtype(data.dtype)
    plan = _resolve_plan(faults)
    if n <= 1:  # trivial world, reference memcpy fast path (mpi_mod.hpp:1181-1188)
        return data.copy()
    if isinstance(topo, LonelyTopology):
        # the lonely protocol (stages.LonelyTopology): fold each lonely
        # rank m+i into buddy i, tree over the first m rows, hand back.
        # Both buddy hops ride the mailbox so chaos reaches them too
        # (phase 0 = fold at time -1, phase 3 = return past the tree's end).
        m = topo.tree.num_nodes
        steps = 2 * topo.tree.num_stages
        # the fold shares time 0 with tree stage 0 (a rank killed "at stage
        # 0" is dead from the very start, fold included); the return runs
        # one tick past the tree's end
        fold = Mailbox(plan, phase=0, stage=0, time=0)
        back = Mailbox(plan, phase=3, stage=0, time=steps)
        folded = data[:m].copy()
        for i in range(topo.lonely):
            fold.post(m + i, i, WHOLE_PAYLOAD, data[m + i])
        for i in range(topo.lonely):
            folded[i] = rop.np_fn(folded[i], fold.fetch(i, m + i, WHOLE_PAYLOAD))
        out = simulate_tree_allreduce(folded, topo.tree, rop, plan)
        for i in range(topo.lonely):
            back.post(i, m + i, WHOLE_PAYLOAD, out[i])
        result = np.tile(out[0], (n, 1))
        for i in range(topo.lonely):
            if plan.dead_at(m + i, steps):
                # a dead lonely rank receives nothing; the collective still
                # completes for survivors (its contribution was folded in
                # before it died) — degrade-to-survivors, recorded
                plan.record(
                    "kill", "recovered", 3, 0, i, m + i, WHOLE_PAYLOAD,
                    note="dead lonely rank skipped at result return",
                )
                continue
            result[m + i] = back.fetch(m + i, i, WHOLE_PAYLOAD)
        return result
    if topo.is_ring:
        return simulate_ring_allreduce(data, rop, plan)
    return simulate_tree_allreduce(data, topo, rop, plan)


def simulate_tree_allreduce(
    data: np.ndarray, topo: Topology, rop: ReduceOp, faults=None
) -> np.ndarray:
    plan = _resolve_plan(faults)
    n, count = data.shape
    layout = BlockLayout(n, count)
    sp = [send_plan(topo, r) for r in range(n)]
    rp = [recv_plan(topo, r) for r in range(n)]
    k = topo.num_stages
    # dst starts poisoned: anything not written by the schedule must never
    # be read, and the final check below proves full coverage.
    if np.issubdtype(data.dtype, np.floating):
        dst = np.full_like(data, np.nan)
    else:
        dst = np.full_like(data, 0)
    written = np.zeros((n, count), dtype=bool)

    # ---- phase 1: hierarchical reduce-scatter -------------------------------
    for i in range(k):
        src_buf = data if i == 0 else dst
        box = Mailbox(plan, phase=1, stage=i, time=i)
        for r in range(n):
            if plan.dead_at(r, i):
                continue
            held = set(owned_blocks(topo, r, i)) if i else set(range(n))
            for op_ in sp[r][i]:
                if op_.peer == r:
                    continue  # transport skips self (mpi_mod.hpp:676)
                box.open(r, op_.peer)
                for b in op_.blocks:
                    if b not in held:
                        raise ScheduleViolation(
                            f"stage {i}: rank {r} sends block {b} it does not hold"
                        )
                    s, l = layout.span(b)
                    if l == 0:
                        continue  # empty tail block skipped (mpi_mod.hpp:692-696)
                    box.post(r, op_.peer, b, src_buf[r, s : s + l].copy())
        for r in range(n):
            if plan.dead_at(r, i):
                continue  # a dead rank stops receiving/reducing
            mine = owned_blocks(topo, r, i + 1)
            for recv_op in rp[r][i]:
                if recv_op.peer == r:
                    continue
                box.expect(r, recv_op.peer)
            for b in mine:
                s, l = layout.span(b)
                if l == 0:
                    continue
                acc = src_buf[r, s : s + l].copy()
                for peer in topo.group_members(i, r):
                    if peer == r:
                        continue
                    acc = rop.np_fn(acc, box.fetch(r, peer, b))
                dst[r, s : s + l] = acc
                written[r, s : s + l] = True

    # ---- phase 2: hierarchical allgather (reversed, roles swapped) ----------
    for i in reversed(range(k)):
        t = 2 * k - 1 - i
        box = Mailbox(plan, phase=2, stage=i, time=t)
        for r in range(n):
            if plan.dead_at(r, t):
                continue
            held = set(owned_blocks(topo, r, i + 1))
            # phase-2 send uses the *recv* op list (mpi_mod.hpp:1056)
            for op_ in rp[r][i]:
                if op_.peer == r:
                    continue
                box.open(r, op_.peer)
                for b in op_.blocks:
                    if b not in held:
                        raise ScheduleViolation(
                            f"phase2 stage {i}: rank {r} sends unheld block {b}"
                        )
                    s, l = layout.span(b)
                    if l == 0:
                        continue
                    box.post(r, op_.peer, b, dst[r, s : s + l].copy())
        for r in range(n):
            if plan.dead_at(r, t):
                continue
            # phase-2 recv uses the *send* op list, accordingly=true
            # (mpi_mod.hpp:1057): blocks land at their final offsets.
            for op_ in sp[r][i]:
                if op_.peer == r:
                    continue
                for b in op_.blocks:
                    s, l = layout.span(b)
                    if l == 0:
                        continue
                    dst[r, s : s + l] = box.fetch(r, op_.peer, b)
                    written[r, s : s + l] = True

    survivors = [r for r in range(n) if not plan.dead_at(r, 2 * k - 1)]
    if count and not written[survivors].all():
        missing = np.argwhere(~written[survivors])[:4]
        raise ScheduleViolation(f"blocks never written, e.g. (rank, elem) {missing.tolist()}")
    return dst


def simulate_ring_allreduce(data: np.ndarray, rop: ReduceOp, faults=None) -> np.ndarray:
    """Classic 2(N-1)-step ring (``ring_allreduce``, ``mpi_mod.hpp:1113-1163``):
    N-1 reduce-scatter steps + N-1 allgather steps, one block per step."""
    plan = _resolve_plan(faults)
    n, count = data.shape
    layout = BlockLayout(n, count)
    plans = [ring_plan(n, r) for r in range(n)]
    dst = data.copy()
    for step in range(2 * (n - 1)):
        reduce_phase = step < n - 1
        box = Mailbox(plan, phase=1 if reduce_phase else 2, stage=step, time=step)
        for r in range(n):
            if plan.dead_at(r, step):
                continue
            send_op, _ = plans[r][step]
            (b,) = send_op.blocks
            s, l = layout.span(b)
            box.post(r, send_op.peer, b, dst[r, s : s + l].copy())
        for r in range(n):
            if plan.dead_at(r, step):
                continue
            _, recv_op = plans[r][step]
            (b,) = recv_op.blocks
            payload = box.fetch(r, recv_op.peer, b)
            s, l = layout.span(b)
            if reduce_phase:
                dst[r, s : s + l] = rop.np_fn(dst[r, s : s + l], payload)
            else:
                dst[r, s : s + l] = payload
    return dst
