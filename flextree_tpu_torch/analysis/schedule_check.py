"""Layer 1: schedule model checker — prove a generated message program
deadlock-free and conservation-correct before it touches a device.

A copy of the IR part of ``flextree_tpu/analysis/schedule_check.py`` (the
port imports nothing of the JAX package); its phase-program checks of the
standalone reduce-scatter and all-gather are not ported (ROADMAP.md,
Queue 1: 'JAX-specific static analysis, last').

``schedule/validate.py`` proves invariants of the *plans* (partition,
send/recv agreement, convergence).  This layer goes one level down: it
builds the explicit per-rank **message program** a schedule executes —
every send/recv half, in issue order, for every schedule family (tree /
ring / lonely / swing / generalized) and for the chunk-pipelined mode
(``chunks=C``) — and model-checks the program itself.  A corruption is
seeded into the *program* (the thing a transport would actually run), so
a checker that silently re-derived everything from the pristine plans
would prove nothing.

Every schedule is emitted as a declarative IR program
(``schedule/ir.py``) and :func:`program_from_ir` is the ONE mechanical
conversion from IR stages to the per-rank message program — the checker
and the executable (``schedule.ir.compile_ir``) derive from the same
object.  A new family gets deadlock/conservation proofs by writing an
emitter, nothing else.

Checks (every violation names ``(stage, src, dst, block)``):

1. **Peer symmetry** — every send half has exactly one matching recv half
   in the same round and vice versa, with equal block sets (the
   program-level twin of ``validate.stage_matches``).
2. **Deadlock-freedom** — the program is executed under *blocking
   rendezvous* semantics (each rank issues its post-sets strictly in
   order; a post-set completes only when every half finds its counterpart
   concurrently pending).  The checker runs that abstract machine to
   quiescence: termination proves no cycle among blocking matches exists
   under even the most pessimistic transport (no buffering); a stuck
   frontier is reported as a deadlock cycle.  The port's transports are
   more forgiving — this is deliberately the strongest transport model.
3. **Chunk conservation** — per chunk, replayed from the program's own
   halves: every reduce-scatter stage's sends partition the sender's
   owned set (no block reduced twice, none dropped), final scatter
   ownership tiles ``[0, N)``, and the allgather phase's closure leaves
   every rank holding the full reduced vector.
4. **Chunk-buffer overlap** — the chunk-pipelined mode slices one buffer;
   the per-chunk element spans must be pairwise disjoint and tile the
   divisible head exactly, so interleaved phases can never alias.
5. **Watchdog contract** — every executed schedule carries the
   runtime-deadline wrapper (``Program.watchdogged``): a timeout-wrapped
   rendezvous cannot deadlock *forever* (the runtime converts the block
   into a typed ``FT_STEP_TIMEOUT``), so a program that loses the wrapper
   is an ``unbounded-wait`` violation regardless of its message pattern.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from ..schedule import ir as sir
from ..schedule.stages import TopologyError
from ..schedule.validate import ScheduleError
from .base import Violation

__all__ = [
    "Half",
    "PostSet",
    "Program",
    "program_from_ir",
    "check_ir",
    "check_program",
    "default_ir_matrix",
    "check_ir_families",
]

SEND, RECV = "send", "recv"


@dataclass(frozen=True)
class Half:
    """One direction of one point-to-point transfer, as issued by ``rank``:
    ``(kind=send, peer)`` means rank -> peer, ``(kind=recv, peer)`` means
    peer -> rank.  ``blocks`` are chunk-local block indices in ``[0, N)``."""

    kind: str
    peer: int
    blocks: tuple[int, ...]


@dataclass
class PostSet:
    """Halves one rank posts *together* (nonblocking post + wait-all), the
    unit of progress in the rendezvous machine.  A tree-stage pairwise
    exchange is a 2-half post-set (send+recv, same peer); a ring step is a
    2-half post-set (send right, recv left); a lonely fold/restore hop is a
    single half."""

    rank: int
    halves: list[Half]
    # coordinates for violation reports
    chunk: int
    phase: str  # "rs" | "ag" | "fold" | "restore"
    stage: int


@dataclass
class Program:
    """The full message program of one schedule execution."""

    num_nodes: int
    kind: str  # "tree" | "ring" | "lonely"
    # per-rank ordered post-sets (issue order == trace order)
    posts: dict[int, list[PostSet]] = field(default_factory=dict)
    num_stages: int = 1
    chunks: int = 1
    # per-chunk element spans (offset, size) into the flat divisible head
    chunk_spans: list[tuple[int, int]] = field(default_factory=list)
    head_elems: int = 0
    # the watchdog contract: every executed schedule runs under a recv/step
    # deadline (fit's StepWatchdog, the simulator's FaultPlan.recv_timeout),
    # so a blocking rendezvous is BOUNDED — a deadlock is surfaced as a
    # typed FT_STEP_TIMEOUT at runtime, never an infinite hang.  A program
    # that loses this wrapper is itself a violation ("unbounded-wait"),
    # independent of its message pattern being correct.
    watchdogged: bool = True

    def postsets(self):
        for rank in sorted(self.posts):
            yield from self.posts[rank]


# --------------------------------------------------------------------- build


def _append_ir_stage(prog: Program, st: "sir.IRStage", scheduled: int) -> None:
    """Convert ONE IR stage into per-rank post-sets.

    Grouped stages post one set per participating rank with per-peer
    (send, recv) half pairs in group order — the nonblocking post +
    wait-all unit a grouped tree stage is.  Pair stages post each
    rank's sends then its recvs (a ring/swing step is send-right +
    recv-left together; a one-sided fold/restore hop is a single half).
    Whole-buffer hops (``blocks=()``) carry every scheduled block.
    """
    all_blocks = tuple(range(scheduled))
    if st.lowering == "grouped":
        send_map = {(x.src, x.dst): x.blocks for x in st.xfers}
        for grp in st.groups:
            for r in grp:
                halves = []
                for peer in grp:
                    if peer == r:
                        continue
                    halves.append(Half(SEND, peer, send_map[(r, peer)]))
                    halves.append(Half(RECV, peer, send_map[(peer, r)]))
                prog.posts.setdefault(r, []).append(
                    PostSet(r, halves, st.chunk, st.phase, st.index)
                )
        return
    sends: dict[int, list[Half]] = {}
    recvs: dict[int, list[Half]] = {}
    for x in st.xfers:
        blocks = x.blocks if x.blocks else all_blocks
        sends.setdefault(x.src, []).append(Half(SEND, x.dst, blocks))
        recvs.setdefault(x.dst, []).append(Half(RECV, x.src, blocks))
    for r in sorted(set(sends) | set(recvs)):
        halves = sends.get(r, []) + recvs.get(r, [])
        prog.posts.setdefault(r, []).append(
            PostSet(r, halves, st.chunk, st.phase, st.index)
        )


def program_from_ir(ir_prog: "sir.IRProgram") -> Program:
    """The ONE expansion: IR stages -> the per-rank message program.

    This is what makes the IR the single source of truth — the compiler
    lowers ``ir_prog.stages`` and this function expands the same stages
    for the model checker, so a schedule bug cannot hide in a divergence
    between two hand-written expansions.
    """
    prog = Program(
        ir_prog.num_nodes,
        ir_prog.family,
        num_stages=ir_prog.num_stages,
        chunks=ir_prog.chunks,
    )
    prog.head_elems = ir_prog.head_elems
    prog.chunk_spans = list(ir_prog.chunk_spans)
    for st in ir_prog.stages:
        _append_ir_stage(prog, st, ir_prog.scheduled)
    return prog


def check_ir(ir_prog: "sir.IRProgram") -> list[Violation]:
    """Model-check an IR program: expand via :func:`program_from_ir`, run
    every program check.  ``schedule.ir.compile_ir`` calls this before
    lowering and refuses the program on any violation."""
    return check_program(program_from_ir(ir_prog))


# --------------------------------------------------------------------- check


def _check_symmetry(prog: Program) -> list[Violation]:
    """Every send half must pair with exactly one recv half at the peer, in
    the same (chunk, phase, stage), with the identical block set."""
    out: list[Violation] = []
    index: dict[tuple, list[Half]] = {}
    for ps in prog.postsets():
        for h in ps.halves:
            index.setdefault(
                (ps.chunk, ps.phase, ps.stage, ps.rank, h.kind), []
            ).append(h)

    def name(ps):
        return f"{prog.kind} chunk{ps.chunk}/{ps.phase}"

    for ps in prog.postsets():
        for h in ps.halves:
            want = RECV if h.kind == SEND else SEND
            mates = [
                m
                for m in index.get(
                    (ps.chunk, ps.phase, ps.stage, h.peer, want), []
                )
                if m.peer == ps.rank
            ]
            src, dst = (
                (ps.rank, h.peer) if h.kind == SEND else (h.peer, ps.rank)
            )
            if len(mates) != 1:
                out.append(
                    Violation(
                        "schedule",
                        "asymmetric-match",
                        name(ps),
                        f"{h.kind} half {src}->{dst} has {len(mates)} "
                        f"counterpart halves (want exactly 1)",
                        stage=ps.stage,
                        src=src,
                        dst=dst,
                        block=h.blocks[0] if h.blocks else None,
                    )
                )
            elif set(mates[0].blocks) != set(h.blocks):
                diff = set(mates[0].blocks) ^ set(h.blocks)
                out.append(
                    Violation(
                        "schedule",
                        "asymmetric-match",
                        name(ps),
                        f"{src}->{dst} disagrees on blocks: one side "
                        f"{sorted(h.blocks)}, other {sorted(mates[0].blocks)}",
                        stage=ps.stage,
                        src=src,
                        dst=dst,
                        block=min(diff) if diff else None,
                    )
                )
    return out


def _check_deadlock(prog: Program) -> list[Violation]:
    """Run the blocking-rendezvous abstract machine to quiescence.

    Each rank's post-sets issue strictly in order.  A pending half matches
    when its counterpart half (same chunk/phase/stage coordinates, mirrored
    direction, equal blocks) is pending at the peer; a post-set completes
    when all its halves match; completion is simultaneous across ranks.
    If the machine quiesces before every post-set completed, the frontier
    is a genuine wait-for cycle (or an unmatched blocking op) — reported
    per stuck rank with the exchange it is blocked on.
    """
    ptr = {r: 0 for r in prog.posts}
    queues = {r: prog.posts[r] for r in prog.posts}

    def frontier(r):
        q = queues[r]
        return q[ptr[r]] if ptr[r] < len(q) else None

    def half_matches(ps: PostSet, h: Half) -> bool:
        mate = frontier(h.peer)
        if mate is None:
            return False
        if (mate.chunk, mate.phase, mate.stage) != (
            ps.chunk,
            ps.phase,
            ps.stage,
        ):
            return False
        want = RECV if h.kind == SEND else SEND
        return any(
            m.kind == want
            and m.peer == ps.rank
            and set(m.blocks) == set(h.blocks)
            for m in mate.halves
        )

    while True:
        completable = [
            r
            for r in queues
            if (ps := frontier(r)) is not None
            and all(half_matches(ps, h) for h in ps.halves)
        ]
        if not completable:
            break
        for r in completable:
            ptr[r] += 1

    out: list[Violation] = []
    stuck = [r for r in queues if ptr[r] < len(queues[r])]
    # a watchdog-wrapped rendezvous cannot deadlock *forever*: the runtime
    # converts the block into a typed FT_STEP_TIMEOUT — the deadlock is
    # still a schedule bug (the step never completes), but the failure mode
    # is a diagnostic, not a hang; say so in the report
    bound = (
        " (bounded at runtime: the watchdog converts this into "
        "FT_STEP_TIMEOUT — still a schedule bug)"
        if prog.watchdogged
        else " (UNBOUNDED: no watchdog — this hangs forever)"
    )
    for r in sorted(stuck):
        ps = frontier(r)
        blocked = [h for h in ps.halves if not half_matches(ps, h)]
        h = blocked[0] if blocked else ps.halves[0]
        src, dst = (r, h.peer) if h.kind == SEND else (h.peer, r)
        out.append(
            Violation(
                "schedule",
                "deadlock",
                f"{prog.kind} chunk{ps.chunk}/{ps.phase}",
                f"rank {r} blocks on {h.kind} {src}->{dst} "
                f"(cycle among {len(stuck)} stuck ranks: {sorted(stuck)})"
                + bound,
                stage=ps.stage,
                src=src,
                dst=dst,
                block=h.blocks[0] if h.blocks else None,
            )
        )
    return out


def _check_watchdog(prog: Program) -> list[Violation]:
    """Every executed schedule must keep its watchdog wrapper: without a
    recv/step deadline a blocking rendezvous whose peer died or stalled
    hangs forever instead of surfacing ``FT_STEP_TIMEOUT``."""
    if prog.watchdogged:
        return []
    return [
        Violation(
            "schedule",
            "unbounded-wait",
            prog.kind,
            "program lost its watchdog wrapper (watchdogged=False): a "
            "blocking rendezvous with no recv deadline can hang forever on "
            "a dead or stalled peer instead of raising FT_STEP_TIMEOUT — "
            "every executed schedule must run deadline-wrapped",
        )
    ]


def _check_conservation(prog: Program) -> list[Violation]:
    """Replay ownership per chunk from the program's own halves."""
    out: list[Violation] = []
    n = prog.num_nodes
    if prog.kind == "ring":
        return _check_ring_conservation(prog)
    # ranks that only fold through a buddy (lonely shapes, non-power-of-two
    # swing extras) own no blocks: the replay runs over the scheduled ranks
    n = n - sum(
        1
        for r, q in prog.posts.items()
        if any(ps.phase == "fold" and ps.halves[0].kind == SEND for ps in q)
    )

    for c in range(prog.chunks):
        # ---- reduce-scatter: sends partition owned; recvs define new owned
        owned = {r: set(range(n)) for r in range(n)}
        by_rs: dict[tuple[int, int], list[tuple[Half, PostSet]]] = {}
        by_ag: dict[tuple[int, int], list[tuple[Half, PostSet]]] = {}
        for ps in prog.postsets():
            if ps.chunk != c or ps.rank >= n:
                continue
            for h in ps.halves:
                if ps.phase == "rs":
                    by_rs.setdefault((ps.rank, ps.stage), []).append((h, ps))
                elif ps.phase == "ag":
                    by_ag.setdefault((ps.rank, ps.stage), []).append((h, ps))
        n_stages = prog.num_stages
        where = f"{prog.kind} chunk{c}/rs"
        for i in range(n_stages):
            for r in range(n):
                sent: dict[int, int] = {}
                kept: set[int] = set()
                for h, ps in by_rs.get((r, i), []):
                    if h.kind == SEND:
                        for b in h.blocks:
                            if b in sent:
                                out.append(
                                    Violation(
                                        "schedule",
                                        "double-count",
                                        where,
                                        f"rank {r} sends block {b} to both "
                                        f"{sent[b]} and {h.peer}: reduced twice",
                                        stage=i, src=r, dst=h.peer, block=b,
                                    )
                                )
                            sent[b] = h.peer
                    else:
                        kept |= set(h.blocks)
                # a rank also keeps its own residue chain without sending it
                # to itself (self-ops are skipped); its kept set IS the recv
                # halves' union — sends must cover owned minus kept exactly
                missing = owned[r] - set(sent) - kept
                extra = set(sent) - owned[r]
                for b in sorted(missing):
                    out.append(
                        Violation(
                            "schedule",
                            "dropped-block",
                            where,
                            f"rank {r} owns block {b} but neither sends nor "
                            f"keeps it at stage {i}: its contribution is lost",
                            stage=i, src=r, dst=None, block=b,
                        )
                    )
                for b in sorted(extra):
                    out.append(
                        Violation(
                            "schedule",
                            "double-count",
                            where,
                            f"rank {r} sends block {b} it does not own at "
                            f"stage {i} (already contributed upstream)",
                            stage=i, src=r, dst=sent[b], block=b,
                        )
                    )
                if not kept <= owned[r]:
                    bad = min(kept - owned[r])
                    out.append(
                        Violation(
                            "schedule",
                            "double-count",
                            where,
                            f"rank {r} stage {i} receives partials for block "
                            f"{bad} it no longer owns",
                            stage=i, src=None, dst=r, block=bad,
                        )
                    )
                owned[r] = kept
        seen: set[int] = set()
        for r in range(n):
            dup = seen & owned[r]
            if dup:
                out.append(
                    Violation(
                        "schedule",
                        "double-count",
                        f"{prog.kind} chunk{c}",
                        f"final scatter ownership overlaps on block "
                        f"{min(dup)} (rank {r})",
                        stage=n_stages - 1, src=None, dst=r, block=min(dup),
                    )
                )
            seen |= owned[r]
        for b in sorted(set(range(n)) - seen):
            out.append(
                Violation(
                    "schedule",
                    "dropped-block",
                    f"{prog.kind} chunk{c}",
                    f"no rank owns block {b} after reduce-scatter: it was "
                    f"never fully reduced",
                    stage=n_stages - 1, src=None, dst=None, block=b,
                )
            )

        # ---- allgather closure: replay forwarding in issue order
        holdings = {r: set(owned[r]) for r in range(n)}
        for i in reversed(range(n_stages)):
            new_holdings = {r: set(h) for r, h in holdings.items()}
            for r in range(n):
                for h, ps in by_ag.get((r, i), []):
                    if h.kind != RECV:
                        continue
                    inbound = set(h.blocks)
                    if not inbound <= holdings.get(h.peer, set()):
                        bad = min(inbound - holdings.get(h.peer, set()))
                        out.append(
                            Violation(
                                "schedule",
                                "dropped-block",
                                f"{prog.kind} chunk{c}/ag",
                                f"rank {h.peer} forwards block {bad} it does "
                                f"not hold at stage {i}",
                                stage=i, src=h.peer, dst=r, block=bad,
                            )
                        )
                    new_holdings[r] |= inbound
            holdings = new_holdings
        for r in range(n):
            gaps = set(range(n)) - holdings[r]
            if gaps:
                out.append(
                    Violation(
                        "schedule",
                        "dropped-block",
                        f"{prog.kind} chunk{c}/ag",
                        f"allgather closure fails: rank {r} ends without "
                        f"blocks {sorted(gaps)}",
                        stage=0, src=None, dst=r, block=min(gaps),
                    )
                )
    return out


def _check_ring_conservation(prog: Program) -> list[Violation]:
    out: list[Violation] = []
    n = prog.num_nodes
    for r in range(n):
        steps = [ps for ps in prog.posts.get(r, [])]
        reduce_steps = [ps for ps in steps if ps.phase == "rs"]
        gather_steps = [ps for ps in steps if ps.phase == "ag"]
        folded = {r}
        for ps in reduce_steps:
            for h in ps.halves:
                if h.kind == RECV:
                    folded.update(h.blocks)
        missing = set(range(n)) - folded
        for b in sorted(missing):
            out.append(
                Violation(
                    "schedule",
                    "dropped-block",
                    "ring/rs",
                    f"rank {r} never folds a partial for block {b} in the "
                    f"reduce phase",
                    stage=len(reduce_steps), src=None, dst=r, block=b,
                )
            )
        have = {(r + 1) % n}
        for ps in gather_steps:
            for h in ps.halves:
                if h.kind == RECV:
                    have.update(h.blocks)
        for b in sorted(set(range(n)) - have):
            out.append(
                Violation(
                    "schedule",
                    "dropped-block",
                    "ring/ag",
                    f"rank {r} ends the allgather without block {b}",
                    stage=len(gather_steps), src=None, dst=r, block=b,
                )
            )
    return out


def _check_chunk_spans(prog: Program) -> list[Violation]:
    """Chunk buffer spans must be pairwise disjoint and tile the head."""
    out: list[Violation] = []
    spans = sorted(
        range(len(prog.chunk_spans)), key=lambda i: prog.chunk_spans[i][0]
    )
    covered = 0
    for idx in spans:
        off, size = prog.chunk_spans[idx]
        if off < covered:
            out.append(
                Violation(
                    "schedule",
                    "chunk-overlap",
                    f"{prog.kind} chunk{idx}",
                    f"chunk {idx} buffer [{off}, {off + size}) overlaps the "
                    f"previous chunk's span ending at {covered}: interleaved "
                    f"phases would alias",
                    stage=None, src=None, dst=None, block=idx,
                )
            )
        elif off > covered:
            out.append(
                Violation(
                    "schedule",
                    "chunk-overlap",
                    f"{prog.kind} chunk{idx}",
                    f"gap [{covered}, {off}) before chunk {idx}'s buffer: "
                    f"those elements belong to no chunk and are never "
                    f"reduced",
                    stage=None, src=None, dst=None, block=idx,
                )
            )
        covered = max(covered, off + size)
    if prog.chunk_spans and covered != prog.head_elems:
        out.append(
            Violation(
                "schedule",
                "chunk-overlap",
                f"{prog.kind}",
                f"chunk spans cover [0, {covered}) but the divisible head is "
                f"{prog.head_elems} elements",
                stage=None, src=None, dst=None, block=None,
            )
        )
    return out


def check_program(prog: Program) -> list[Violation]:
    """All program-level checks; order: watchdog contract, symmetry,
    deadlock, conservation, buffer spans (cheapest-to-localize first)."""
    out = _check_watchdog(prog)
    out += _check_symmetry(prog)
    out += _check_deadlock(prog)
    out += _check_conservation(prog)
    out += _check_chunk_spans(prog)
    return out


def _row_selected(name: str, programs) -> bool:
    """``programs``: optional substring filters (the CLI's ``--programs``)
    — ``None``/empty selects everything."""
    return not programs or any(p in name for p in programs)


# ------------------------------------------------------------ IR families


def default_ir_matrix(max_n: int = 16) -> list[tuple]:
    """(spec, num_nodes, count) rows for the IR-only families: Swing at
    power-of-two AND non-power-of-two N (the latter runs the buddy-folded
    core), and the generalized construction at its corners (flat-tree
    message pattern, recursive halving-doubling) plus interior ports."""
    rows = [
        ("swing", 4, 32),
        ("swing", 6, 48),       # non-power-of-two: 4-core + 2 folded extras
        ("swing", 8, 64),
        ("swing", 12, 96),
        ("swing", 16, 256),
        ("gen:8@7", 8, 64),     # flat-tree corner, one round
        ("gen:2,2,2@1", 8, 64),  # recursive halving-doubling corner
        ("gen:4,2@2", 8, 96),
        ("gen:4,2@1", 8, 64),
        ("gen:3,2@1", 6, 36),
        ("gen:4,4@3", 16, 256),
    ]
    return [r for r in rows if r[1] <= max_n]


def check_ir_families(
    max_n: int = 16, programs=None, times: dict | None = None
) -> tuple[list[Violation], int]:
    """Emit and model-check every IR-family row; returns (violations,
    programs_checked).  An emitter that raises is reported as an
    ``invalid-topology`` violation, never an analyzer crash.
    ``programs`` filters rows by name substring; ``times`` (when given)
    collects per-program wall-ms."""
    violations: list[Violation] = []
    checked = 0
    for spec, n, count in default_ir_matrix(max_n):
        name = f"{spec}@{n}"
        if not _row_selected(name, programs):
            continue
        t0 = time.perf_counter()
        try:
            prog = sir.emit_ir(spec, num_nodes=n, count=count)
        except (TopologyError, ScheduleError, ValueError, TypeError) as e:
            violations.append(
                Violation(
                    "schedule", "invalid-topology", name,
                    f"{type(e).__name__}: {e}",
                )
            )
            continue
        violations += check_ir(prog)
        if times is not None:
            times[name] = round((time.perf_counter() - t0) * 1e3, 2)
        checked += 1
    return violations, checked
