"""Declarative schedule IR: one program representation for every collective.

A copy of ``flextree_tpu/schedule/ir.py`` (the port imports nothing of
the JAX package); only :func:`compile_ir`'s lowering differs, and it lives
in ``parallel/ir_lower.py``.

An allreduce is a *program* — a sequence of :class:`IRStage` rows, each a
declarative (peer-group, block-map, combine-op) record — and everything
downstream derives from that one object:

- the **model checker** (``analysis.schedule_check.program_from_ir``)
  expands the IR into the per-rank message program it proves deadlock-free
  and conservation-correct;
- the **compiler** (:func:`compile_ir`, lowering in
  ``parallel/ir_lower.py``) turns the IR into the collective: tree, ring
  and lonely programs run the walker of ``parallel/allreduce.py``
  unchanged, swing and generalized programs the pair-stage executor, each
  of its fold stages one call of the fold kernel.

``compile_ir`` REFUSES a program that fails the model checks — "verified
before compiled" is the module invariant, not a convention.

Two topology families beyond the reference's, as pure emitters (a new
topology = a new emitter; the proofs are free):

- :func:`swing_ir` — Swing short-cut rings (arXiv:2401.09356): pairwise
  distance-swinging exchanges ``peer(r, s) = r ± rho_s`` with
  ``rho_s = (1 - (-2)^(s+1)) / 3`` (1, 1, 3, 5, 11, ...), halving the
  live block set each step.  Non-power-of-two N runs the largest
  power-of-two core plus lonely-style buddy fold/restore hops.
- :func:`generalized_ir` — the generalized allreduce construction
  (arXiv:2004.09362): mixed-radix stage widths × a per-round port count.
  ``widths=(N,), ports=N-1`` is the flat tree's message pattern;
  ``widths=(2,...,2), ports=1`` is recursive halving-doubling;
  ``ports`` between the corners trades rounds against in-flight messages.

Like the rest of ``schedule`` this module is pure Python — no torch at
import time (``compile_ir`` imports the lowering lazily), so the verifier
runs on a host without devices.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

from .stages import FT_TOPO_ENV, LonelyTopology, Topology, TopologyError

__all__ = [
    "IRXfer",
    "IRStage",
    "IRProgram",
    "IRFamilySpec",
    "IRViolationError",
    "stage_send_blocks",
    "stage_keep_blocks",
    "tree_ir",
    "tree_phase_stages",
    "ring_ir",
    "lonely_ir",
    "swing_ir",
    "swing_rho",
    "swing_peer",
    "generalized_ir",
    "emit_ir",
    "parse_ir_family_spec",
    "is_ir_family_spec",
    "resolve_collective",
    "compile_ir",
    "verify_ir",
    "IR_FAMILIES",
]

#: every family an IR program can declare; tree/ring/lonely lower through
#: the proven grouped-collective programs of ``parallel/allreduce.py``,
#: swing/generalized through the generic pair-exchange executor
IR_FAMILIES = ("tree", "ring", "lonely", "swing", "generalized")

SUM, COPY = "sum", "copy"


class IRViolationError(ValueError):
    """``compile_ir`` refused a program: model checks failed or the stage
    list diverged from the family's canonical emission.  ``violations``
    carries the checker's findings (empty for structural divergence)."""

    def __init__(self, msg: str, violations=()):
        super().__init__(msg)
        self.violations = tuple(violations)


# ------------------------------------------------------------ block math
#
# The one residue-chain definition every consumer shares.  ``plan.py``'s
# ``send_plan``/``recv_plan`` are thin views over these two functions, the
# tree emitter builds its block-maps from them, and the verifier expands
# whatever the emitter produced — one source of truth.


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


# ------------------------------------------------------------- data model


@dataclass(frozen=True)
class IRXfer:
    """One cross-rank transfer inside a stage: ``src`` sends the listed
    block indices to ``dst``.  ``blocks=()`` marks a whole-buffer hop
    (fold / restore), whose payload is the full current slice."""

    src: int
    dst: int
    blocks: tuple[int, ...]


@dataclass(frozen=True)
class IRStage:
    """One declarative stage: a peer-group partition, the block-map (every
    cross-rank transfer with its block set), and the combine op.

    ``index`` is the LOGICAL stage id — multiple IRStage rows may share it
    (a generalized stage's rounds; the checker aggregates conservation per
    logical stage while the deadlock machine sees each row as its own
    rendezvous).  ``lowering`` is the compile strategy:

    - ``"grouped"``: one tree stage of the walker (a fold stage for a
      reduce-scatter, the group's copies for the gather);
    - ``"pair"``: an exchange of per-rank block sets (swing steps,
      generalized rounds, fold/restore hops), one fold-kernel call for a
      ``sum`` row and one copy a block for a ``copy`` row;
    - ``"ring-step"``: one step of the walker's ring.
    """

    index: int
    phase: str  # "rs" | "ag" | "fold" | "restore"
    combine: str  # "sum" | "copy"
    lowering: str  # "grouped" | "pair" | "ring-step"
    groups: tuple[tuple[int, ...], ...]
    xfers: tuple[IRXfer, ...]
    chunk: int = 0


@dataclass(frozen=True)
class IRProgram:
    """A full collective as data.  ``scheduled`` is the number of ranks
    that own blocks (< ``num_nodes`` for lonely shapes and non-power-of-
    two swing, whose extras fold through buddies); ``num_blocks ==
    scheduled``.  ``topo`` carries the resolved legacy topology for
    tree/ring/lonely lowering; swing/generalized set it ``None``."""

    family: str
    num_nodes: int
    scheduled: int
    num_stages: int
    stages: tuple[IRStage, ...]
    count: int
    head_elems: int
    chunk_spans: tuple[tuple[int, int], ...]
    chunks: int = 1
    widths: tuple[int, ...] = ()
    ports: int = 0
    topo: object = None

    @property
    def num_blocks(self) -> int:
        return self.scheduled

    def spec(self) -> str:
        """The ``FT_TOPO``-style spec string selecting this family."""
        if self.family == "swing":
            return "swing"
        if self.family == "generalized":
            return f"gen:{','.join(map(str, self.widths))}@{self.ports}"
        if self.family == "ring":
            return "1"
        spec = ",".join(map(str, self.widths))
        if self.family == "lonely":
            spec += f"+{self.num_nodes - self.scheduled}"
        return spec

    def __str__(self) -> str:
        return f"{self.family}[{self.spec()}]@{self.num_nodes}"


@dataclass(frozen=True)
class IRFamilySpec:
    """A planner-facing handle for an IR family shape (the analog of
    ``Topology`` for swing/generalized candidates): enough to name, cost
    and cache a plan without emitting the full program.  ``allreduce``
    resolves it (or its ``spec`` string) through :func:`emit_ir`."""

    family: str  # "swing" | "generalized"
    num_nodes: int
    widths: tuple[int, ...] = ()
    ports: int = 0

    def __post_init__(self):
        if self.family not in ("swing", "generalized"):
            raise TopologyError(
                f"IRFamilySpec is for swing/generalized, got {self.family!r}"
            )
        if self.family == "generalized":
            if math.prod(self.widths) != self.num_nodes:
                raise TopologyError(
                    f"generalized widths {self.widths} do not multiply to "
                    f"{self.num_nodes}"
                )
            if not 1 <= self.ports <= max(w - 1 for w in self.widths):
                raise TopologyError(
                    f"ports must be in [1, max_width-1], got {self.ports}"
                )

    @property
    def is_ring(self) -> bool:
        return False

    @property
    def num_stages(self) -> int:
        if self.family == "swing":
            core = 1 << (self.num_nodes.bit_length() - 1)
            return core.bit_length() - 1
        return len(self.widths)

    @property
    def spec(self) -> str:
        if self.family == "swing":
            return "swing"
        return f"gen:{','.join(map(str, self.widths))}@{self.ports}"

    def __str__(self) -> str:
        return self.spec


# ------------------------------------------------------------- emitters


def _head(count: int, owners: int) -> int:
    return (count // owners) * owners


def _pair_groups(pairs) -> tuple[tuple[int, ...], ...]:
    return tuple(tuple(sorted(p)) for p in pairs)


def tree_phase_stages(
    topo: Topology, phase: str, chunk: int = 0
) -> list[IRStage]:
    """The grouped stages of ONE tree phase, in trace order (``rs``
    ascending, ``ag`` descending) — the single expansion the full-program
    emitter, the phase-program builder and the plan views all share."""
    n = topo.num_nodes
    order = (
        range(topo.num_stages) if phase == "rs" else reversed(range(topo.num_stages))
    )
    out = []
    for i in order:
        g, w = topo.gaps[i], topo.widths[i]
        xfers = []
        for r in range(n):
            for peer in topo.group_members(i, r):
                if peer == r:
                    continue
                if phase == "rs":
                    blocks = stage_send_blocks(n, g, w, peer)
                else:  # roles swap: r returns the chain it collected
                    blocks = stage_keep_blocks(n, g, w, r)
                xfers.append(IRXfer(r, peer, blocks))
        out.append(
            IRStage(
                index=i,
                phase=phase,
                combine=SUM if phase == "rs" else COPY,
                lowering="grouped",
                groups=tuple(tuple(grp) for grp in topo.groups(i)),
                xfers=tuple(xfers),
                chunk=chunk,
            )
        )
    return out


def _chunk_sizes(total: int, n: int, chunks: int) -> list[int]:
    """Mirror of ``parallel.allreduce._chunk_sizes`` (balanced contiguous
    pieces, each a multiple of ``n``)."""
    blocks = total // n
    c = max(1, min(chunks, blocks))
    base, rem = divmod(blocks, c)
    return [(base + (1 if i < rem else 0)) * n for i in range(c)]


def tree_ir(topo: Topology, count: int | None = None, chunks: int = 1) -> IRProgram:
    """The k-ary tree program: per-stage grouped reduce-scatter down,
    grouped all-gather back up; ``chunks > 1`` interleaves chunk ``c``'s
    allgather between chunk ``c+1``'s reduce-scatter and its own — the
    exact trace order of ``parallel.allreduce.tree_allreduce``."""
    if isinstance(topo, LonelyTopology):
        return lonely_ir(topo, count=count)
    if topo.is_ring:
        return ring_ir(topo.num_nodes, count=count)
    n = topo.num_nodes
    count = n * n if count is None else count
    head = _head(count, n)
    sizes = _chunk_sizes(head, n, chunks) if head else []
    n_chunks = max(1, len(sizes))
    spans, off = [], 0
    for s in sizes:
        spans.append((off, s))
        off += s
    stages: list[IRStage] = []
    stages += tree_phase_stages(topo, "rs", chunk=0)
    for c in range(1, n_chunks):
        stages += tree_phase_stages(topo, "rs", chunk=c)
        stages += tree_phase_stages(topo, "ag", chunk=c - 1)
    stages += tree_phase_stages(topo, "ag", chunk=n_chunks - 1)
    return IRProgram(
        family="tree",
        num_nodes=n,
        scheduled=n,
        num_stages=topo.num_stages,
        stages=tuple(stages),
        count=count,
        head_elems=head,
        chunk_spans=tuple(spans),
        chunks=n_chunks,
        widths=topo.widths,
        topo=topo,
    )


def ring_ir(n: int, count: int | None = None) -> IRProgram:
    """The 2(N-1)-step ring walk as 2(N-1) pair stages (send right, recv
    left, decrementing block indices) — lowered to the walker's ring."""
    count = n * n if count is None else count
    head = _head(count, n)
    stages: list[IRStage] = []
    groups = _pair_groups([(r, (r + 1) % n) for r in range(n)])
    for step in range(2 * (n - 1)):
        phase = "rs" if step < n - 1 else "ag"
        xfers = []
        for r in range(n):
            if phase == "rs":
                blk = (r - step) % n
            else:
                blk = (r + 1 - (step - (n - 1))) % n
            xfers.append(IRXfer(r, (r + 1) % n, (blk,)))
        stages.append(
            IRStage(
                index=step,
                phase=phase,
                combine=SUM if phase == "rs" else COPY,
                lowering="ring-step",
                groups=groups,
                xfers=tuple(xfers),
            )
        )
    return IRProgram(
        family="ring",
        num_nodes=n,
        scheduled=n,
        num_stages=1,
        stages=tuple(stages),
        count=count,
        head_elems=head,
        chunk_spans=((0, head),),
        widths=(1,),
        topo=Topology.ring(n),
    )


def lonely_ir(topo: LonelyTopology, count: int | None = None) -> IRProgram:
    """Tree over the first ``m`` ranks, ``l`` lonely ranks folded through
    buddies: fold hop, prefix-tree stages, restore hop — the program of
    ``parallel.allreduce.lonely_allreduce``."""
    tree, m, l = topo.tree, topo.tree.num_nodes, topo.lonely
    count = m * m if count is None else count
    head = _head(count, m)
    stages: list[IRStage] = [
        IRStage(
            index=0,
            phase="fold",
            combine=SUM,
            lowering="pair",
            groups=_pair_groups([(m + i, i) for i in range(l)]),
            xfers=tuple(IRXfer(m + i, i, ()) for i in range(l)),
        )
    ]
    stages += tree_phase_stages(tree, "rs")
    stages += tree_phase_stages(tree, "ag")
    stages.append(
        IRStage(
            index=0,
            phase="restore",
            combine=COPY,
            lowering="pair",
            groups=_pair_groups([(i, m + i) for i in range(l)]),
            xfers=tuple(IRXfer(i, m + i, ()) for i in range(l)),
        )
    )
    return IRProgram(
        family="lonely",
        num_nodes=topo.num_nodes,
        scheduled=m,
        num_stages=tree.num_stages,
        stages=tuple(stages),
        count=count,
        head_elems=head,
        chunk_spans=((0, head),),
        widths=tree.widths,
        topo=topo,
    )


# ------------------------------------------------------------------ swing


def swing_rho(s: int) -> int:
    """Swing's step-``s`` displacement ``(1 - (-2)^(s+1)) / 3`` —
    1, -1, 3, -5, 11, ... (arXiv:2401.09356 eq. 1); the sign alternation
    is what keeps cumulative distances short ("swinging")."""
    return (1 - (-2) ** (s + 1)) // 3


def swing_peer(r: int, s: int, n: int) -> int:
    """Swing peer of rank ``r`` at step ``s`` on an ``n``-ring: even ranks
    move ``+rho_s``, odd ranks ``-rho_s`` — an involution (rho is always
    odd, so the peer has opposite parity and maps straight back)."""
    rho = swing_rho(s)
    return (r + rho) % n if r % 2 == 0 else (r - rho) % n


def _swing_reach(n: int) -> list[list[set[int]]]:
    """``reach[s][r]``: final block owners reachable from ``r`` via steps
    ``s..k-1`` — ``reach[k][r] = {r}``; ``reach[s][r] = reach[s+1][r] |
    reach[s+1][peer(r, s)]``.  The emitter asserts the partition property
    (each step's keep/send sets disjoint, step 0 spanning [0, n)) so a
    broken peer function can never emit a silently-wrong program."""
    k = n.bit_length() - 1
    reach = [[set() for _ in range(n)] for _ in range(k + 1)]
    for r in range(n):
        reach[k][r] = {r}
    for s in reversed(range(k)):
        for r in range(n):
            p = swing_peer(r, s, n)
            joint = reach[s + 1][r] | reach[s + 1][p]
            if reach[s + 1][r] & reach[s + 1][p]:
                raise TopologyError(
                    f"swing reach sets collide at step {s}, rank {r}"
                )
            reach[s][r] = joint
    for r in range(n):
        if reach[0][r] != set(range(n)):
            raise TopologyError(
                f"swing steps do not span the ring from rank {r}"
            )
    return reach


def swing_ir(n: int, count: int | None = None) -> IRProgram:
    """Swing short-cut ring (arXiv:2401.09356): ``log2(P)`` pairwise
    exchange steps over the largest power-of-two core ``P <= n``, halving
    the live block set each step; the peer distance swings (1, 1, 3, 5,
    11, ...) so consecutive steps stay near on a physical ring.  Non-
    power-of-two ``n`` folds the ``n - P`` extra ranks into buddies first
    and restores them after (the lonely protocol, reused)."""
    if n < 2:
        raise TopologyError(f"swing needs n >= 2, got {n}")
    core = 1 << (n.bit_length() - 1)
    extras = n - core
    count = core * core if count is None else count
    head = _head(count, core)
    k = core.bit_length() - 1
    reach = _swing_reach(core)

    stages: list[IRStage] = []
    if extras:
        stages.append(
            IRStage(
                index=0,
                phase="fold",
                combine=SUM,
                lowering="pair",
                groups=_pair_groups([(core + i, i) for i in range(extras)]),
                xfers=tuple(IRXfer(core + i, i, ()) for i in range(extras)),
            )
        )
    for s in range(k):
        pairs = set()
        xfers = []
        for r in range(core):
            p = swing_peer(r, s, core)
            pairs.add(tuple(sorted((r, p))))
            xfers.append(IRXfer(r, p, tuple(sorted(reach[s + 1][p]))))
        stages.append(
            IRStage(
                index=s,
                phase="rs",
                combine=SUM,
                lowering="pair",
                groups=_pair_groups(sorted(pairs)),
                xfers=tuple(xfers),
            )
        )
    for s in reversed(range(k)):
        pairs = set()
        xfers = []
        for r in range(core):
            p = swing_peer(r, s, core)
            pairs.add(tuple(sorted((r, p))))
            xfers.append(IRXfer(r, p, tuple(sorted(reach[s + 1][r]))))
        stages.append(
            IRStage(
                index=s,
                phase="ag",
                combine=COPY,
                lowering="pair",
                groups=_pair_groups(sorted(pairs)),
                xfers=tuple(xfers),
            )
        )
    if extras:
        stages.append(
            IRStage(
                index=0,
                phase="restore",
                combine=COPY,
                lowering="pair",
                groups=_pair_groups([(i, core + i) for i in range(extras)]),
                xfers=tuple(IRXfer(i, core + i, ()) for i in range(extras)),
            )
        )
    return IRProgram(
        family="swing",
        num_nodes=n,
        scheduled=core,
        num_stages=k,
        stages=tuple(stages),
        count=count,
        head_elems=head,
        chunk_spans=((0, head),),
        widths=(2,) * k,
    )


# ------------------------------------------------------------ generalized


def generalized_ir(
    widths: tuple[int, ...], ports: int = 1, count: int | None = None
) -> IRProgram:
    """The generalized allreduce construction (arXiv:2004.09362): mixed-
    radix stages like the tree, but each width-``w`` stage executes as
    ``ceil((w-1)/ports)`` ROUNDS of circulant pairwise exchanges — at
    round ``t``, offset ``o``, the member at group position ``pi`` sends
    position ``(pi+o) % w`` the destination's residue chain.  Corners:
    ``widths=(N,), ports=N-1`` reproduces the flat tree's message pattern
    in one round; ``widths=(2,..,2), ports=1`` is recursive halving-
    doubling; intermediate points trade rounds (latency) against
    messages in flight per round."""
    widths = tuple(int(w) for w in widths)
    n = math.prod(widths)
    if any(w < 2 for w in widths):
        raise TopologyError(f"generalized widths must be >= 2, got {widths}")
    max_ports = max(w - 1 for w in widths)
    if not 1 <= ports <= max_ports:
        raise TopologyError(
            f"ports must be in [1, {max_ports}] for widths {widths}, got {ports}"
        )
    topo = Topology(n, widths)
    count = n * n if count is None else count
    head = _head(count, n)

    def rounds(w: int):
        """Offsets grouped into rounds of at most ``ports``."""
        offs = list(range(1, w))
        return [offs[t : t + ports] for t in range(0, len(offs), ports)]

    def stage_rows(i: int, phase: str) -> list[IRStage]:
        g, w = topo.gaps[i], topo.widths[i]
        groups = tuple(tuple(grp) for grp in topo.groups(i))
        rows = []
        for offsets in rounds(w):
            xfers = []
            for grp in groups:
                for pi, r in enumerate(grp):
                    for o in offsets:
                        dst = grp[(pi + o) % w]
                        if phase == "rs":
                            blocks = stage_send_blocks(n, g, w, dst)
                        else:
                            blocks = stage_keep_blocks(n, g, w, r)
                        xfers.append(IRXfer(r, dst, blocks))
            rows.append(
                IRStage(
                    index=i,
                    phase=phase,
                    combine=SUM if phase == "rs" else COPY,
                    lowering="pair",
                    groups=groups,
                    xfers=tuple(xfers),
                )
            )
        return rows

    stages: list[IRStage] = []
    for i in range(topo.num_stages):
        stages += stage_rows(i, "rs")
    for i in reversed(range(topo.num_stages)):
        stages += stage_rows(i, "ag")
    return IRProgram(
        family="generalized",
        num_nodes=n,
        scheduled=n,
        num_stages=topo.num_stages,
        stages=tuple(stages),
        count=count,
        head_elems=head,
        chunk_spans=((0, head),),
        widths=widths,
        ports=ports,
    )


# ----------------------------------------------------------- spec parsing


def parse_ir_family_spec(spec: str) -> IRFamilySpec | None:
    """Parse an IR-family spec string (``"swing"`` or ``"gen:4,2@2"``)
    WITHOUT a device count (the count binds at resolve time); returns
    ``None`` for legacy specs.  ``num_nodes=0`` marks the unbound form."""
    s = spec.strip().lower()
    if s == "swing":
        return IRFamilySpec("swing", 0)
    if s.startswith("gen:"):
        body = s[len("gen:"):]
        ports = 1
        if "@" in body:
            body, _, p = body.rpartition("@")
            try:
                ports = int(p)
            except ValueError as e:
                raise TopologyError(f"bad ports in spec {spec!r}") from e
        try:
            widths = tuple(int(t) for t in body.split(",") if t.strip())
        except ValueError as e:
            raise TopologyError(f"bad widths in spec {spec!r}") from e
        # num_nodes bound later; bypass the product check with a direct build
        fam = object.__new__(IRFamilySpec)
        object.__setattr__(fam, "family", "generalized")
        object.__setattr__(fam, "num_nodes", 0)
        object.__setattr__(fam, "widths", widths)
        object.__setattr__(fam, "ports", ports)
        return fam
    return None


def is_ir_family_spec(topo) -> bool:
    """True when ``topo`` names an IR-only family (swing/generalized)."""
    if isinstance(topo, (IRFamilySpec, IRProgram)):
        return True
    if isinstance(topo, str):
        s = topo.strip().lower()
        return s == "swing" or s.startswith("gen:")
    return False


def resolve_collective(num_nodes: int, topo=None):
    """Resolve ``topo`` to either a legacy ``Topology``/``LonelyTopology``
    or an :class:`IRFamilySpec` — the widened front door ``allreduce``
    uses (legacy specs keep their exact ``Topology.resolve`` semantics)."""
    if topo is None:
        topo = os.environ.get(FT_TOPO_ENV, "")
    if isinstance(topo, IRProgram):
        if topo.num_nodes != num_nodes:
            raise TopologyError(
                f"IR program is for {topo.num_nodes} nodes, mesh has {num_nodes}"
            )
        return topo
    if isinstance(topo, IRFamilySpec):
        if topo.num_nodes == 0:
            return _bind_family(topo, num_nodes)
        if topo.num_nodes != num_nodes:
            raise TopologyError(
                f"family spec is for {topo.num_nodes} nodes, mesh has {num_nodes}"
            )
        return topo
    if isinstance(topo, str):
        fam = parse_ir_family_spec(topo)
        if fam is not None:
            return _bind_family(fam, num_nodes)
    return Topology.resolve(num_nodes, topo)


def _bind_family(fam: IRFamilySpec, num_nodes: int) -> IRFamilySpec:
    if fam.family == "swing":
        if num_nodes < 2:
            raise TopologyError(f"swing needs n >= 2, got {num_nodes}")
        return IRFamilySpec("swing", num_nodes)
    return IRFamilySpec("generalized", num_nodes, fam.widths, fam.ports)


def emit_ir(topo_like, num_nodes: int | None = None, count: int | None = None,
            chunks: int = 1) -> IRProgram:
    """Emit the IR program for any topology handle: resolved legacy
    topologies, :class:`IRFamilySpec`, or spec strings (``"4,2"``,
    ``"1"``, ``"3,2+1"``, ``"swing"``, ``"gen:4,2@2"``)."""
    if isinstance(topo_like, IRProgram):
        return topo_like
    if not isinstance(topo_like, (Topology, LonelyTopology, IRFamilySpec)):
        if num_nodes is None:
            raise ValueError("num_nodes required for unresolved specs")
        topo_like = resolve_collective(num_nodes, topo_like)
    if isinstance(topo_like, IRFamilySpec):
        if topo_like.family == "swing":
            return swing_ir(topo_like.num_nodes, count=count)
        return generalized_ir(topo_like.widths, topo_like.ports, count=count)
    if isinstance(topo_like, LonelyTopology):
        return lonely_ir(topo_like, count=count)
    if topo_like.is_ring:
        return ring_ir(topo_like.num_nodes, count=count)
    return tree_ir(topo_like, count=count, chunks=chunks)


# ------------------------------------------------------ verify + compile


def verify_ir(prog: IRProgram):
    """Model-check an IR program (expand to the per-rank message program,
    run every schedule check) — returns the violation list.  Imported
    lazily so this module stays importable without the analysis package
    being loaded first (no import cycle)."""
    from ..analysis.schedule_check import check_ir

    return check_ir(prog)


def compile_ir(prog: IRProgram, op: str = "sum"):
    """Verify, then lower: returns ``f(x, comm=None, *, out=None)``
    computing the program's allreduce over ``comm`` as
    ``parallel.allreduce.allreduce`` takes it (a ``Mesh`` and its ranks'
    tensors, or a process group and this rank's tensor).

    The "verified-before-compiled" invariant: the program is model-checked
    (peer symmetry, deadlock-freedom, per-block conservation, chunk-span
    disjointness) and REFUSED with :class:`IRViolationError` on any
    violation — a corrupted program cannot reach a mesh.  The lowering
    additionally refuses a program whose stage list diverges from its
    family's canonical emission (``parallel.ir_lower``), so the object the
    checker certified is the object that runs.
    """
    if not isinstance(prog, IRProgram):
        raise TypeError(f"compile_ir wants an IRProgram, got {type(prog)}")
    if prog.family not in IR_FAMILIES:
        raise IRViolationError(f"unknown IR family {prog.family!r}")
    violations = verify_ir(prog)
    if violations:
        raise IRViolationError(
            f"refusing to compile {prog}: {len(violations)} model-check "
            f"violation(s); first: {violations[0]}",
            violations,
        )
    from ..parallel.ir_lower import lower_ir

    return lower_ir(prog, op=op)
