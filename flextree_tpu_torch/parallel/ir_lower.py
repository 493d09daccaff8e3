"""IR lowering: turn a verified ``schedule.ir.IRProgram`` into the collective.

PyTorch counterpart of ``flextree_tpu/parallel/ir_lower.py``.
``schedule.ir.compile_ir`` is the front door — it model-checks the program
and only then calls :func:`lower_ir` here.  Lowering adds the second
refusal: the program's stage list must equal its family's CANONICAL
emission (``_canonical_twin``), so the object the checker certified is
provably the object that runs — an IR/executable divergence is a
refusal, not a silent re-derivation.

Lowering strategies, per family:

- **tree, ring, lonely** lower to the walker of ``parallel/allreduce.py``
  unchanged (``_allreduce``), as the JAX package lowers them to its
  legacy executors: the bits and the launches do not change;
- **pair-stage families** (swing, generalized) run the pair-stage
  executor :func:`_pair_allreduce` on the walker's transports.  Each
  stage's transfers ``IRXfer(src, dst, blocks)`` act on the ``(m, tile)``
  block view of the head (``m = prog.scheduled``):

  - a ``sum`` row is ONE fold stage (:func:`.allreduce._fold_stage`, one
    call of the fold kernel on a mesh): each receiving rank and block is
    a fold whose output is the receiver's block and whose sources are
    its own block and every sender's block, in slot order (the JAX
    executor folds slot by slot, ``ir_lower.py:108-133``, and the kernel
    folds its sources left to right, so the bits are the JAX ones).  The
    senders' blocks are read where they lie: within a row the blocks a
    rank sends and the blocks it receives are disjoint, so no fold reads
    what another writes;
  - a ``copy`` row is one message a block;
  - the fold hop is a whole-head two-source fold on each buddy, the
    restore hop a whole-head message to each extra rank.

  A block is read from the input until the program first writes it, then
  from the output (:func:`_pair_steps`), so no stage copies the input
  first.  The < m-element tail is the walker's dense fold.
"""

from __future__ import annotations

from functools import lru_cache

from ..ops.reduce import ReduceOp, get_op
from ..schedule import ir as sir
from ..schedule.ir import IRProgram, IRViolationError
from .allreduce import (
    Msg,
    _allreduce,
    _Call,
    _dense_tail,
    _fold_stage,
    _split,
)

__all__ = ["lower_ir", "LoweredIR"]


def _canonical_twin(prog: IRProgram) -> IRProgram:
    """Re-emit the program from its own family parameters."""
    if prog.family == "tree":
        return sir.tree_ir(prog.topo, count=prog.count, chunks=prog.chunks)
    if prog.family == "ring":
        return sir.ring_ir(prog.num_nodes, count=prog.count)
    if prog.family == "lonely":
        return sir.lonely_ir(prog.topo, count=prog.count)
    if prog.family == "swing":
        return sir.swing_ir(prog.num_nodes, count=prog.count)
    if prog.family == "generalized":
        return sir.generalized_ir(prog.widths, prog.ports, count=prog.count)
    raise IRViolationError(f"unknown IR family {prog.family!r}")


def _require_canonical(prog: IRProgram) -> None:
    """Refuse a program whose stages diverged from the canonical emission:
    the executors below realize exactly the canonical message pattern, so
    running a divergent (even if individually verified) stage list would
    silently execute something other than what was declared."""
    twin = _canonical_twin(prog)
    if prog.stages != twin.stages or prog.scheduled != twin.scheduled:
        raise IRViolationError(
            f"IR/executable divergence: {prog} does not match the canonical "
            f"{prog.family} emission — refusing to lower a stage list the "
            f"executor would not faithfully realize"
        )


# ----------------------------------------------------------- pair stages


def _pair_slots(st: "sir.IRStage"):
    """Split a pair stage's transfers into send-slots: slot ``j`` holds
    every rank's ``j``-th transfer (a generalized round with ``ports=p``
    has ``p`` slots; swing/fold/restore have one) — the order the JAX
    executor folds in."""
    per_src: dict[int, list] = {}
    for x in st.xfers:
        per_src.setdefault(x.src, []).append(x)
    n_slots = max(len(v) for v in per_src.values())
    return [
        [v[j] for v in per_src.values() if len(v) > j] for j in range(n_slots)
    ]


def _tags(pairs) -> list[int]:
    """Per message, its index among the stage's messages between the same
    two ranks: a message's tag on a process group."""
    seen: dict = {}
    tags = []
    for pair in pairs:
        seen[pair] = seen.get(pair, -1) + 1
        tags.append(seen[pair])
    return tags


@lru_cache(maxsize=256)
def _pair_steps(prog: IRProgram) -> tuple:
    """The program's stages as executor steps, with where each read lies.

    ``("hop", ((d, s), ...), fresh)``: rank ``d`` folds ``s``'s whole head
    into its own; ``("fold", ((d, b, srcs), ...), fresh)``: rank ``d``
    folds block ``b`` of each rank of ``srcs`` (itself first, then the
    senders in slot order) into its block ``b``; ``("copy", ((s, d, b,
    tag), ...), fresh)``: ``s`` sends block ``b`` into ``d``'s;
    ``("restore", ((s, d, None, tag), ...), fresh)``: ``s`` sends its whole
    head into ``d``'s.  ``fresh`` holds the ``(rank, block)`` reads (block
    ``None``: the whole head) of data the program has not written yet,
    which lie in the input; every other read lies in the output.  Raises
    :class:`IRViolationError` where a whole-head hop meets a half-written
    head or the program leaves a block of some rank unwritten."""
    m, n = prog.scheduled, prog.num_nodes
    every = frozenset(range(m))
    written = [set() for _ in range(n)]

    def whole(r):
        if written[r] and written[r] != every:
            raise IRViolationError(
                f"{prog}: a whole-head hop of rank {r} after only blocks "
                f"{sorted(written[r])} were written")
        return (r, None) if not written[r] else None

    steps = []
    for st in prog.stages:
        if st.phase in ("fold", "restore"):
            pairs = [(x.src, x.dst) for x in st.xfers]
            reads = {whole(s) for s, _ in pairs}
            if st.phase == "fold":
                reads |= {whole(d) for _, d in pairs}
                body = tuple((d, s) for s, d in pairs)
                kind = "hop"
            else:
                body = tuple((s, d, None, t)
                             for (s, d), t in zip(pairs, _tags(pairs)))
                kind = "restore"
            for _, d in pairs:
                written[d] = set(every)
            steps.append((kind, body, frozenset(reads - {None})))
        elif st.combine == sir.SUM:
            folds: dict = {}
            for slot in _pair_slots(st):
                for x in slot:
                    for b in x.blocks:
                        folds.setdefault((x.dst, b), [x.dst]).append(x.src)
            fresh = frozenset((r, b) for (_, b), srcs in folds.items()
                              for r in srcs if b not in written[r])
            for d, b in folds:
                written[d].add(b)
            steps.append(("fold", tuple((d, b, tuple(srcs))
                                        for (d, b), srcs in folds.items()),
                          fresh))
        else:
            copies = [(x.src, x.dst, b) for x in st.xfers for b in x.blocks]
            fresh = frozenset((s, b) for s, _, b in copies
                              if b not in written[s])
            for _, d, b in copies:
                written[d].add(b)
            tags = _tags([(s, d) for s, d, _ in copies])
            steps.append(("copy", tuple((s, d, b, t) for (s, d, b), t
                                        in zip(copies, tags)), fresh))
    for r in range(n):
        if written[r] != every:
            raise IRViolationError(
                f"{prog}: rank {r} ends without blocks "
                f"{sorted(every - written[r])} written")
    return tuple(steps)


def _pair_head(tr, steps, rop: ReduceOp, m: int, xs: dict, ds: dict) -> None:
    """Run the pair-stage steps on the local ranks' heads: ``xs`` the
    input, ``ds`` the output (the same tensors in place)."""
    xb = {r: t.view(m, -1).unbind(0) for r, t in xs.items()}
    db = {r: t.view(m, -1).unbind(0) for r, t in ds.items()}
    local = tr.local
    for kind, body, fresh in steps:
        if kind == "hop":
            _fold_stage(tr, rop, {d: [d, s] for d, s in body},
                        lambda s, d: (xs if (s, None) in fresh else ds)[s],
                        lambda d: ds[d])
        elif kind == "fold":
            _fold_stage(tr, rop, {(d, b): srcs for d, b, srcs in body},
                        lambda s, k: (xb if (s, k[1]) in fresh else db)[s][k[1]],
                        lambda k: db[k[0]][k[1]])
        else:
            def view(r, b, out=False):
                if out or (r, b) not in fresh:
                    return ds[r] if b is None else db[r][b]
                return xs[r] if b is None else xb[r][b]

            tr.run([Msg(s, d, view(s, b) if s in local else None,
                        view(d, b, out=True) if d in local else None, t)
                    for s, d, b, t in body if s in local or d in local])


def _pair_allreduce(call: _Call, prog: IRProgram, steps, rop: ReduceOp, out):
    """The pair-stage families' allreduce: the head over the ``scheduled``
    block owners by the pair steps, the < m-element tail by the dense
    fold (the JAX ``_pair_family_exec``)."""
    if rop.name != "sum":
        raise NotImplementedError(
            f"IR family {prog.family!r} lowers op='sum' only (got {rop.name!r})"
        )
    dest = call.out_buffers(out)
    count = next(iter(call.flat.values())).numel()
    m = prog.scheduled
    head = _split(count, m)
    if head:
        _pair_head(call.tr, steps, rop, m,
                   {r: t[:head] for r, t in call.flat.items()},
                   {r: d[:head] for r, d in dest.items()})
    if head < count:
        _dense_tail({r: t[head:] for r, t in call.flat.items()}, call.tr,
                    rop, {r: d[head:] for r, d in dest.items()})
    return call.give(dest, call.shape)


# ----------------------------------------------------------------- entry


class LoweredIR:
    """A verified, lowered program: ``f(x, comm=None, *, out=None)`` is its
    allreduce over ``comm``, with ``x``, ``comm`` and ``out`` as
    :func:`.allreduce.allreduce` takes them."""

    def __init__(self, prog: IRProgram, rop: ReduceOp):
        self.prog, self.rop = prog, rop
        self.steps = None if prog.family in ("tree", "ring", "lonely") \
            else _pair_steps(prog)

    def __call__(self, x, comm=None, *, out=None):
        call = _Call(x, comm)
        self.rop.check_dtype(call.dtype)
        if call.n != self.prog.num_nodes:
            raise ValueError(f"{self.prog} runs on {self.prog.num_nodes} "
                             f"ranks, got {call.n}")
        return self.run(call, out)

    def run(self, call: _Call, out):
        if self.steps is None:
            return _allreduce(call, self.prog.topo, self.rop,
                              self.prog.chunks, out)
        return _pair_allreduce(call, self.prog, self.steps, self.rop, out)


def lower_ir(prog: IRProgram, op: str = "sum") -> LoweredIR:
    """Lower a (verified) IR program; returns its :class:`LoweredIR`.

    Call only through ``schedule.ir.compile_ir`` — this function assumes
    the model checks already ran; it re-checks only the canonical-twin
    structural equality (the IR/executable-divergence guard)."""
    _require_canonical(prog)
    return LoweredIR(prog, get_op(op))


def pair_call_shape(prog: IRProgram, count: int):
    """The fold stages ``(R folds, W sources, L elements)`` and the messages
    of one call of a pair-stage program on ``count`` elements a rank (see
    :func:`.allreduce.call_shape`)."""
    m = prog.scheduled
    head = _split(count, m)
    folds, messages = [], 0
    if head:
        for kind, body, _ in _pair_steps(prog):
            if kind == "hop":
                folds.append((len(body), 2, head))
            elif kind == "fold":
                folds.append((len(body), len(body[0][2]), head // m))
            else:
                messages += len(body)
    return folds, messages, head
