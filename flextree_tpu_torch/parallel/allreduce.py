"""FlexTree collectives on PyTorch: one schedule walker over two transports.

PyTorch counterpart of ``flextree_tpu/parallel/allreduce.py``, and the
reference's own design (``mpi_mod.hpp:246-660, 953-1163``): each stage is
a point-to-point exchange between the members of a rank's group, then one
multi-source local fold.  The JAX package lowered the stages to grouped
XLA collectives; here a walker hands each fold stage to a transport, which
finds every source of each local rank's fold where it lies, and folds all
of them with one call of the hand-written fold kernel
(:func:`~..ops.reduce_stacked.reduce_sources`), which reads its sources
through pointers: no stage builds a stack of what it folds.  Two
transports:

- **in-process**, over a :class:`~.mesh.Mesh`: this process runs every
  rank.  A fold reads a group member's tile in place when it lies on the
  folding rank's device (on one card every rank's does), so a fold stage
  sends no message and is one kernel launch for all ranks; a member on
  another device is first copied into a receive buffer.  A gather
  message is a device copy into the receiver's slot;
- **torch.distributed**: this process is one rank of a process group; a
  stage's sends and receives are posted in one ``batch_isend_irecv``, so no
  rank waits on a peer that waits on it, and a fold reads the rank's own
  tile in place and the received ones from their receive buffers.  gloo's
  point-to-point takes CPU tensors, so on gloo a CUDA buffer is staged
  through host memory (the fold still runs on the card); NCCL moves CUDA
  tensors directly.  Every message moves the bytes of a contiguous buffer,
  whatever its dtype.

Each collective takes ``comm``, where the JAX function takes ``axis_name``:
a ``Mesh`` (then ``x`` is a sequence of the N ranks' tensors and the
result a list), or a process group (``None`` = the default one; then ``x``
is this rank's tensor).

What it computes follows the JAX package:

- **layout.** The first ``(count // N) * N`` elements (the head) run the
  schedule; the < N-element tail is reduced by one dense fold over all
  ranks in rank order and replicated (``_split_main_tail``, JAX
  ``allreduce.py:130-159``).  Tree stage ``i`` splits each rank's current
  slice into ``w_i`` contiguous tiles and the rank at group position
  ``p_i`` keeps tile ``p_i`` (``psum_scatter(tiled=True)`` ownership), so
  after a standalone :func:`reduce_scatter` rank ``r`` holds block
  ``schedule.blocks.owned_block(topo, r)``, followed by the tail.  The
  ring walks the 2(N-1) steps of ``schedule.plan.ring_plan``; lonely
  shapes (``"3,2+1"``) fold each lonely rank into its buddy, run the tree
  over the first ``m`` ranks and hand the result back.
- **arithmetic.** At a tree stage the rank keeping a tile folds the
  group's ``w`` partial tiles in the order of ``Topology.group_members``
  at ``sources_tile=1`` (a plain left fold); a ring step and a buddy fold
  are 2-source folds (own first), the ring's in place.  Every op of the
  registry is commutative, so each element's fold tree is fixed by the
  schedule alone: every rank's result is bitwise identical to every other
  rank's, across runs, across the two transports, across ``chunks``, and
  between ``all_gather(reduce_scatter(x))`` and ``allreduce(x)``.

Every schedule is a verified IR program (``schedule/ir.py``), as in the
JAX package: ``allreduce`` resolves ``topo`` through
``schedule.ir.resolve_collective`` and runs it through
``schedule.ir.compile_ir`` (emit, model-check, lower;
``parallel/ir_lower.py``).  The tree, ring and lonely shapes lower to the
walker below, bitwise and launch for launch what they ran before, and skip
the round trip above ``FT_IR_ROUTE_MAX`` ranks; the IR families
(``"swing"``, ``"gen:4,2@2"``, an ``IRFamilySpec`` or an ``IRProgram``)
always take it and run the pair-stage executor, ``op="sum"`` only.

:func:`reduce_scatter` and :func:`all_gather` take a wire ``codec``, as
the JAX functions do: a lossy one (``"bf16"``, ``"int8"``) runs the
compressed halves of ``parallel/compressed.py``.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple

import torch

from ..ops.reduce import ReduceOp, get_op
from ..ops.reduce_stacked import overlaps, reduce_sources
from ..schedule.ir import (
    IRFamilySpec,
    IRProgram,
    compile_ir,
    emit_ir,
    resolve_collective,
)
from ..schedule.stages import LonelyTopology, Topology
from .mesh import Mesh

__all__ = [
    "allreduce",
    "tree_allreduce",
    "lonely_allreduce",
    "ring_allreduce",
    "dense_allreduce",
    "reduce_scatter",
    "all_gather",
    "allgather",
    "MeshTransport",
    "DistTransport",
    "CallShape",
    "call_shape",
    "chunk_sizes",
    "WireCounters",
    "wire",
    "counting_wire",
]

# ------------------------------------------------------------- transports


@dataclass
class Msg:
    """One message of a stage: ``src`` sends ``send`` into ``dst``'s
    ``recv``.  ``send`` is given where ``src`` runs in this process,
    ``recv`` where ``dst`` does; both are contiguous and of one size.
    ``tag`` tells apart a stage's messages between the same two ranks."""

    src: int
    dst: int
    send: torch.Tensor | None
    recv: torch.Tensor | None
    tag: int = 0


class WireCounters:
    """The messages and bytes the transports send, per sending rank: the
    first piece of the recorded trace of the port's collective calls that
    ROADMAP plans.  The JAX package counts a step's collective bytes from
    its lowered program (``analysis/hlo_lint.py``:
    ``collective_wire_bytes``, ``collective_counts``); the port has no
    lowered program, so it counts what the transports do send.

    A message is one piece one rank sends another: each message of
    :meth:`MeshTransport.run` and :meth:`DistTransport.run` whose sender
    runs in this process, and each fold source a mesh rank reads from
    another rank in place (a message on a wire of separate devices; see
    :meth:`MeshTransport.sources`), so a mesh and a process group count
    the same schedule alike.  Its bytes are those of the sent buffer,
    whatever its dtype.  The rank is the transport's rank (the rank in
    the process group, or in the mesh the collective ran over).

    The transports count only while :attr:`on` (inside a
    :func:`counting_wire` block): then a message costs two integer adds on
    the host, no device sync and no read of a tensor's values; otherwise
    it costs one test of a flag."""

    def __init__(self):
        self.on = False
        self.messages: dict = {}
        self.bytes: dict = {}

    def add(self, rank: int, t: torch.Tensor) -> None:
        self.messages[rank] = self.messages.get(rank, 0) + 1
        self.bytes[rank] = self.bytes.get(rank, 0) + \
            t.numel() * t.element_size()

    def reset(self) -> None:
        self.messages, self.bytes = {}, {}

    def read(self) -> dict:
        """``{"messages": {rank: n}, "bytes": {rank: n}}`` since the last
        reset."""
        return {"messages": dict(self.messages), "bytes": dict(self.bytes)}


#: the process's counters (every transport adds to them)
wire = WireCounters()


@contextlib.contextmanager
def counting_wire():
    """Reset :data:`wire`, count while the block runs, and yield it: read
    it inside or after the block to get what the block's collectives
    sent."""
    wire.reset()
    was, wire.on = wire.on, True
    try:
        yield wire
    finally:
        wire.on = was


def _rank(key) -> int:
    """The rank a fold of a stage's plan runs on: its key, or the key's
    first item (a pair stage keys its folds by ``(rank, block)``)."""
    return key if isinstance(key, int) else key[0]


class MeshTransport:
    """Every rank of a :class:`Mesh`, in this process.  A message is one
    device copy from the sender's buffer into the receiver's slot of a
    gather; a fold reads its sources in place (:meth:`sources`)."""

    def __init__(self, mesh: Mesh):
        self.size = mesh.size
        self.local = frozenset(range(mesh.size))
        self.devices = mesh.devices

    def run(self, msgs) -> None:
        count = wire.on
        for m in msgs:
            if count:
                wire.add(m.src, m.send)
            m.recv.copy_(m.send)

    def sources(self, plan: dict, piece) -> dict:
        """The sources of each fold of a stage, in fold order: ``plan[k]``
        lists the ranks whose ``piece(s, k)`` fold ``k`` reads, on rank
        ``_rank(k)``.  A piece on that rank's device is read where it
        lies; one on another device is first copied to it.  Each piece of
        another rank counts as a message of its rank
        (:class:`WireCounters`)."""
        out, count = {}, wire.on
        for k, srcs in plan.items():
            d = _rank(k)
            got = []
            for s in srcs:
                t = piece(s, k)
                if count and s != d:
                    wire.add(s, t)
                got.append(t if t.device == self.devices[d] else
                           t.to(self.devices[d]))
            out[k] = got
        return out


class DistTransport:
    """This process as one rank of a ``torch.distributed`` process group
    (``group=None``: the default group)."""

    def __init__(self, group=None):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("no process group: call parallel.launch."
                               "init_distributed first, or pass a Mesh")
        self.dist = dist
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.local = frozenset((self.rank,))
        self.host_staged = dist.get_backend(group) == "gloo"

    def _peer(self, rank: int) -> int:
        if self.group is None:
            return rank
        return self.dist.get_global_rank(self.group, rank)

    def run(self, msgs) -> None:
        dist = self.dist
        ops, staged, count = [], [], wire.on
        for m in msgs:
            if m.src == self.rank:
                t = m.send
                if count:
                    wire.add(self.rank, t)
                if self.host_staged and t.is_cuda:
                    t = t.cpu()  # gloo's send/recv take CPU tensors
                ops.append(dist.P2POp(dist.isend, t.view(torch.uint8),
                                      self._peer(m.dst), self.group, m.tag))
            if m.dst == self.rank:
                t = m.recv
                if self.host_staged and t.is_cuda:
                    buf = torch.empty(t.shape, dtype=t.dtype)
                    staged.append((t, buf))
                    t = buf
                ops.append(dist.P2POp(dist.irecv, t.view(torch.uint8),
                                      self._peer(m.src), self.group, m.tag))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        for dst, buf in staged:
            dst.copy_(buf)

    def sources(self, plan: dict, piece) -> dict:
        """This rank's fold sources of a stage (see
        :meth:`MeshTransport.sources`): its own pieces in place, each
        other's received into a buffer shaped as its own piece (every rank
        of a fold is among its sources); the pieces other ranks' folds
        need from this rank are sent."""
        me, msgs, got, tags = self.rank, [], {}, {}
        for k, srcs in plan.items():
            d = _rank(k)
            for s in srcs:
                if s == d or me not in (s, d):
                    continue
                tag = tags[s, d] = tags.get((s, d), -1) + 1
                if s == me:
                    msgs.append(Msg(s, d, piece(s, k), None, tag))
                else:
                    got[s, k] = torch.empty_like(piece(d, k))
                    msgs.append(Msg(s, d, None, got[s, k], tag))
        self.run(msgs)
        return {k: [piece(me, k) if s == me else got[s, k] for s in srcs]
                for k, srcs in plan.items() if _rank(k) == me}


def _exchange(tr, pairs, send, recv) -> None:
    """Run one stage: for each ``(src, dst)`` pair that touches a local
    rank, ``send(src, dst)`` (at a local src) goes into ``recv(dst, src)``
    (at a local dst)."""
    local = tr.local
    tr.run([Msg(s, d, send(s, d) if s in local else None,
                recv(d, s) if d in local else None)
            for s, d in pairs if s in local or d in local])


# ------------------------------------------------------------ the walker


def _fold_stage(tr, rop: ReduceOp, plan: dict, piece, out) -> dict:
    """One fold stage: each fold ``k`` of ``plan`` (on rank ``_rank(k)``)
    folds ``piece(s, k)`` for ``s`` in ``plan[k]``, in that order, into
    ``out(k)``.  The local folds go to :func:`reduce_sources` together,
    one call per device (one launch for a mesh on one card).  Returns
    ``{k: out(k)}`` for the local folds."""
    got = tr.sources(plan, piece)
    outs = {k: out(k) for k in got}
    by_device: dict = {}
    for k, sources in got.items():
        by_device.setdefault(outs[k].device, []).append((sources, outs[k]))
    for folds in by_device.values():
        reduce_sources(folds, rop)
    return outs


def _tree_rs(bufs: dict, tr, topo: Topology, rop: ReduceOp) -> dict:
    """Phase 1 (``mpi_mod.hpp:988-1029``): per stage, each rank of the tree
    folds tile ``p_r`` (its group position) of every group member's slice,
    in group order, into a new shard.  Returns each tree rank's shard."""
    for i, w in enumerate(topo.widths):
        g = topo.gaps[i]
        tiles = {r: b.view(w, -1) for r, b in bufs.items()}
        bufs = _fold_stage(
            tr, rop, {d: grp for grp in topo.groups(i) for d in grp},
            lambda s, d: tiles[s][(d // g) % w],
            lambda d: torch.empty(tiles[d].shape[1], dtype=tiles[d].dtype,
                                  device=tiles[d].device))
    return bufs


def _tree_ag(bufs: dict, tr, topo: Topology, dest: dict | None) -> dict:
    """Phase 2 (``mpi_mod.hpp:1050-1060``): stages unwound in reverse, each
    rank's tile landing at its group position; the last stage writes into
    ``dest`` when given."""
    for i in reversed(range(topo.num_stages)):
        w, g = topo.widths[i], topo.gaps[i]
        local = [r for r in tr.local if r < topo.num_nodes]
        outs = {}
        for r in local:
            n_out = w * bufs[r].numel()
            out = dest[r] if i == 0 and dest is not None else \
                torch.empty(n_out, dtype=bufs[r].dtype, device=bufs[r].device)
            outs[r] = out.view(w, -1)
            outs[r][(r // g) % w].copy_(bufs[r])
        pairs = [(s, d) for grp in topo.groups(i) for s in grp for d in grp
                 if s != d]
        _exchange(tr, pairs, lambda s, d: bufs[s],
                  lambda d, s: outs[d][(s // g) % w])
        bufs = {r: outs[r].view(-1) for r in local}
    return bufs


def _ring_pairs(n: int):
    return [(r, (r + 1) % n) for r in range(n)]


def _ring_rs(blocks: dict, tr, rop: ReduceOp) -> None:
    """The ring's N-1 fold steps on ``(N, B)`` block views, in place
    (``mpi_mod.hpp:1119-1147``): at step ``s`` rank ``r`` folds block
    ``k = (r - s - 1) % N`` of its left neighbour into its own block ``k``
    (own first); afterwards it holds block ``(r + 1) % N`` fully reduced.
    No rank writes a block that another rank reads in the same step, so a
    step is one fold stage; step ``s + 1`` reads what step ``s`` wrote."""
    n = tr.size
    ring = {d: [d, (d - 1) % n] for d in range(n)}
    for step in range(n - 1):
        _fold_stage(tr, rop, ring,
                    lambda s, d: blocks[s][(d - step - 1) % n],
                    lambda d: blocks[d][(d - step - 1) % n])


def _ring_ag(blocks: dict, tr) -> None:
    """The ring's N-1 forwarding steps (``mpi_mod.hpp:1149-1159``): at step
    ``s`` rank ``r`` forwards block ``(r + 1 - s) % N`` right and receives
    block ``(r - s) % N`` in place — never the block it sends this step."""
    n = tr.size
    for step in range(n - 1):
        _exchange(tr, _ring_pairs(n),
                  lambda s, d: blocks[s][(s + 1 - step) % n],
                  lambda d, s: blocks[d][(d - step) % n])


def _buddy_fold(heads: dict, tr, topo: LonelyTopology, rop: ReduceOp) -> dict:
    """Each buddy ``i`` folds lonely rank ``m + i``'s head into its own
    (own first); the tree ranks' slices are returned."""
    m = topo.tree.num_nodes
    cur = {r: heads[r] for r in tr.local if r < m}
    cur.update(_fold_stage(
        tr, rop, {i: [i, m + i] for i in range(topo.lonely)},
        lambda s, d: heads[s], lambda d: torch.empty_like(heads[d])))
    return cur


def _hand_back(bufs: dict, tr, topo: LonelyTopology, into: dict) -> None:
    """Buddy ``i`` sends its buffer to lonely rank ``m + i``, which receives
    it into ``into[m + i]``."""
    m, lonely = topo.tree.num_nodes, topo.lonely
    _exchange(tr, [(i, m + i) for i in range(lonely)],
              lambda s, d: bufs[s], lambda d, s: into[d])


def _dense_tail(tails: dict, tr, rop: ReduceOp, dest: dict) -> None:
    """The < N-element tail: every rank folds all ranks' tails in rank
    order (the JAX ``_small_dense_allreduce``) into ``dest``.  In place
    (``dest[r]`` is ``x[r]``'s tail, which every rank's fold reads) the
    tails are snapshot first."""
    if any(o.device == t.device and overlaps(o, t)
           for o in dest.values() for t in tails.values()):
        tails = {r: t.clone() for r, t in tails.items()}
    n = tr.size
    _fold_stage(tr, rop, {d: list(range(n)) for d in range(n)},
                lambda s, d: tails[s], lambda d: dest[d])


# ---------------------------------------------------- binding and layout


class _Call:
    """One collective call: the transport, this process's ranks' flat
    buffers, and how to hand results back in the caller's form."""

    def __init__(self, x, comm):
        if isinstance(comm, Mesh):
            self.tr = MeshTransport(comm)
            xs = list(x)
            if len(xs) != comm.size:
                raise ValueError(f"{len(xs)} tensors for a mesh of "
                                 f"{comm.size} ranks")
            for r, t in enumerate(xs):
                if t.device != comm.devices[r]:
                    raise ValueError(f"rank {r}'s tensor is on {t.device}, "
                                     f"the mesh puts rank {r} on "
                                     f"{comm.devices[r]}")
            self.mesh = True
        else:
            self.tr = DistTransport(comm)
            xs = {self.tr.rank: x}
            self.mesh = False
        self.x = dict(enumerate(xs)) if self.mesh else xs
        first = next(iter(self.x.values()))
        self.shape, self.dtype = first.shape, first.dtype
        if any(t.shape != self.shape or t.dtype != self.dtype
               for t in self.x.values()):
            raise ValueError("every rank's tensor must have one shape and "
                             "dtype")
        self.flat = {r: t.reshape(-1) for r, t in self.x.items()}
        self.n = self.tr.size

    def out_buffers(self, out):
        """Flat result buffers: the caller's ``out`` (a list per rank on a
        mesh, a tensor otherwise), or new ones."""
        if out is None:
            return {r: torch.empty_like(t) for r, t in self.flat.items()}
        outs = dict(enumerate(out)) if self.mesh else {self.tr.rank: out}
        res = {}
        for r, t in self.flat.items():
            o = outs[r]
            if o.numel() != t.numel() or o.dtype != t.dtype or \
                    o.device != t.device or not o.is_contiguous():
                raise ValueError("out must match the input's size, dtype and "
                                 "device, contiguous")
            res[r] = o.view(-1)
        return res

    def give(self, bufs: dict, shape=None):
        """Results in the caller's form: a list on a mesh, else a tensor."""
        res = {r: t if shape is None else t.view(shape)
               for r, t in bufs.items()}
        return [res[r] for r in range(self.n)] if self.mesh else \
            res[self.tr.rank]


#: Above this rank count ``allreduce`` skips the IR emit+verify round trip
#: for the tree, ring and lonely shapes (emission is O(N^2) pure Python)
#: and runs the identical walker directly; explicitly requested IR
#: families (swing/generalized) take the IR route at any size.  Env
#: override: ``FT_IR_ROUTE_MAX`` (0 disables the implicit IR route).
IR_ROUTE_MAX_ENV = "FT_IR_ROUTE_MAX"


def _ir_route_max() -> int:
    try:
        return int(os.environ.get(IR_ROUTE_MAX_ENV, "64"))
    except ValueError:
        return 64


@lru_cache(maxsize=512)
def _compile_cached(prog: IRProgram, op_name: str):
    return compile_ir(prog, op=op_name)


@lru_cache(maxsize=512)
def _compiled(resolved, chunks: int, op_name: str):
    """The lowered program of a resolved topology, keyed by the topology
    (cheap to hash) rather than by its program."""
    n = resolved.num_nodes
    return compile_ir(emit_ir(resolved, count=n * n * max(1, chunks),
                              chunks=chunks), op=op_name)


def _ir_route(call, resolved, rop: ReduceOp, chunks: int, out):
    """Verified-before-compiled execution: emit (or accept) the IR
    program, model-check it, lower it (``schedule.ir.compile_ir``), run
    it — the checker and the executor derive from the same object.
    Emission, checks and lowering are memoized per (shape, chunks, op)."""
    if isinstance(resolved, IRProgram):
        return _compile_cached(resolved, rop.name).run(call, out)
    eff_chunks = 1
    if isinstance(resolved, Topology) and not resolved.is_ring and chunks > 1:
        n = resolved.num_nodes
        head = _split(next(iter(call.flat.values())).numel(), n)
        eff_chunks = len(chunk_sizes(head, n, chunks)) if head else 1
    return _compiled(resolved, eff_chunks, rop.name).run(call, out)


def _owners(topo) -> int:
    return topo.tree.num_nodes if isinstance(topo, LonelyTopology) else \
        topo.num_nodes


def _split(count: int, owners: int) -> int:
    """Elements of the schedule's head: ``(count // owners) * owners``."""
    return (count // owners) * owners


def _scatter(heads: dict, tr, topo, rop: ReduceOp,
             in_place: bool = False) -> dict:
    """Phase 1: fold the divisible heads down to shards.  Returns the shard
    of each local rank that owns a block (every rank, or a lonely shape's
    tree ranks): block ``owned_block(topo, r)`` of the reduced head.  The
    ring folds in the heads themselves when ``in_place``, else in a copy."""
    if isinstance(topo, LonelyTopology):
        return _tree_rs(_buddy_fold(heads, tr, topo, rop), tr, topo.tree,
                        rop)
    if topo.is_ring:
        n = tr.size
        blocks = {r: (h if in_place else h.clone()).view(n, -1)
                  for r, h in heads.items()}
        _ring_rs(blocks, tr, rop)
        return {r: blocks[r][(r + 1) % n] for r in tr.local}
    return _tree_rs(heads, tr, topo, rop)


def _gather(shards: dict, tr, topo, dest: dict) -> None:
    """Phase 2: gather the owners' shards in block order into every local
    rank's ``dest``; a lonely shape's tree hands its result to the lonely
    ranks."""
    if isinstance(topo, LonelyTopology):
        m = topo.tree.num_nodes
        got = _tree_ag({r: s for r, s in shards.items() if r < m}, tr,
                       topo.tree, {r: dest[r] for r in tr.local if r < m})
        _hand_back(got, tr, topo, {r: dest[r] for r in tr.local if r >= m})
    elif topo.is_ring:
        n = tr.size
        blocks = {r: dest[r].view(n, -1) for r in tr.local}
        for r in tr.local:
            own = blocks[r][(r + 1) % n]
            if own.data_ptr() != shards[r].data_ptr():
                own.copy_(shards[r])
        _ring_ag(blocks, tr)
    else:
        _tree_ag(shards, tr, topo, dest)


def _head_allreduce(heads: dict, tr, topo, rop: ReduceOp, dest: dict,
                    chunks: int) -> None:
    """Allreduce the divisible heads into ``dest``: phase 1 then phase 2,
    on each of a tree's ``chunks`` pieces in turn (the ring and lonely
    shapes run whole, as in the JAX package).  The ring folds in ``dest``
    itself, after a copy of the heads."""
    if topo.is_ring:
        for r in tr.local:
            if dest[r].data_ptr() != heads[r].data_ptr():
                dest[r].copy_(heads[r])
        heads = dest
    count = next(iter(heads.values())).numel()
    whole = topo.is_ring or isinstance(topo, LonelyTopology)
    off = 0
    for size in [count] if whole else chunk_sizes(count, tr.size, chunks):
        piece = {r: h[off:off + size] for r, h in heads.items()}
        _gather(_scatter(piece, tr, topo, rop, in_place=topo.is_ring), tr,
                topo, {r: d[off:off + size] for r, d in dest.items()})
        off += size


class CallShape(NamedTuple):
    """What one :func:`allreduce` call (``chunks=1``) does on a mesh whose
    ranks share one device, from :func:`call_shape`."""

    #: the fold stages in order, each ``(R folds, W sources, L elements)``:
    #: one :func:`reduce_sources` call of R folds
    folds: list
    #: the gather phase's messages (:meth:`MeshTransport.run`'s copies)
    messages: int
    #: the device copies of an in-place call: the messages, each tree
    #: rank's own tile at each gather stage, and one snapshot a rank of
    #: the tail when there is one
    copies: int


def call_shape(num_nodes: int, topo, count: int) -> CallShape:
    """Derive, from the topology alone, the fold stages and copies of one
    allreduce of ``count`` elements a rank over ``num_nodes`` ranks (``topo``
    as :func:`allreduce` takes it).  A buddy fold is one 2-source
    fold of the whole head on every buddy; a tree stage of width w, one
    fold of w tiles on every tree rank; a ring step, one 2-source fold on
    every rank; the tail, one fold of all ranks' tails on every rank.  The
    fold stages copy nothing; the gather sends w - 1 messages to every
    tree rank a tree stage, one to every rank a ring step, one to every
    lonely rank.  An IR family's program (swing, generalized): one fold
    stage a ``sum`` row, of one fold a receiving rank and block, whose W
    is one plus the row's senders into that block; the fold hop, one
    2-source fold of the whole head on every buddy; a message a block of
    each ``copy`` row and one to every extra rank (the restore hop)."""
    topo = resolve_collective(num_nodes, topo)
    if isinstance(topo, IRProgram) and topo.topo is not None:
        topo = topo.topo  # a tree, ring or lonely program runs the walker
    if isinstance(topo, (IRFamilySpec, IRProgram)):
        from .ir_lower import pair_call_shape

        folds, messages, head = pair_call_shape(emit_ir(topo), count)
        tail = num_nodes if head < count else 0
        if tail:
            folds.append((num_nodes, num_nodes, count - head))
        return CallShape(folds, messages, messages + tail)
    lonely = isinstance(topo, LonelyTopology)
    tree = topo.tree if lonely else topo
    owners = tree.num_nodes
    head = _split(count, owners)
    folds, messages, own = [], 0, 0
    if head and lonely:
        folds.append((topo.lonely, 2, head))
        messages += topo.lonely
    if head and topo.is_ring:
        folds += [(num_nodes, 2, head // num_nodes)] * (num_nodes - 1)
        messages += num_nodes * (num_nodes - 1)
    elif head:
        length = head
        for w in tree.widths:
            length //= w
            folds.append((owners, w, length))
            messages += owners * (w - 1)
            own += owners
    tail = num_nodes if head < count else 0
    if tail:
        folds.append((num_nodes, num_nodes, count - head))
    return CallShape(folds, messages, messages + own + tail)


def chunk_sizes(total: int, n: int, chunks: int) -> list[int]:
    """Split ``total`` (a multiple of ``n``) into at most ``chunks``
    contiguous pieces, each a multiple of ``n``, sizes as balanced as
    possible (the JAX ``_chunk_sizes``)."""
    blocks = total // n
    c = max(1, min(chunks, blocks))
    base, rem = divmod(blocks, c)
    return [(base + (1 if i < rem else 0)) * n for i in range(c)]


def _allreduce(call: _Call, topo, rop: ReduceOp, chunks: int, out):
    dest = call.out_buffers(out)
    count = next(iter(call.flat.values())).numel()
    head = _split(count, _owners(topo))
    if head:
        _head_allreduce({r: t[:head] for r, t in call.flat.items()}, call.tr,
                        topo, rop, {r: d[:head] for r, d in dest.items()},
                        chunks)
    if head < count:
        _dense_tail({r: t[head:] for r, t in call.flat.items()}, call.tr,
                    rop, {r: d[head:] for r, d in dest.items()})
    return call.give(dest, call.shape)


def _world_of_one(call: _Call, x, out):
    """A world of one rank: ``x`` itself, or a copy of it in ``out``."""
    if out is None:
        return x
    dest = call.out_buffers(out)
    for r, t in call.flat.items():
        if dest[r].data_ptr() != t.data_ptr():
            dest[r].copy_(t)
    return call.give(dest, call.shape)


# ------------------------------------------------------- public entries


def allreduce(x, comm=None, topo=None, op="sum", chunks: int = 1, *,
              out=None):
    """Topology-parameterized allreduce of ``x`` over ``comm``.

    The counterpart of ``jax.lax.psum(x, axis_name)`` (for ``op='sum'``)
    and of the reference's ``MPI_Allreduce_FT`` (``mpi_mod.hpp:1167-1221``).
    ``comm``: a :class:`~.mesh.Mesh` (``x`` is the list of its N ranks'
    tensors; returns a list) or a process group (``None``: the default
    group; ``x`` is this rank's tensor).  ``topo`` accepts what
    ``schedule.ir.resolve_collective`` does (None -> ``FT_TOPO`` or flat;
    widths; a ``"4,2"`` spec; ``"3,2+1"`` lonely specs; the ring ``"1"``;
    the IR families ``"swing"`` and ``"gen:4,2@2"``, an ``IRFamilySpec``
    or an ``IRProgram``).  A world of one returns ``x`` (copied into
    ``out`` when given); the ring sentinel runs the ring, a lonely shape
    the buddy protocol, an IR family its pair stages (``op="sum"`` only;
    ``chunks`` ignored), anything else the k-ary tree, ``chunks > 1``
    splitting a tree's head into that many pieces run one after another
    (the bits do not change).  Every schedule is model-checked before it
    first runs (``schedule.ir.compile_ir``; above ``FT_IR_ROUTE_MAX``
    ranks only the IR families are).  ``out``: where the result goes (per
    rank on a mesh; it may be ``x`` itself, the ``MPI_IN_PLACE`` path).
    """
    call = _Call(x, comm)
    rop = get_op(op)
    rop.check_dtype(call.dtype)
    if call.n <= 1:
        return _world_of_one(call, x, out)
    resolved = resolve_collective(call.n, topo)
    if isinstance(resolved, (IRFamilySpec, IRProgram)) or \
            call.n <= _ir_route_max():
        return _ir_route(call, resolved, rop, chunks, out)
    return _allreduce(call, resolved, rop, chunks, out)


def tree_allreduce(x, comm=None, topo=None, op="sum", chunks: int = 1, *,
                   out=None):
    """Hierarchical allreduce with per-stage widths ``topo.widths`` (a
    lonely shape runs :func:`lonely_allreduce`).  See :func:`allreduce`."""
    return allreduce(x, comm, topo, op, chunks, out=out)


def lonely_allreduce(x, comm=None, topo=None, op="sum", *, out=None):
    """Allreduce for ``"4,2+1"``-style shapes: the tree over the first ``m``
    ranks, each lonely rank ``m + i`` folded into buddy ``i`` first and
    handed the result after (JAX ``allreduce.py:280``); the < m-element
    tail is one dense fold over all ranks.  Any other topology runs as
    :func:`allreduce` runs it."""
    return allreduce(x, comm, topo, op, out=out)


def ring_allreduce(x, comm=None, op="sum", *, out=None):
    """The classic 2(N-1)-step ring (``mpi_mod.hpp:1113-1163``)."""
    call = _Call(x, comm)
    rop = get_op(op)
    rop.check_dtype(call.dtype)
    if call.n <= 1:
        return _world_of_one(call, x, out)
    return _allreduce(call, Topology.ring(call.n), rop, 1, out)


def dense_allreduce(x, comm=None, op="sum", *, out=None):
    """Every rank folds all ranks' buffers in rank order: one fold of N
    sources a rank, a stage of one :func:`reduce_sources` call on a mesh.
    The fold :func:`allreduce` gives a tail, over a whole buffer: the
    elementwise all-reduce that stands for the JAX package's native
    ``psum`` (the gradient sync's ``"psum"`` sentinel, a bucket's fused
    tails), the same bits on a mesh and on a process group.  See
    :func:`allreduce` for ``comm`` and ``out``."""
    call = _Call(x, comm)
    rop = get_op(op)
    rop.check_dtype(call.dtype)
    if call.n <= 1:
        return _world_of_one(call, x, out)
    dest = call.out_buffers(out)
    _dense_tail(call.flat, call.tr, rop, dest)
    return call.give(dest, call.shape)


def reduce_scatter(x, comm=None, topo=None, op="sum", codec=None, step=0):
    """Phase 1 alone: this rank's reduced shard of ``x``.

    A 1-D buffer of ``count // N + count % N`` elements: block
    ``schedule.blocks.owned_block(topo, r)`` of the head (``N`` head
    blocks), then the < N-element tail, reduced by the dense fold and
    replicated.  Lonely shapes split the head over the ``m`` tree ranks
    and lonely rank ``m + i`` holds a bitwise copy of buddy ``i``'s shard.
    On a mesh, returns the list of the N shards.

    A lossy ``codec`` compresses the wire hop by hop
    (:func:`.compressed.compressed_reduce_scatter`, ``step`` keying its
    rounding; sum only)."""
    from ..ops.quantize import get_codec

    if get_codec(codec).lossy:
        from .compressed import compressed_reduce_scatter

        return compressed_reduce_scatter(x, comm, topo, codec, step)
    call = _Call(x, comm)
    rop = get_op(op)
    rop.check_dtype(call.dtype)
    if call.n <= 1:
        return call.give(call.flat)
    topo = Topology.resolve(call.n, topo)
    tr = call.tr
    count = next(iter(call.flat.values())).numel()
    head = _split(count, _owners(topo))
    tile = head // _owners(topo)
    shards = {r: torch.empty(tile + count - head, dtype=call.dtype,
                             device=t.device) for r, t in call.flat.items()}
    if head:
        got = _scatter({r: t[:head] for r, t in call.flat.items()}, tr, topo,
                       rop)
        for r, g in got.items():
            shards[r][:tile].copy_(g)
        if isinstance(topo, LonelyTopology):  # mirror the buddy's shard
            _hand_back(got, tr, topo, {r: shards[r][:tile] for r in tr.local
                                       if r >= topo.tree.num_nodes})
    if head < count:
        _dense_tail({r: t[head:] for r, t in call.flat.items()}, tr, rop,
                    {r: s[tile:] for r, s in shards.items()})
    return call.give(shards)


def all_gather(x, comm=None, topo=None, out_shape=None, codec=None, step=0):
    """Phase 2 alone: the inverse of :func:`reduce_scatter` on the same
    topology.

    ``x`` is a shard in ``reduce_scatter``'s layout (owned head block, then
    the replicated tail); the head blocks are gathered in block order and
    the tail appended, so the result is bitwise what :func:`allreduce`
    gives.  The split of a shard into block and tail is ambiguous from its
    length alone, so it is derived from ``out_shape`` when given (block =
    ``count // owners``); without it the shard is taken as a pure block.
    ``out_shape`` also restores the original shape.  A lossy ``codec``
    forwards the head block encoded (:func:`.compressed.compressed_all_gather`,
    ``step`` keying its rounding)."""
    from ..ops.quantize import get_codec

    if get_codec(codec).lossy:
        from .compressed import compressed_all_gather

        return compressed_all_gather(x, comm, topo, out_shape, codec, step)
    call = _Call(x, comm)
    count = None if out_shape is None else int(
        torch.Size(out_shape).numel())
    if call.n <= 1:
        res = call.flat
    else:
        topo = Topology.resolve(call.n, topo)
        owners = _owners(topo)
        shard_len = next(iter(call.flat.values())).numel()
        if count is None:
            tile = shard_len
        else:
            tile = count // owners
            if tile + count % owners != shard_len:
                raise ValueError(
                    f"shard of {shard_len} elements does not match out_shape "
                    f"{tuple(out_shape)} over {owners} owners (expected "
                    f"{tile + count % owners})")
        tail = shard_len - tile
        res = {r: torch.empty(owners * tile + tail, dtype=call.dtype,
                              device=t.device) for r, t in call.flat.items()}
        head = owners * tile
        if tile:
            _gather({r: t[:tile] for r, t in call.flat.items()}, call.tr,
                    topo, {r: t[:head] for r, t in res.items()})
        for r, t in call.flat.items():
            res[r][head:].copy_(t[tile:])
    if count is not None:
        res = {r: t[:count] for r, t in res.items()}
    return call.give(res, None if out_shape is None else tuple(out_shape))


def allgather(x, comm=None, topo=None, out_shape=None):
    """Backward-compatible alias for :func:`all_gather`."""
    return all_gather(x, comm, topo=topo, out_shape=out_shape)
