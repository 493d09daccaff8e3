"""Compressed FlexTree collectives: a wire codec applied hop by hop.

The port's copy of ``flextree_tpu/parallel/compressed.py``, on the
walker's transports (:class:`~.allreduce.MeshTransport`,
:class:`~.allreduce.DistTransport`).  ``allreduce`` chooses the shape of
the collective; these also choose its bytes (``ops/quantize.py``):

- **tree phase 1**, a stage at a time: each rank encodes its slice as the
  stage's ``w`` tiles in one call (the hash index runs over the padded
  ``(w, tile)`` layout), sends tile ``p`` (int8 payload and f32 scales) to
  the group member at position ``p``, and the member decodes the ``w``
  tiles it holds, its own encoded tile among them (JAX's ``all_to_all``
  includes the rank's own), and folds them in group order with one
  :func:`~..ops.reduce_stacked.reduce_sources` call for every local rank
  of the stage.  Partial sums are encoded again at the next stage;
- **tree phase 2**: the reduced tile is encoded once and its payload
  forwarded, still encoded, through the stages' gathers; every rank,
  the owner too, decodes the same bytes, so no replica drifts;
- **ring**: the 2(N-1)-step walk; the sent block is encoded a hop and the
  receiver folds its exact block with the decoded one (two sources, own
  first); phase 2 forwards encoded blocks;
- **lonely** (``"3,2+1"``): an encoded buddy fold, the prefix tree's
  stages as compressed rings within each group (not the tree's grouped
  stages), and an encoded restore after which every rank holds
  ``decode(encode(result))``.

A message carries the wire format, never decoded floats.  The < N-element
tail is folded exactly by the dense fold (``allreduce._dense_tail``, the
JAX ``_NATIVE_PSUM``).  ``bf16`` casts, runs :func:`~.allreduce.allreduce`
on bfloat16 (the fold kernel's bf16 sum) and casts back; the identity
codec is :func:`~.allreduce.allreduce`.  Sum only.

Each function takes ``comm`` as the collectives do: a :class:`~.mesh.Mesh`
(``x`` the list of its ranks' tensors; results are lists) or a process
group (``x`` this rank's tensor).  ``step`` keys the stochastic rounding
(an int or a 0-d tensor; the train step's counter).  The uniforms of an
encode depend only on its length, step and salt, so one call computes
them once for all its local ranks.

Error feedback: ``return_residual=True`` also returns ``x - C(x)``: from
the wire's own stage-0 encode for a tree shape (so the residual
telescopes exactly), the canonical local map (:func:`local_residual`)
for the ring and lonely shapes, 0 on the exact tail.
"""

from __future__ import annotations

import torch

from ..ops.quantize import (
    Codec,
    _pad_to_block,
    _quantize,
    _uniform01,
    decode_int8,
    get_codec,
)
from ..ops.reduce import get_op
from ..ops.reduce_stacked import reduce_sources
from ..schedule.stages import LonelyTopology, Topology
from .allreduce import (
    Msg,
    _Call,
    _dense_tail,
    _gather,
    _hand_back,
    _owners,
    _ring_ag,
    _ring_pairs,
    _scatter,
    _split,
    _tree_ag,
    all_gather,
    allreduce,
    chunk_sizes,
    reduce_scatter,
)

__all__ = [
    "compressed_allreduce",
    "compressed_reduce_scatter",
    "compressed_all_gather",
    "local_residual",
    "int8_fold_stages",
]

# salt namespaces, so no two encode sites share a rounding stream: tree
# phase-1 stage i uses salt i (stage 0 is Codec.roundtrip's salt 0)
_SALT_AG = 0x41470000
_SALT_RING = 0x52490000
_SALT_LONELY = 0x4C4F0000

_SUM = get_op("sum")


class _Encoder:
    """The encodes and decodes of one collective call: the codec's block,
    the step as an int, and each (length, salt, device)'s uniforms,
    computed once for every local rank."""

    def __init__(self, codec: Codec, step):
        self.block = codec.block
        self.step = int(step)
        self._u: dict = {}

    def encode(self, v: torch.Tensor, salt: int):
        v = _pad_to_block(v, self.block)
        key = (v.numel(), salt, v.device)
        if key not in self._u:
            self._u[key] = _uniform01(v.numel(), self.step, salt, v.device)
        return _quantize(v, self._u[key], self.block)

    def decode(self, wire, length: int) -> torch.Tensor:
        return decode_int8(*wire, length, block=self.block)

    def empty_wire(self, length: int, rows: tuple = (), device=None):
        """Receive buffers for the wire format of ``rows`` x ``length``."""
        tp = length + (-length) % self.block
        return (torch.empty(rows + (tp,), dtype=torch.int8, device=device),
                torch.empty(rows + (tp // self.block,), dtype=torch.float32,
                            device=device))


def _exchange_wire(tr, pairs, send, recv) -> None:
    """One round of wire messages: for each ``(src, dst)`` pair touching a
    local rank, the payload and scales ``send(src, dst)`` (at a local src)
    go into ``recv(dst, src)`` (at a local dst)."""
    msgs = []
    for s, d in pairs:
        if s not in tr.local and d not in tr.local:
            continue
        out = send(s, d) if s in tr.local else (None, None)
        into = recv(d, s) if d in tr.local else (None, None)
        msgs += [Msg(s, d, out[0], into[0], 0), Msg(s, d, out[1], into[1], 1)]
    tr.run(msgs)


def _fold(folds: dict) -> None:
    """Sum each ``(sources, out)`` of ``folds``: one ``reduce_sources``
    call a device for all of them."""
    by_device: dict = {}
    for sources, out in folds.values():
        by_device.setdefault(out.device, []).append((sources, out))
    for batch in by_device.values():
        reduce_sources(batch, _SUM)


# --------------------------------------------------------------- tree


def _stage_rs_int8(bufs: dict, tr, topo: Topology, stage: int,
                   enc: _Encoder):
    """One compressed phase-1 stage of the tree: returns each local rank's
    reduced tile and its encode of the stage's input (the stage-0 one is
    the residual's reference)."""
    w, g = topo.widths[stage], topo.gaps[stage]
    tile = next(iter(bufs.values())).numel() // w
    wires = {r: enc.encode(b.view(w, tile), stage) for r, b in bufs.items()}
    got = {r: enc.empty_wire(tile, (w,), b.device) for r, b in bufs.items()}
    for r, (q, s) in wires.items():  # the rank's own tile, as sent
        p = (r // g) % w
        got[r][0][p].copy_(q[p])
        got[r][1][p].copy_(s[p])
    pairs = [(s, d) for grp in topo.groups(stage) for s in grp for d in grp
             if s != d]
    _exchange_wire(
        tr, pairs,
        lambda s, d: tuple(t[(d // g) % w] for t in wires[s]),
        lambda d, s: tuple(t[(s // g) % w] for t in got[d]))
    dec = {r: enc.decode(wire, tile) for r, wire in got.items()}
    outs = {r: torch.empty(tile, dtype=torch.float32, device=b.device)
            for r, b in bufs.items()}
    _fold({r: (list(dec[r].unbind(0)), outs[r]) for r in bufs})
    return outs, wires


def _tree_rs_int8(pieces: dict, tr, topo: Topology, enc: _Encoder):
    """Every phase-1 stage of the compressed tree: each local rank's
    reduced tile, and its stage-0 encode."""
    v, wire0 = pieces, None
    for i in range(topo.num_stages):
        v, wires = _stage_rs_int8(v, tr, topo, i, enc)
        if i == 0:
            wire0 = wires
    return v, wire0


def _ag_int8(tiles: dict, tr, topo: Topology, enc: _Encoder,
             salt: int) -> dict:
    """Phase 2: each rank's tile encoded once, its payload and scales
    gathered, still encoded, through the stages in reverse (the walker's
    gather, once for each), every segment decoded at the end."""
    t = next(iter(tiles.values())).numel()
    wires = {r: enc.encode(v, salt) for r, v in tiles.items()}
    q = _tree_ag({r: w[0] for r, w in wires.items()}, tr, topo, None)
    s = _tree_ag({r: w[1] for r, w in wires.items()}, tr, topo, None)
    tp = wires[next(iter(wires))][0].numel()
    return {r: enc.decode((q[r].view(-1, tp), s[r].view(q[r].numel() // tp,
                                                         -1)), t).reshape(-1)
            for r in q}


def _tree_int8(heads: dict, tr, topo: Topology, enc: _Encoder, chunks: int,
               dest: dict, res: dict | None) -> None:
    """The compressed k-ary tree on the divisible heads, into ``dest``,
    a chunk at a time (chunk ``c``'s phase 2 uses salt ``_SALT_AG + c``);
    ``res``, when given, receives ``head - decode(stage-0 encode)``."""
    count = next(iter(heads.values())).numel()
    off = 0
    for c, size in enumerate(chunk_sizes(count, tr.size, chunks)):
        piece = {r: h[off:off + size] for r, h in heads.items()}
        tiles, wire0 = _tree_rs_int8(piece, tr, topo, enc)
        if res is not None:
            tile0 = size // topo.widths[0]
            for r, p in piece.items():
                torch.sub(p, enc.decode(wire0[r], tile0).reshape(-1),
                          out=res[r][off:off + size])
        for r, full in _ag_int8(tiles, tr, topo, enc, _SALT_AG + c).items():
            dest[r][off:off + size].copy_(full)
        off += size


# --------------------------------------------------------------- ring


def _ring_rs_int8(heads: dict, tr, enc: _Encoder) -> dict:
    """The compressed ring's N-1 fold steps on a copy of each head: at step
    ``h`` rank ``r`` encodes block ``(r - h) % N`` and sends it right; the
    receiver folds its exact block with the decoded one.  Returns each
    rank's fully reduced block ``(r + 1) % N``, never end-quantized."""
    n = tr.size
    blocks = {r: h.clone().view(n, -1) for r, h in heads.items()}
    split = next(iter(blocks.values())).shape[1]
    for hop in range(n - 1):
        wires = {r: enc.encode(b[(r - hop) % n], _SALT_RING + hop)
                 for r, b in blocks.items()}
        got = {r: enc.empty_wire(split, device=b.device)
               for r, b in blocks.items()}
        _exchange_wire(tr, _ring_pairs(n), lambda s, d: wires[s],
                       lambda d, s: got[d])
        _fold({r: ([b[(r - hop - 1) % n], enc.decode(got[r], split)],
                   b[(r - hop - 1) % n]) for r, b in blocks.items()})
    return {r: b[(r + 1) % n] for r, b in blocks.items()}


def _ring_ag_int8(owns: dict, tr, enc: _Encoder) -> dict:
    """The compressed ring's phase 2: each rank's block ``(r + 1) % N``
    encoded once, payload and scales forwarded around the ring (the
    walker's ring gather, once for each), every block decoded."""
    n = tr.size
    split = next(iter(owns.values())).numel()
    qs, ss = {}, {}
    for r, v in owns.items():
        q, s = enc.encode(v, _SALT_RING - 1)
        qs[r], ss[r] = enc.empty_wire(split, (n,), v.device)
        qs[r][(r + 1) % n].copy_(q)
        ss[r][(r + 1) % n].copy_(s)
    _ring_ag(qs, tr)
    _ring_ag(ss, tr)
    return {r: enc.decode((qs[r], ss[r]), split).reshape(-1) for r in qs}


# --------------------------------------------------------------- lonely


def _next_in_group(r: int, w: int, gap: int) -> int:
    """The successor of rank ``r`` on its stage group's ring."""
    g0 = (r // (gap * w)) * (gap * w) + r % gap
    return g0 + (((r // gap) % w + 1) % w) * gap


def _grouped_rs_int8(bufs: dict, tr, tree: Topology, stage: int,
                     enc: _Encoder) -> dict:
    """A width-w stage of the prefix tree as a compressed ring within each
    group (JAX ``_compressed_grouped_rs``): w - 1 hops, each sending one
    encoded tile to the next member and folding the decoded one into the
    exact tile it lands on.  Returns each local tree rank's tile ``p``."""
    if not bufs:  # a lonely rank of a process group: not in the tree
        return bufs
    w, g = tree.widths[stage], tree.gaps[stage]
    acc = {r: b.clone().view(w, -1) for r, b in bufs.items()}
    tile = next(iter(acc.values())).shape[1]
    pos = {r: (r // g) % w for r in acc}
    pairs = [(r, _next_in_group(r, w, g)) for r in range(tree.num_nodes)]
    for hop in range(w - 1):
        wires = {r: enc.encode(a[(pos[r] - 1 - hop) % w],
                               _SALT_LONELY + 16 * stage + hop)
                 for r, a in acc.items()}
        got = {r: enc.empty_wire(tile, device=a.device)
               for r, a in acc.items()}
        _exchange_wire(tr, pairs, lambda s, d: wires[s], lambda d, s: got[d])
        _fold({r: ([a[(pos[r] - 2 - hop) % w], enc.decode(got[r], tile)],
                   a[(pos[r] - 2 - hop) % w]) for r, a in acc.items()})
    return {r: a[pos[r]] for r, a in acc.items()}


def _grouped_ag_int8(bufs: dict, tr, tree: Topology, stage: int,
                     enc: _Encoder) -> dict:
    """The phase-2 twin of :func:`_grouped_rs_int8`: each tree rank's tile
    encoded once and forwarded, still encoded, around its group's ring;
    every segment decoded, the rank's own among them."""
    if not bufs:
        return bufs
    w, g = tree.widths[stage], tree.gaps[stage]
    t = next(iter(bufs.values())).numel()
    pos = {r: (r // g) % w for r in bufs}
    qs, ss = {}, {}
    for r, v in bufs.items():
        q, s = enc.encode(v, _SALT_LONELY + 4096 + stage)
        qs[r], ss[r] = enc.empty_wire(t, (w,), v.device)
        qs[r][pos[r]].copy_(q)
        ss[r][pos[r]].copy_(s)
    pairs = [(r, _next_in_group(r, w, g)) for r in range(tree.num_nodes)]
    for hop in range(w - 1):
        _exchange_wire(
            tr, pairs,
            lambda s, d: (qs[s][(pos[s] - hop) % w], ss[s][(pos[s] - hop) % w]),
            lambda d, s: (qs[d][(pos[d] - hop - 1) % w],
                          ss[d][(pos[d] - hop - 1) % w]))
    return {r: enc.decode((qs[r], ss[r]), t).reshape(-1) for r in qs}


def _buddy_fold_int8(heads: dict, tr, topo: LonelyTopology,
                     enc: _Encoder) -> dict:
    """Lonely rank ``m + i`` sends its encoded head to buddy ``i``, which
    folds its exact head with the decoded one (own first).  Returns the
    tree ranks' buffers."""
    m, lonely = topo.tree.num_nodes, topo.lonely
    t = next(iter(heads.values())).numel()
    wires = {r: enc.encode(h, _SALT_LONELY - 1) for r, h in heads.items()
             if r >= m}
    got = {r: enc.empty_wire(t, device=h.device) for r, h in heads.items()
           if r < lonely}
    _exchange_wire(tr, [(m + i, i) for i in range(lonely)],
                   lambda s, d: wires[s], lambda d, s: got[d])
    cur = {r: h for r, h in heads.items() if r < m}
    folds = {r: ([heads[r], enc.decode(got[r], t)], torch.empty_like(heads[r]))
             for r in got}
    _fold(folds)
    cur.update({r: out for r, (_, out) in folds.items()})
    return cur


def _ship_int8(bufs: dict, tr, topo: LonelyTopology, enc: _Encoder,
               salt: int, adopt: bool, length: int, devices: dict) -> dict:
    """Buddy ``i`` encodes its buffer of ``length`` elements and sends it
    to lonely rank ``m + i``, which decodes it.  The tree ranks keep their
    exact buffer, or with ``adopt`` their own ``decode(encode(.))``, the
    bytes they sent.  ``devices``: every local rank's device.  Returns
    every local rank's buffer."""
    m, lonely = topo.tree.num_nodes, topo.lonely
    wires = {r: enc.encode(b, salt) for r, b in bufs.items()
             if adopt or r < lonely}
    got = {r: enc.empty_wire(length, device=d) for r, d in devices.items()
           if r >= m}
    _exchange_wire(tr, [(i, m + i) for i in range(lonely)],
                   lambda s, d: wires[s], lambda d, s: got[d])
    out = {r: enc.decode(wires[r], length) if adopt else b
           for r, b in bufs.items()}
    out.update({r: enc.decode(w, length) for r, w in got.items()})
    return out


def _lonely_tree_rs_int8(heads: dict, tr, topo: LonelyTopology,
                         enc: _Encoder) -> dict:
    """The buddy fold, then the prefix tree's compressed stages: each tree
    rank's reduced tile."""
    v = _buddy_fold_int8(heads, tr, topo, enc)
    for i in range(topo.tree.num_stages):
        v = _grouped_rs_int8(v, tr, topo.tree, i, enc)
    return v


def _lonely_rs_int8(heads: dict, tr, topo: LonelyTopology,
                    enc: _Encoder) -> dict:
    """The compressed lonely phase 1: :func:`_lonely_tree_rs_int8`, then
    buddy ``i``'s tile shipped encoded to lonely rank ``m + i``, which
    holds ``decode(encode(tile))``; the tree ranks keep their exact
    tile."""
    tile = next(iter(heads.values())).numel() // topo.tree.num_nodes
    return _ship_int8(_lonely_tree_rs_int8(heads, tr, topo, enc), tr, topo,
                      enc, _SALT_LONELY - 3, False, tile,
                      {r: h.device for r, h in heads.items()})


def _lonely_ag_int8(tiles: dict, tr, topo: LonelyTopology, enc: _Encoder,
                    tile: int, devices: dict) -> dict:
    """The compressed lonely phase 2 on the tree ranks' tiles (of ``tile``
    elements): the prefix tree's compressed gathers, then the encoded
    restore, after which every local rank (``devices``) holds
    ``decode(encode(result))``."""
    m = topo.tree.num_nodes
    v = {r: t for r, t in tiles.items() if r < m}
    for i in reversed(range(topo.tree.num_stages)):
        v = _grouped_ag_int8(v, tr, topo.tree, i, enc)
    return _ship_int8(v, tr, topo, enc, _SALT_LONELY - 2, True, tile * m,
                      devices)


# ------------------------------------------------------------ entries


def _zeros(call: _Call):
    return call.give({r: torch.zeros_like(t) for r, t in call.flat.items()},
                     call.shape)


def _canonical(heads: dict, enc: _Encoder, res: dict) -> None:
    """``res[r] = head - decode(encode(head))``, salt 0: the local map."""
    for r, h in heads.items():
        torch.sub(h, enc.decode(enc.encode(h, 0), h.numel()), out=res[r])


def int8_fold_stages(n: int, topo, count: int, chunks: int = 1) -> list:
    """The fold stages, in order, of one int8 :func:`compressed_allreduce`
    of ``count`` elements a rank over ``n`` ranks, each ``(R folds, W
    sources, L elements)``, one :func:`reduce_sources` call (the walks
    above, counted): a tree stage of width w, one fold of w decoded tiles
    on every rank, a chunk at a time; a ring hop, one 2-source fold on
    every rank; a lonely shape's buddy fold, one 2-source fold of the head
    on each buddy, and each of a prefix stage's w - 1 group-ring hops, one
    2-source fold on every tree rank; the tail, one fold of every rank's
    tail on every rank.  The bf16 codec folds as the lossless
    :func:`.allreduce.allreduce` (``allreduce.call_shape``)."""
    topo = Topology.resolve(n, topo)
    lonely = isinstance(topo, LonelyTopology)
    head = _split(count, _owners(topo))
    folds: list = []
    if head and lonely:
        folds.append((topo.lonely, 2, head))
        length = head
        for w in topo.tree.widths:
            length //= w
            folds += [(topo.tree.num_nodes, 2, length)] * (w - 1)
    elif head and topo.is_ring:
        folds += [(n, 2, head // n)] * (n - 1)
    elif head:
        for size in chunk_sizes(head, n, chunks):
            for w in topo.widths:
                size //= w
                folds.append((n, w, size))
    if head < count:
        folds.append((n, n, count - head))
    return folds


def compressed_allreduce(x, comm=None, topo=None, codec="f32",
                         chunks: int = 1, step=0,
                         return_residual: bool = False):
    """Sum-allreduce of ``x`` over ``comm`` with ``codec`` on the wire.

    :func:`~.allreduce.allreduce` (``op="sum"``) with a codec; ``step``
    keys the stochastic rounding.  ``return_residual=True`` returns
    ``(result, residual)``, ``residual = x - C(x)`` the local input
    quantization loss for error feedback (0 for a lossless codec and on
    the exact < N-element tail)."""
    codec = get_codec(codec)
    call = _Call(x, comm)
    if not codec.lossy or call.n <= 1:
        out = allreduce(x, comm, topo=topo, op="sum", chunks=chunks)
        return (out, _zeros(call)) if return_residual else out
    if codec.name == "bf16":
        wire = {r: t.to(torch.bfloat16) for r, t in call.flat.items()}
        got = allreduce(call.give(wire), comm, topo=topo, op="sum",
                        chunks=chunks)
        got = dict(enumerate(got)) if call.mesh else {call.tr.rank: got}
        out = call.give({r: t.to(call.dtype) for r, t in got.items()},
                        call.shape)
        if not return_residual:
            return out
        return out, call.give({r: t - wire[r].to(call.dtype)
                               for r, t in call.flat.items()}, call.shape)

    tr, n = call.tr, call.n
    topo = Topology.resolve(n, topo)
    enc = _Encoder(codec, step)
    v = {r: t.to(torch.float32) for r, t in call.flat.items()}
    count = next(iter(v.values())).numel()
    head = _split(count, _owners(topo))
    dest = {r: torch.empty(count, dtype=torch.float32, device=t.device)
            for r, t in v.items()}
    res = {r: torch.zeros_like(d) for r, d in dest.items()} \
        if return_residual else None
    if head:
        heads = {r: t[:head] for r, t in v.items()}
        if isinstance(topo, LonelyTopology) or topo.is_ring:
            if isinstance(topo, LonelyTopology):
                got = _lonely_ag_int8(
                    _lonely_tree_rs_int8(heads, tr, topo, enc), tr, topo, enc,
                    head // topo.tree.num_nodes,
                    {r: h.device for r, h in heads.items()})
            else:
                got = _ring_ag_int8(_ring_rs_int8(heads, tr, enc), tr, enc)
            for r, t in got.items():
                dest[r][:head].copy_(t)
            if res is not None:
                _canonical(heads, enc, {r: t[:head] for r, t in res.items()})
        else:
            _tree_int8(heads, tr, topo, enc, chunks,
                       {r: d[:head] for r, d in dest.items()},
                       None if res is None else
                       {r: t[:head] for r, t in res.items()})
    if head < count:
        _dense_tail({r: t[head:] for r, t in v.items()}, tr, _SUM,
                    {r: d[head:] for r, d in dest.items()})
    out = call.give({r: d.to(call.dtype) for r, d in dest.items()},
                    call.shape)
    if res is None:
        return out
    return out, call.give({r: t.to(call.dtype) for r, t in res.items()},
                          call.shape)


def local_residual(x: torch.Tensor, codec, step=0) -> torch.Tensor:
    """The canonical residual ``x - C(x)`` of one tensor (``codec.roundtrip``
    of the flat buffer, salt 0: a block-aligned tree's stage-0 encode), for
    error feedback where the wire's is not available; zeros for a lossless
    codec."""
    codec = get_codec(codec)
    if not codec.lossy:
        return torch.zeros_like(x)
    return x - codec.roundtrip(x, step)


def compressed_reduce_scatter(x, comm=None, topo=None, codec="int8", step=0,
                              return_residual: bool = False):
    """Phase 1 alone with ``codec`` on the wire: this rank's reduced shard
    in :func:`~.allreduce.reduce_scatter`'s layout (the owned head block,
    then the exact replicated tail).  A lonely rank holds
    ``decode(encode(buddy's tile))``.  ``return_residual`` as
    :func:`compressed_allreduce`'s.  For a block-aligned buffer,
    :func:`compressed_all_gather` of the shard is bitwise
    :func:`compressed_allreduce`."""
    codec = get_codec(codec)
    call = _Call(x, comm)
    if not codec.lossy or call.n <= 1:
        out = reduce_scatter(x, comm, topo=topo, op="sum")
        return (out, _zeros(call)) if return_residual else out
    tr, n = call.tr, call.n
    topo = Topology.resolve(n, topo)
    enc = _Encoder(codec, step)
    v = {r: t.to(torch.float32) for r, t in call.flat.items()}
    count = next(iter(v.values())).numel()
    owners = _owners(topo)
    head = _split(count, owners)
    tile = head // owners
    shards = {r: torch.empty(tile + count - head, dtype=torch.float32,
                             device=t.device) for r, t in v.items()}
    res = {r: torch.zeros_like(t) for r, t in v.items()}
    if head:
        heads = {r: t[:head] for r, t in v.items()}
        resh = {r: t[:head] for r, t in res.items()}
        if codec.name == "bf16":
            wire = {r: h.to(torch.bfloat16) for r, h in heads.items()}
            got = _scatter(wire, tr, topo, _SUM)
            if isinstance(topo, LonelyTopology):  # mirror the buddy's shard
                mirror = {r: torch.empty(tile, dtype=torch.bfloat16,
                                         device=h.device)
                          for r, h in heads.items() if r >= owners}
                _hand_back(got, tr, topo, mirror)
                got.update(mirror)
            for r, h in heads.items():
                torch.sub(h, wire[r].to(torch.float32), out=resh[r])
        elif isinstance(topo, LonelyTopology):
            got = _lonely_rs_int8(heads, tr, topo, enc)
            _canonical(heads, enc, resh)
        elif topo.is_ring:
            got = _ring_rs_int8(heads, tr, enc)
            _canonical(heads, enc, resh)
        else:
            got, wire0 = _tree_rs_int8(heads, tr, topo, enc)
            tile0 = head // topo.widths[0]
            for r, h in heads.items():
                torch.sub(h, enc.decode(wire0[r], tile0).reshape(-1),
                          out=resh[r])
        for r, g in got.items():
            shards[r][:tile].copy_(g)
    if head < count:
        _dense_tail({r: t[head:] for r, t in v.items()}, tr, _SUM,
                    {r: s[tile:] for r, s in shards.items()})
    out = call.give({r: s.to(call.dtype) for r, s in shards.items()})
    if not return_residual:
        return out
    return out, call.give({r: t.to(call.dtype) for r, t in res.items()},
                          call.shape)


def compressed_all_gather(x, comm=None, topo=None, out_shape=None,
                          codec="int8", step=0):
    """Phase 2 alone with ``codec`` on the wire, the inverse of
    :func:`compressed_reduce_scatter`: the owned head block is encoded once
    and forwarded encoded; every rank, the owner too, decodes the same
    bytes.  The shard's tail is appended exactly.  ``out_shape`` as
    :func:`~.allreduce.all_gather`'s."""
    codec = get_codec(codec)
    call = _Call(x, comm)
    if not codec.lossy or call.n <= 1:
        return all_gather(x, comm, topo=topo, out_shape=out_shape)
    tr, n = call.tr, call.n
    topo = Topology.resolve(n, topo)
    owners = _owners(topo)
    enc = _Encoder(codec, step)
    v = {r: t.to(torch.float32) for r, t in call.flat.items()}
    shard_len = next(iter(v.values())).numel()
    count = None if out_shape is None else int(torch.Size(out_shape).numel())
    if count is None:
        tile = shard_len
    else:
        tile = count // owners
        if tile + count % owners != shard_len:
            raise ValueError(
                f"shard of {shard_len} elements does not match out_shape "
                f"{tuple(out_shape)} over {owners} owners (expected "
                f"{tile + count % owners})")
    head = owners * tile
    res = {r: torch.empty(head + shard_len - tile, dtype=torch.float32,
                          device=t.device) for r, t in v.items()}
    if tile:
        tiles = {r: t[:tile] for r, t in v.items()}
        if codec.name == "bf16":
            dest = {r: torch.empty(head, dtype=torch.bfloat16,
                                   device=t.device) for r, t in v.items()}
            _gather({r: t.to(torch.bfloat16) for r, t in tiles.items()}, tr,
                    topo, dest)
            got = dest
        elif isinstance(topo, LonelyTopology):
            got = _lonely_ag_int8(tiles, tr, topo, enc, tile,
                                  {r: t.device for r, t in v.items()})
        elif topo.is_ring:
            got = _ring_ag_int8(tiles, tr, enc)
        else:
            got = _ag_int8(tiles, tr, topo, enc, _SALT_AG)
        for r, g in got.items():
            res[r][:head].copy_(g)
    for r, t in v.items():
        res[r][head:].copy_(t[tile:])
    out = {r: t[:count] if count is not None else t for r, t in res.items()}
    return call.give({r: t.to(call.dtype) for r, t in out.items()},
                     None if out_shape is None else tuple(out_shape))
