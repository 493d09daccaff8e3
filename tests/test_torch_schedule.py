"""The port's copy of the schedule layer (``flextree_tpu_torch.schedule``)
equals the JAX package's: for every N <= 16 over every ordered
factorization ``get_stages`` accepts, the ring and the lonely specs, the
topologies, groups, gaps, per-rank plans, the shard contract
(``owned_block``, ``shard_layout``), block layouts and validation stats
are the same, and the same bad specs raise."""

import importlib
import itertools
import math

import pytest

from flextree_tpu.schedule import blocks as jblocks
from flextree_tpu.schedule import plan as jplan
from flextree_tpu.schedule import stages as jstages
from flextree_tpu_torch.schedule import blocks as tblocks
from flextree_tpu_torch.schedule import plan as tplan
from flextree_tpu_torch.schedule import stages as tstages

# the packages re-export the function ``validate``, which hides the module
jvalidate = importlib.import_module("flextree_tpu.schedule.validate")
tvalidate = importlib.import_module("flextree_tpu_torch.schedule.validate")

LONELY_SPECS = (("3,2+1", 7), ("4,2+1", 9), ("2+1", 3))


def factorizations(n):
    """Every ordered tuple of widths >= 2 whose product is n."""
    out = [(n,)] if n > 1 else []
    for w in range(2, n):
        if n % w == 0:
            out += [(w,) + rest for rest in factorizations(n // w)]
    return out


def specs(n):
    return [",".join(map(str, f)) for f in factorizations(n)] + ["1"]


def topo_facts(t):
    if isinstance(t, (jstages.LonelyTopology, tstages.LonelyTopology)):
        return ("lonely", t.num_nodes, t.lonely, t.widths, t.num_stages,
                t.message_steps, str(t), topo_facts(t.tree))
    return (t.num_nodes, t.widths, t.gaps, t.is_ring, t.num_stages,
            t.message_steps, str(t),
            [t.groups(i) for i in range(t.num_stages)] if not t.is_ring
            else None,
            [[t.group_members(i, r) for r in range(t.num_nodes)]
             for i in range(t.num_stages)] if not t.is_ring else None)


def ops(plan):
    return [[(o.peer, o.blocks) for o in stage] for stage in plan]


def stats(s):
    return (s.num_nodes, s.widths, s.stages, s.p2p_messages)


@pytest.mark.parametrize("n", range(1, 17))
def test_topologies_plans_and_contract_equal(n):
    for spec in specs(n) or ["1"]:
        jt, tt = jstages.Topology.resolve(n, spec), tstages.Topology.resolve(n, spec)
        assert topo_facts(tt) == topo_facts(jt), spec
        assert tstages.get_stages(n, spec) == jstages.get_stages(n, spec)
        assert tblocks.shard_layout(tt) == jblocks.shard_layout(jt), spec
        assert stats(tvalidate.validate(tt)) == stats(jvalidate.validate(jt))
        for r in range(n):
            assert tblocks.owned_block(tt, r) == jblocks.owned_block(jt, r)
            if jt.is_ring:
                assert [(a.peer, a.blocks, b.peer, b.blocks)
                        for a, b in tplan.ring_plan(n, r)] == \
                    [(a.peer, a.blocks, b.peer, b.blocks)
                     for a, b in jplan.ring_plan(n, r)]
                continue
            assert ops(tplan.send_plan(tt, r)) == ops(jplan.send_plan(jt, r))
            assert ops(tplan.recv_plan(tt, r)) == ops(jplan.recv_plan(jt, r))
            for k in range(jt.num_stages + 1):
                assert tplan.owned_blocks(tt, r, k) == \
                    jplan.owned_blocks(jt, r, k)
        if not jt.is_ring:
            assert tplan.format_plan(tt, 0) == jplan.format_plan(jt, 0)
            assert list(tvalidate.stage_matches(tt)) == \
                list(jvalidate.stage_matches(jt))
    for count in (0, 1, n - 1, n, 35, 64, 100):
        jl, tl = jblocks.BlockLayout(n, count), tblocks.BlockLayout(n, count)
        assert (tl.split_size, tl.count_aligned, tl.pad, tl.slices()) == \
            (jl.split_size, jl.count_aligned, jl.pad, jl.slices())


@pytest.mark.parametrize("spec,n", LONELY_SPECS)
def test_lonely_specs_equal(spec, n):
    jt, tt = jstages.Topology.resolve(n, spec), tstages.Topology.resolve(n, spec)
    assert isinstance(tt, tstages.LonelyTopology)
    assert topo_facts(tt) == topo_facts(jt)
    assert tblocks.shard_layout(tt) == jblocks.shard_layout(jt)
    assert stats(tvalidate.validate(tt)) == stats(jvalidate.validate(jt))
    assert tstages.split_lonely_spec(spec) == jstages.split_lonely_spec(spec)


def test_tile_ownership_is_the_residue_chain_relabelled():
    """The collectives keep contiguous tiles (tile p_i of the slice at
    stage i); the plans keep residue chains.  Under the digit reversal of
    the mixed radix they are the same sets at every stage, which is why
    ``owned_block`` and ``owned_blocks`` name different blocks for one
    rank and the schedule is the same."""
    for n in (4, 6, 8, 12, 16):
        for widths in factorizations(n):
            t = tstages.Topology(n, widths)

            def digits(b):  # little-endian digits of b in the widths' radix
                out = []
                for w in widths:
                    out.append(b % w)
                    b //= w
                return out

            def tile_index(b):  # the same digits, big-endian
                ds, idx = digits(b), 0
                for i, w in enumerate(widths):
                    idx += ds[i] * math.prod(widths[i + 1:])
                return idx

            for r in range(n):
                for k in range(len(widths) + 1):
                    chain = tplan.owned_blocks(t, r, k)
                    tiles = sorted(tile_index(b) for b in chain)
                    size = n // math.prod(widths[:k])
                    start = tiles[0]
                    assert tiles == list(range(start, start + size))
                assert tblocks.owned_block(t, r) == tile_index(r)


@pytest.mark.parametrize("n,spec", [
    (8, "3,3"), (8, "0,8"), (8, "4,x"), (6, "2,3+4"), (4, "2,2+a"),
    (0, ""), (7, "3,2+-1"),
])
def test_bad_specs_raise_alike(n, spec):
    with pytest.raises(jstages.TopologyError):
        jstages.Topology.resolve(n, spec)
    with pytest.raises(tstages.TopologyError):
        tstages.Topology.resolve(n, spec)


def test_parse_and_split_equal():
    for spec in ("", " 4, 2 ", "2,2,2", "3,2+1", "7+1", "1"):
        assert tstages.parse_topo(spec.split("+")[0]) == \
            jstages.parse_topo(spec.split("+")[0])
        assert tstages.split_lonely_spec(spec) == jstages.split_lonely_spec(spec)
    for a, b in itertools.product((1, 2, 4), repeat=2):
        assert tplan.stage_send_blocks(16, a, b, 3) == \
            jplan.stage_send_blocks(16, a, b, 3)
