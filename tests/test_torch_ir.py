"""The port's schedule IR (``flextree_tpu_torch.schedule.ir``), its model
checker (``analysis.schedule_check``) and its pair-stage executor
(``parallel.ir_lower``) against the JAX package's, on the same programs
and the same seeded numpy inputs.  Held:

- emission: every program of ``default_ir_matrix(16)``, ``swing_ir(n)``
  for n = 2..16 and the six generalized specs of the JAX golden suite
  equal JAX's field by field (stages, transfers, ``scheduled``);
- the model check: no violation on those programs in either package, and
  on the four seeded corruptions of the JAX suite the same number and
  kinds of violations; ``compile_ir`` refuses the same four, and a
  refused program never reaches a transport;
- execution on a CPU mesh against the JAX collective under ``shard_map``
  on the conftest's 8 CPU devices: the head (the first ``count // m · m``
  elements) bitwise, the tail within the fold-order bound ``N·u·Σ|x|``;
  integer-valued f32 and bf16 exact; ``op="max"`` on a pair family raises;
- the launch accounting: each ``sum`` row of a pair family is one
  ``reduce_sources`` call, as ``call_shape`` derives it, and the gather's
  messages are ``call_shape``'s.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from flextree_tpu.analysis.schedule_check import check_ir as j_check_ir
from flextree_tpu.analysis.schedule_check import default_ir_matrix as j_matrix
from flextree_tpu.parallel import allreduce_over_mesh as j_over_mesh
from flextree_tpu.parallel import flat_mesh as j_flat_mesh
from flextree_tpu.schedule import ir as jir
from flextree_tpu.schedule.stages import Topology as JTopology
from flextree_tpu_torch.analysis.schedule_check import (
    check_ir,
    check_ir_families,
    default_ir_matrix,
)
from flextree_tpu_torch.parallel import allreduce as tar
from flextree_tpu_torch.parallel.mesh import allreduce_over_mesh, flat_mesh
from flextree_tpu_torch.schedule import ir as sir
from flextree_tpu_torch.schedule.stages import Topology, TopologyError
from test_torch_allreduce import make_rows, same_bits, within_fold_bound

# the generalized specs of the JAX golden suite (test_schedule_ir.py)
GEN_SPECS = (("gen:4,2@1", 8), ("gen:4,2@2", 8), ("gen:8@7", 8),
             ("gen:2,2,2@1", 8), ("gen:2,2@1", 4), ("gen:3,2@2", 6))
PROGRAMS = ([(spec, n, count) for spec, n, count in default_ir_matrix(16)]
            + [("swing", n, n * 16) for n in range(2, 17)]
            + [(spec, n, n * n) for spec, n in GEN_SPECS])
EXEC_SHAPES = (("swing", 4), ("swing", 6), ("swing", 8), ("gen:4,2@2", 8),
               ("gen:8@7", 8), ("gen:3,2@2", 6))


def plain(prog):
    """An IR program as nested tuples of plain values (either package's)."""
    return (prog.family, prog.num_nodes, prog.scheduled, prog.num_stages,
            prog.count, prog.head_elems, tuple(prog.chunk_spans), prog.chunks,
            tuple(prog.widths), prog.ports,
            tuple((st.index, st.phase, st.combine, st.lowering, st.groups,
                   tuple((x.src, x.dst, x.blocks) for x in st.xfers),
                   st.chunk) for st in prog.stages))


def kinds(violations):
    return collections.Counter(v.kind for v in violations)


def test_the_port_lists_the_jax_ir_matrix():
    assert default_ir_matrix(16) == j_matrix(16)
    assert check_ir_families() == ([], len(default_ir_matrix(16)))


@pytest.mark.parametrize("spec,n,count", PROGRAMS,
                         ids=[f"{s}@{n}" for s, n, _ in PROGRAMS])
def test_emission_and_model_check_equal_jax(spec, n, count):
    ours = sir.emit_ir(spec, num_nodes=n, count=count)
    theirs = jir.emit_ir(spec, num_nodes=n, count=count)
    assert plain(ours) == plain(theirs)
    assert ours.spec() == theirs.spec() and str(ours) == str(theirs)
    assert check_ir(ours) == [] and j_check_ir(theirs) == []


@pytest.mark.parametrize("spec,n,count", PROGRAMS,
                         ids=[f"{s}@{n}" for s, n, _ in PROGRAMS])
def test_a_row_never_receives_a_block_it_sends(spec, n, count):
    """What lets one launch fold a row reading every sender's block in
    place: no rank writes a block it sends in the same row."""
    for st in sir.emit_ir(spec, num_nodes=n, count=count).stages:
        sent, got = collections.defaultdict(set), collections.defaultdict(set)
        for x in st.xfers:
            sent[x.src].update(x.blocks)
            got[x.dst].update(x.blocks)
        assert all(not sent[r] & got[r] for r in got), (st.phase, st.index)


def _corrupt_peer(mod, prog):
    st = prog.stages[1]
    bad = tuple(dataclasses.replace(x, dst=(x.dst + 2) % prog.num_nodes)
                for x in st.xfers)
    return dataclasses.replace(prog, stages=prog.stages[:1] + (
        dataclasses.replace(st, xfers=bad),) + prog.stages[2:])


def _truncate(mod, prog):
    st = prog.stages[0]
    bad = tuple(dataclasses.replace(x, blocks=x.blocks[:-1]) for x in st.xfers)
    return dataclasses.replace(
        prog, stages=(dataclasses.replace(st, xfers=bad),) + prog.stages[1:])


def _serialize(mod, prog):
    return dataclasses.replace(prog, stages=tuple(sorted(
        prog.stages, key=lambda s: (s.chunk, s.phase == "ag"))))


def _mislabel(mod, prog):
    topo = type(prog.topo)(8, (2, 2, 2))
    return dataclasses.replace(prog, stages=mod.tree_ir(topo, count=64).stages)


# the four seeded corruptions of the JAX suite's TestCompileRefusal
CORRUPTIONS = {
    "peer": (lambda mod: mod.swing_ir(8, count=64), _corrupt_peer),
    "truncated": (lambda mod: mod.generalized_ir((4, 2), 1, count=64),
                  _truncate),
    "divergent": (lambda mod: mod.tree_ir(
        (Topology if mod is sir else JTopology)(8, (4, 2)), count=128,
        chunks=2), _serialize),
    "mislabeled": (lambda mod: mod.tree_ir(
        (Topology if mod is sir else JTopology)(8, (4, 2)), count=64),
        _mislabel),
}


@pytest.mark.parametrize("name", sorted(CORRUPTIONS))
def test_seeded_corruptions_are_refused_as_jax_refuses_them(name):
    make, corrupt = CORRUPTIONS[name]
    ours, theirs = corrupt(sir, make(sir)), corrupt(jir, make(jir))
    assert plain(ours) == plain(theirs)
    assert kinds(check_ir(ours)) == kinds(j_check_ir(theirs))
    for mod, prog in ((sir, ours), (jir, theirs)):
        with pytest.raises(mod.IRViolationError):
            mod.compile_ir(prog)


def test_a_refused_program_never_reaches_a_transport(monkeypatch):
    calls = []
    monkeypatch.setattr(tar, "reduce_sources", lambda *a, **k: calls.append(a))
    monkeypatch.setattr(tar.MeshTransport, "run",
                        lambda self, msgs: calls.append(msgs))
    bad = _corrupt_peer(sir, sir.swing_ir(8, count=64))
    rows = list(torch.arange(8 * 64, dtype=torch.float32).view(8, 64))
    out = [torch.full((64,), float("nan")) for _ in range(8)]
    with pytest.raises(sir.IRViolationError) as err:
        tar.allreduce(rows, flat_mesh(8, "cpu"), bad, out=out)
    assert err.value.violations and not calls
    assert all(torch.isnan(o).all() for o in out)


def jax_result(data, spec):
    mesh = j_flat_mesh(data.shape[0], "ft")
    return np.array(jax.device_get(j_over_mesh(jnp.asarray(data), mesh,
                                               topo=spec, op="sum")))


@pytest.mark.parametrize("count", (64, 67))
@pytest.mark.parametrize("spec,n", EXEC_SHAPES)
def test_random_f32_head_is_bitwise_jax(spec, n, count):
    data = make_rows(n, count, "float32", seed=7 * count + n)
    got = allreduce_over_mesh(torch.from_numpy(data.copy()),
                              flat_mesh(n, "cpu"), spec, "sum").numpy()
    want = jax_result(data, spec)
    m = sir.emit_ir(spec, num_nodes=n).scheduled
    head = count // m * m
    assert same_bits(got[:, :head], want[:, :head])
    assert within_fold_bound(got, want, data, "sum")
    assert all(same_bits(got[r], got[0]) for r in range(n))


@pytest.mark.parametrize("count", (64, 67))
@pytest.mark.parametrize("spec,n", EXEC_SHAPES)
def test_integer_valued_sums_are_exact(spec, n, count):
    rng = np.random.default_rng(n * count)
    ints = rng.integers(-8, 8, size=(n, count))
    mesh = flat_mesh(n, "cpu")
    got = allreduce_over_mesh(torch.from_numpy(ints.astype(np.float32)),
                              mesh, spec, "sum")
    assert same_bits(got.numpy(), np.broadcast_to(
        ints.sum(0).astype(np.float32), (n, count)))
    small = rng.integers(-4, 4, size=(n, count))
    got = allreduce_over_mesh(torch.from_numpy(small).to(torch.bfloat16),
                              mesh, spec, "sum")
    want = small.sum(0).astype(np.float32).astype(ml_dtypes.bfloat16)
    assert same_bits(got.view(torch.uint16).numpy(),
                     np.broadcast_to(want, (n, count)).view(np.uint16))


@pytest.mark.parametrize("spec", ("swing", "gen:4,2@2"))
def test_pair_families_run_sum_only(spec):
    rows = list(torch.ones(8, 16))
    with pytest.raises(NotImplementedError, match="op='sum' only"):
        tar.allreduce(rows, flat_mesh(8, "cpu"), spec, "max")


@pytest.mark.parametrize("spec,n", EXEC_SHAPES)
def test_in_place_out_and_chunks_keep_the_bits(spec, n):
    data = make_rows(n, 67, "float32", seed=n)
    mesh = flat_mesh(n, "cpu")
    want = tar.allreduce(list(torch.from_numpy(data.copy())), mesh, spec)
    rows = list(torch.from_numpy(data.copy()))
    got = tar.allreduce(rows, mesh, spec, out=rows)
    assert all(g.data_ptr() == r.data_ptr() for g, r in zip(got, rows))
    chunked = tar.allreduce(list(torch.from_numpy(data.copy())), mesh, spec,
                            chunks=3)
    for r in range(n):
        assert same_bits(got[r].numpy(), want[r].numpy())
        assert same_bits(chunked[r].numpy(), want[r].numpy())


@pytest.mark.parametrize("spec,n", (("4,2", 8), ("1", 8), ("3,2+1", 7),
                                    ("2,2,2", 8)))
def test_legacy_shapes_through_the_ir_route_keep_their_bits(spec, n,
                                                            monkeypatch):
    data = make_rows(n, 67, "float32", seed=3 * n)
    mesh = flat_mesh(n, "cpu")
    routed = tar.allreduce(list(torch.from_numpy(data.copy())), mesh, spec,
                           chunks=2)
    prog = sir.emit_ir(spec, num_nodes=n, chunks=2)
    direct = tar.allreduce(list(torch.from_numpy(data.copy())), mesh, prog)
    compiled = sir.compile_ir(prog)(list(torch.from_numpy(data.copy())), mesh)
    monkeypatch.setenv(tar.IR_ROUTE_MAX_ENV, "0")
    walker = tar.allreduce(list(torch.from_numpy(data.copy())), mesh, spec,
                           chunks=2)
    for r in range(n):
        assert same_bits(routed[r].numpy(), walker[r].numpy())
        assert same_bits(direct[r].numpy(), walker[r].numpy())
        assert same_bits(compiled[r].numpy(), walker[r].numpy())


@pytest.mark.parametrize("count", (64, 1003))
@pytest.mark.parametrize("spec,n", EXEC_SHAPES + (("swing", 7),
                                                  ("gen:2,2,2@1", 8)))
def test_fold_calls_and_messages_are_call_shapes(spec, n, count, monkeypatch):
    folds, messages = [], []
    real_fold, real_run = tar.reduce_sources, tar.MeshTransport.run

    def fold(batch, op, *a):
        batch = list(batch)
        folds.append((len(batch), len(batch[0][0]), batch[0][1].numel()))
        return real_fold(batch, op, *a)

    def run(self, msgs):
        messages.extend(msgs)
        return real_run(self, msgs)

    monkeypatch.setattr(tar, "reduce_sources", fold)
    monkeypatch.setattr(tar.MeshTransport, "run", run)
    data = make_rows(n, count, "float32", seed=count)
    rows = list(torch.from_numpy(data))
    tar.allreduce(rows, flat_mesh(n, "cpu"), spec, out=rows)
    shape = tar.call_shape(n, spec, count)
    assert folds == shape.folds
    assert len(messages) == shape.messages
    if spec == "swing" and n == 8 and count == 64:
        assert [r for r, _, _ in shape.folds] == [32, 16, 8]
        assert shape.messages == 8 + 16 + 32
    if spec == "gen:8@7" and count == 64:
        assert [(r, w) for r, w, _ in shape.folds] == [(8, 8)]
        assert shape.messages == 56


def test_resolution_and_specs_equal_jax():
    for spec, n in (("swing", 6), ("gen:4,2@2", 8), ("GEN:2,2@1", 4)):
        ours = sir.resolve_collective(n, spec)
        theirs = jir.resolve_collective(n, spec)
        assert (ours.family, ours.num_nodes, ours.widths, ours.ports,
                ours.spec, ours.num_stages) == (
            theirs.family, theirs.num_nodes, theirs.widths, theirs.ports,
            theirs.spec, theirs.num_stages)
    assert sir.is_ir_family_spec("swing") and not sir.is_ir_family_spec("4,2")
    for bad in (lambda: sir.IRFamilySpec("generalized", 8, (4, 2), 4),
                lambda: sir.resolve_collective(8, "gen:3,2@1"),
                lambda: sir.swing_ir(1)):
        with pytest.raises(TopologyError):
            bad()
