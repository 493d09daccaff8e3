"""The port's op registry and fold (``flextree_tpu_torch.ops.reduce``,
``ops.reduce_stacked``) against the JAX package's, on the same numpy inputs.

On the CPU the fold's wrapper computes its plain version (the CUDA kernel
runs only on the card, where ``chip_smoke.py`` holds it against the same
plain version bitwise).  Held here, bitwise:

- the registry: op names, dtype sets and identities;
- the fold against the JAX ``reduce_stacked`` run interpreted (as
  ``tests/test_bench_utils.py`` runs it) for every op x dtype at W=5,
  L=1000, and for f32 sum, bf16 sum and int32 band over W, L and
  ``sources_tile``;
- the fold against the plain-jnp oracle ``reduce_stacked_reference`` for
  every op x dtype over W and L at ``sources_tile=1``;
- loud errors for what the JAX function rejects;
- the batch of W-pointer folds (``reduce_sources``, its plain version
  ``reduce_sources_plain``) on separately made sources against the JAX
  ``reduce_stacked`` (interpreted) and the oracles on the same sources
  stacked, for every op x dtype, W in {1, 2, 3, 8} and ``sources_tile``
  in {1, 2, 4}; a batch against its folds one by one and in place; the
  refused aliasing; no launch counted on the CPU.
"""

import math
import re
from pathlib import Path


import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from flextree_tpu.ops import reduce as jreduce
from flextree_tpu.ops.pallas_reduce import reduce_stacked as j_reduce_stacked
from flextree_tpu.ops.pallas_reduce import (
    reduce_stacked_reference as j_reference,
)
from flextree_tpu_torch.ops import reduce as treduce
from flextree_tpu_torch.ops import reduce_stacked as rs
from flextree_tpu_torch.ops.reduce_stacked import (
    reduce_sources,
    reduce_sources_plain,
    reduce_stacked,
    reduce_stacked_plain,
    reduce_stacked_reference,
)

COMBOS = [(op, dt) for op, rop in jreduce.SUPPORTED_OPS.items()
          for dt in rop.dtypes]
#: (op, dtype) pairs the JAX kernel cannot run: it pads with the op's
#: identity, and jnp.pad overflows on uint64's max (min's identity)
JAX_KERNEL_FAULTS = {("min", "uint64")}


def np_dtype(name):
    return np.dtype(ml_dtypes.bfloat16) if name == "bfloat16" else np.dtype(name)


def make_input(name, shape, seed):
    """Seeded numpy input of dtype ``name``: normals for floats, the full
    range for integers, random bits for bool."""
    rng = np.random.default_rng(seed)
    dt = np_dtype(name)
    if name in ("float16", "bfloat16", "float32", "float64"):
        return rng.standard_normal(shape).astype(np.float32).astype(dt)
    if name == "bool":
        return rng.integers(0, 2, shape).astype(np.bool_)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, shape, dtype=dt, endpoint=True)


def to_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def to_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def same_bits(a, b):
    a, b = np.atleast_1d(np.asarray(a)), np.atleast_1d(np.asarray(b))
    return a.dtype == b.dtype and a.shape == b.shape and \
        np.array_equal(a.view(np.uint8), b.view(np.uint8))


def test_registry_equals_the_jax_one():
    assert list(treduce.SUPPORTED_OPS) == list(jreduce.SUPPORTED_OPS)
    for name, jop in jreduce.SUPPORTED_OPS.items():
        top = treduce.get_op(name)
        assert top.dtypes == jop.dtypes
        assert top.np_fn is jop.np_fn
        for dt in jop.dtypes:
            want, got = jop.identity_for(np_dtype(dt)), top.identity_for(
                np_dtype(dt))
            assert type(got) is type(want) and same_bits(got, want), (name, dt)
            # a torch dtype gets the same value as a Python scalar
            tdt = getattr(torch, dt)
            assert float(top.identity_for(tdt)) == float(want) or (
                int(top.identity_for(tdt)) == int(want))


def test_get_op_and_check_dtype_raise_as_the_jax_ones():
    for mod in (jreduce, treduce):
        with pytest.raises(ValueError):
            mod.get_op("mean")
        with pytest.raises(TypeError):
            mod.get_op("band").check_dtype(np.float32)
    with pytest.raises(TypeError):
        treduce.get_op("sum").check_dtype(torch.bool)
    treduce.get_op("bxor").check_dtype(torch.bool)


@pytest.mark.parametrize("op,dtype", COMBOS, ids=lambda v: str(v))
def test_fold_bitwise_vs_jax_interpret(op, dtype):
    x = make_input(dtype, (5, 1000), seed=len(op) * 100 + len(dtype))
    if (op, dtype) in JAX_KERNEL_FAULTS:
        with pytest.raises(OverflowError):
            j_reduce_stacked(jnp.asarray(x), op=op, interpret=True)
        want = np.array(j_reference(jnp.asarray(x), op=op))
    else:
        want = np.array(j_reduce_stacked(jnp.asarray(x), op=op,
                                         sources_tile=1, interpret=True))
    got = reduce_stacked(to_torch(x), op)
    assert same_bits(to_numpy(got), want)
    assert same_bits(to_numpy(reduce_stacked_plain(to_torch(x), op)), want)


@pytest.mark.parametrize("op,dtype", COMBOS, ids=lambda v: str(v))
def test_fold_bitwise_vs_jax_reference_over_w_and_l(op, dtype):
    lengths = (1, 127, 1000)
    for w in (1, 2, 3, 5, 8):
        # the oracle folds elementwise, so one call covers the three
        # lengths laid end to end; the port folds each length on its own
        x = make_input(dtype, (w, sum(lengths)), seed=w * 1000 + len(op))
        want = np.array(j_reference(jnp.asarray(x), op=op))
        start = 0
        for length in lengths:
            tx = to_torch(x[:, start:start + length])
            part = want[start:start + length]
            assert same_bits(to_numpy(reduce_stacked(tx, op)), part), (w, length)
            assert same_bits(to_numpy(reduce_stacked_reference(tx, op)), part)
            start += length


# (W, sources_tile) over W in {1, 2, 3, 5, 8} and st in {1, 2, 4}, one
# case per clamped st (the JAX kernel clamps to gcd(st, W)), plus W=6 at
# st=4, which clamps to pairs
GRID = [(op, dt, w, length, st)
        for op, dt in (("sum", "float32"), ("sum", "bfloat16"),
                       ("band", "int32"))
        for w, st in ((1, 1), (2, 1), (2, 2), (3, 1), (3, 2), (5, 1), (6, 4),
                      (8, 1), (8, 2), (8, 4))
        for length in (1, 127, 1000)]


@pytest.mark.parametrize("op,dtype,w,length,st", GRID)
def test_sources_tile_bitwise_vs_jax_interpret(op, dtype, w, length, st):
    x = make_input(dtype, (w, length), seed=w * 7 + length + st)
    want = np.array(j_reduce_stacked(jnp.asarray(x), op=op, rows_tile=8,
                                     sources_tile=st, interpret=True))
    got = reduce_stacked(to_torch(x), op, sources_tile=st)
    assert same_bits(to_numpy(got), want)


def test_single_source_passthrough_and_out():
    x = to_torch(make_input("float32", (1, 100), 0))
    assert reduce_stacked(x).data_ptr() == x[0].data_ptr()
    y = to_torch(make_input("int16", (3, 50), 1))
    out = torch.empty(50, dtype=torch.int16)
    assert reduce_stacked(y, "bor", out=out) is out
    assert torch.equal(out, reduce_stacked_plain(y, "bor"))


@pytest.mark.parametrize("bad,exc", [
    (lambda: reduce_stacked(torch.ones(2, 3, 4)), ValueError),
    (lambda: reduce_stacked(torch.ones(2, 8), op="band"), TypeError),
    (lambda: reduce_stacked(torch.ones(2, 8), op="mean"), ValueError),
    (lambda: reduce_stacked(torch.ones(2, 8), out=torch.empty(7)), ValueError),
    (lambda: reduce_stacked(torch.ones(2, 8, device="meta")), ValueError),
])
def test_bad_input_raises(bad, exc):
    with pytest.raises(exc):
        bad()


def test_jax_rejects_what_the_port_rejects():
    with pytest.raises(ValueError):
        j_reduce_stacked(jnp.ones((2, 3, 4)))
    with pytest.raises(TypeError):
        j_reduce_stacked(jnp.ones((2, 8), jnp.float32), op="band")


def test_max_min_propagate_nan_and_unsigned_order():
    nan = float("nan")
    x = torch.tensor([[1.0, nan, 3.0], [nan, 2.0, -1.0]])
    for op in ("max", "min"):
        got = reduce_stacked(x, op)
        want = np.array(j_reference(jnp.asarray(x.numpy()), op=op))
        assert same_bits(got.numpy(), want)
    u = torch.tensor([[2 ** 31, 1], [5, 2 ** 32 - 1]],
                     dtype=torch.int64).to(torch.int32).view(torch.uint32)
    assert reduce_stacked(u, "max").view(torch.int32).tolist() == \
        torch.tensor([2 ** 31, 2 ** 32 - 1]).to(torch.int32).tolist()
    assert reduce_stacked(u, "min").view(torch.int32).tolist() == [5, 1]


# ------------------------------------------ the batch of W-pointer folds


def seeded_sources(dtype, w, length, seed):
    """W sources made one by one (not rows of one stack)."""
    return [make_input(dtype, (length,), seed * 100 + j) for j in range(w)]


#: (W, sources_tile after the clamp) run through the interpreted JAX
#: kernel: every grouping it has at W in {1, 2, 3, 8}, and a plain left
#: fold; the other left folds are held to the JAX oracle, which
#: ``test_fold_bitwise_vs_jax_interpret`` holds to the kernel
JAX_INTERPRET_RUNS = {(1, 1), (2, 2), (8, 1), (8, 2), (8, 4)}


@pytest.mark.parametrize("op,dtype", COMBOS, ids=lambda v: str(v))
def test_sources_bitwise_vs_jax_on_the_same_sources_stacked(op, dtype):
    for w in (1, 2, 3, 8):
        srcs = seeded_sources(dtype, w, 257, seed=w + len(op) + len(dtype))
        stacked = jnp.asarray(np.stack(srcs))
        tsrcs = [to_torch(a) for a in srcs]
        oracle = np.array(j_reference(stacked, op=op))
        assert same_bits(to_numpy(reduce_stacked_reference(
            torch.stack(tsrcs), op)), oracle), w
        for st in (1, 2, 4):
            clamped = math.gcd(st, w)
            plain = reduce_sources_plain([(tsrcs, None)], op, st)[0]
            out = torch.empty_like(tsrcs[0])
            got = reduce_sources([(tsrcs, out)], op, st)[0]
            assert got is out
            assert same_bits(to_numpy(out), to_numpy(plain)), (w, st)
            if clamped == 1:  # the plain left fold
                assert same_bits(to_numpy(plain), oracle), w
            if (w, clamped) in JAX_INTERPRET_RUNS and st == clamped and \
                    (op, dtype) not in JAX_KERNEL_FAULTS:
                assert same_bits(to_numpy(plain), np.array(j_reduce_stacked(
                    stacked, op=op, sources_tile=clamped,
                    interpret=True))), (w, st)
            elif clamped > 1:  # order-free ops, or min over uint64
                assert (op not in ("sum", "prod")) <= same_bits(
                    to_numpy(plain), oracle), (w, st)


@pytest.mark.parametrize("op,dtype", [("sum", "float32"), ("sum", "bfloat16"),
                                      ("prod", "float16"), ("max", "int8"),
                                      ("bxor", "uint64"), ("band", "bool")])
@pytest.mark.parametrize("st", [1, 2])
def test_a_batch_equals_its_folds_one_by_one_and_in_place(op, dtype, st):
    folds = [[to_torch(a) for a in seeded_sources(dtype, 4, 100, seed=f)]
             for f in range(5)]
    outs = reduce_sources([(srcs, torch.empty_like(srcs[0]))
                           for srcs in folds], op, st)
    for srcs, got in zip(folds, outs):
        one = reduce_sources([(srcs, torch.empty_like(srcs[0]))], op, st)[0]
        assert torch.equal(got.view(torch.uint8), one.view(torch.uint8))
        assert torch.equal(got.view(torch.uint8), reduce_stacked(
            torch.stack(srcs), op, st).view(torch.uint8))
    copies = [[t.clone() for t in srcs] for srcs in folds]
    res = reduce_sources([(srcs, srcs[0]) for srcs in copies], op, st)
    for srcs, got, want in zip(copies, res, outs):
        assert got is srcs[0]
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


def _refused():
    a = torch.zeros(4, 16)
    flat = a.view(-1)
    return {
        "partly over its source 0": [([a[0], a[1]], flat[8:24])],
        "partly over its source 1": [([a[0], a[1]], flat[24:40])],
        "equal to its source 1": [([a[0], a[1]], a[1])],
        "over another fold's source": [([a[0], a[1]], a[2]),
                                       ([a[2], a[3]], a[3])],
        "another fold's source 0": [([a[2], a[1]], torch.empty(16)),
                                    ([a[0], a[3]], a[2])],
        "two outputs overlapping": [([a[0], a[1]], a[2]),
                                    ([a[0], a[1]], flat[40:56])],
        "a source on another device": [([a[0], a[1].to("meta")], a[2])],
        "a batch of two widths": [([a[0], a[1]], a[2]), ([a[1]], a[3])],
        "a short source": [([a[0], a[1, :8]], a[2])],
        "a source of another dtype": [([a[0], a[1].double()], a[2])],
        "a strided source": [([a[0, :4], a[:, 1]], torch.empty(4))],
        "no sources": [([], a[2])],
        "no folds": [],
    }


@pytest.mark.parametrize("case", list(_refused()))
def test_reduce_sources_refuses(case):
    with pytest.raises(ValueError):
        reduce_sources(_refused()[case], "sum")


def test_reduce_sources_refuses_an_unknown_op_or_dtype():
    x = [torch.ones(8), torch.ones(8)]
    with pytest.raises(TypeError):
        reduce_sources([(x, torch.empty(8))], "band")
    with pytest.raises(ValueError):
        reduce_sources([(x, torch.empty(8))], "mean")


def test_a_cpu_call_counts_no_launch():
    before = (reduce_sources.launches, reduce_stacked.launches)
    x = torch.ones(3, 40)
    reduce_sources([(list(x), torch.empty(40))], "sum")
    reduce_sources([(list(x), x[0])], "max", 2)
    reduce_stacked(x, "sum")
    assert (reduce_sources.launches, reduce_stacked.launches) == before


def test_kernel_constants_match_the_source():
    src = (Path(rs.__file__).resolve().parent.parent / "csrc" /
           "reduce_stacked.cu").read_text()
    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert const("kMaxPointers") == rs.MAX_POINTERS
    assert const("kMaxSourcesTile") == rs.MAX_SOURCES_TILE
