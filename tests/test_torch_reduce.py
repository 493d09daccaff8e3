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
- loud errors for what the JAX function rejects.
"""

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
from flextree_tpu_torch.ops.reduce_stacked import (
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
