"""The port's FlexTree collectives against the JAX package's own, on the
conftest's 8 CPU devices and the same seeded numpy inputs (the oracle
checks over every op and dtype are in ``test_torch_allreduce.py``).  JAX
compiles each (mesh, topology, op, dtype, shape), so the grid is small:
every shape of ``test_torch_allreduce.SHAPES``, counts {35, 64}, f32 sum,
int32 band and f32 max through ``allreduce_over_mesh``; int32
``reduce_scatter`` shards rank by rank; and float sum and prod on the flat
shape bitwise against ``reduce_stacked_reference``, the sequential fold.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from flextree_tpu.ops.pallas_reduce import reduce_stacked_reference
from flextree_tpu.parallel import allreduce_over_mesh as j_over_mesh
from flextree_tpu.parallel import flat_mesh as j_flat_mesh
from flextree_tpu_torch.parallel import allreduce as tar
from flextree_tpu_torch.parallel.mesh import flat_mesh
from test_torch_allreduce import (
    COUNTS,
    SHAPES,
    make_rows,
    port_allreduce,
    same_bits,
    to_numpy,
    to_torch,
    within_fold_bound,
)

# the package re-exports the function ``allreduce``, which hides the module
jallreduce = importlib.import_module("flextree_tpu.parallel.allreduce")
JAX_CASES = (("sum", np.float32), ("band", np.int32), ("max", np.float32))


def jax_over_mesh(data, spec, op):
    mesh = j_flat_mesh(data.shape[0], "ft")
    return np.array(jax.device_get(j_over_mesh(jnp.asarray(data), mesh,
                                               topo=spec, op=op)))


@pytest.mark.parametrize("count", (35, 64))
@pytest.mark.parametrize("n,spec", SHAPES)
def test_against_jax_allreduce_over_mesh(n, spec, count):
    for op, dtype in JAX_CASES:
        data = make_rows(n, count, np.dtype(dtype).name, seed=count + n)
        got = port_allreduce(data, spec, op)
        want = jax_over_mesh(data, spec, op)
        if op == "sum":
            assert within_fold_bound(got, want, data, op), (op, spec)
        else:
            assert same_bits(got, want), (op, spec)


@pytest.mark.parametrize("count", (35, 64))
@pytest.mark.parametrize("n,spec", SHAPES)
def test_reduce_scatter_shards_equal_jax_rank_by_rank(n, spec, count):
    data = make_rows(n, count, "int32", seed=5 * count + n)
    mesh = j_flat_mesh(n, "ft")

    def per_device(row):
        return jallreduce.reduce_scatter(row[0], "ft", topo=spec, op="sum")[None]

    want = np.array(jax.device_get(jax.jit(jax.shard_map(
        per_device, mesh=mesh, in_specs=P("ft"), out_specs=P("ft")))(
            jnp.asarray(data))))
    got = tar.reduce_scatter(list(to_torch(data)), flat_mesh(n, "cpu"), spec)
    for r in range(n):
        assert same_bits(to_numpy(got[r]), want[r]), r


@pytest.mark.parametrize("count", COUNTS)
@pytest.mark.parametrize("n", (2, 3, 4, 6, 7, 8))
def test_flat_float_sum_and_prod_are_the_sequential_fold(n, count):
    for op in ("sum", "prod"):
        for dt in ("float16", "bfloat16", "float32", "float64"):
            data = make_rows(n, count, dt, seed=count * 3 + n)
            got = port_allreduce(data, str(n), op)
            want = np.array(reduce_stacked_reference(jnp.asarray(data), op))
            assert all(same_bits(got[r], want) for r in range(n)), (op, dt)
