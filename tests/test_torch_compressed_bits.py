"""The port's int8 compressed collectives bitwise against the JAX
package's, run op by op.

Compiled, XLA:CPU contracts the decode's product into the add that
follows it (a fused multiply-add: one rounding where the port rounds
twice), so ``test_torch_compressed.py`` holds the compiled functions to
the error bound and to a few float32 roundings element by element.  Under
``jax.disable_jit()`` every JAX op rounds on its own, and the port's
collectives give JAX's bits: result and residual, on every rank.  Each
case at a count with a block pad and (where the shape has one) a tail:
the width-2 tree stage, the flat tree of 8 (a fold of 8 decoded tiles in
group order), ``2,2,2`` (three width-2 stages, each with its own salt),
``4,2`` chunk-pipelined in two chunks (each chunk's phase 2 with its own
salt), the 2-rank ring and a lonely shape on 3 ranks.  The 8-rank ring
and ``3,2+1`` on 7 ranks, whose walks take longest op by op, are in
``test_torch_compressed_bits_walks.py``.  Op by op the JAX functions are
slow (each op compiles on its own), so the counts are small.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from flextree_tpu.parallel import compressed as jc
from flextree_tpu.parallel.mesh import flat_mesh as j_flat_mesh
from flextree_tpu_torch.parallel import compressed as tc
from flextree_tpu_torch.parallel.mesh import flat_mesh


def assert_int8_bitwise_op_by_op(n, spec, count, chunks=1):
    """The int8 ``compressed_allreduce`` of seeded rows (step 5), result
    and residual on every rank, bitwise the JAX function's under
    ``jax.disable_jit``."""
    x = (np.random.default_rng(count).standard_normal((n, count))
         * 3).astype(np.float32)

    def body(row):
        out, res = jc.compressed_allreduce(row[0], "ft", topo=spec,
                                           codec="int8", chunks=chunks,
                                           step=5, return_residual=True)
        return out[None], res[None]

    with jax.disable_jit():
        want = jax.shard_map(body, mesh=j_flat_mesh(n, "ft"),
                             in_specs=P("ft"), out_specs=P("ft"),
                             check_vma=False)(jnp.asarray(x))
    got = tc.compressed_allreduce(list(torch.from_numpy(x.copy())),
                                  flat_mesh(n, "cpu"), spec, "int8", chunks,
                                  5, return_residual=True)
    for w, g in zip(want, got):
        assert np.array(w).tobytes() == \
            np.stack([t.numpy() for t in g]).tobytes()


@pytest.mark.parametrize("n,spec,count,chunks", [
    (2, "2", 2 * 1030 + 1, 1), (8, "8", 777, 1), (2, "1", 2 * 1030, 1),
    (3, "2+1", 2 * 1030 + 1, 1), (8, "2,2,2", 8 * 260 + 3, 1),
    (8, "4,2", 8 * 260 + 3, 2)])
def test_int8_allreduce_bitwise_against_jax_op_by_op(n, spec, count, chunks):
    assert_int8_bitwise_op_by_op(n, spec, count, chunks)
