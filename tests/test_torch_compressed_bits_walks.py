"""The port's int8 compressed collectives bitwise against the JAX
package's, run op by op, on the two walks with the most hops: the ring
on 8 ranks (7 reduce hops and 7 forward hops, each with its own salt) and
``3,2+1`` on 7 ranks (the buddy fold, the prefix stages as group rings
with their salts, and the restore).  Result and residual on every rank;
``test_torch_compressed_bits.py`` says why op by op.  A file of its own,
so the tier-1 run's workers share the op-by-op cases.
"""

import pytest
from test_torch_compressed_bits import assert_int8_bitwise_op_by_op


@pytest.mark.parametrize("n,spec,count", [(8, "1", 8 * 130 + 3),
                                          (7, "3,2+1", 6 * 260 + 3)])
def test_int8_walks_bitwise_against_jax_op_by_op(n, spec, count):
    assert_int8_bitwise_op_by_op(n, spec, count)
