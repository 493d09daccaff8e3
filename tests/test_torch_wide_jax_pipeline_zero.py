"""The pipeline step on the (1, 2, 2, 2) dp/pp/sp/tp, 2 microbatches mesh under
``shard_optimizer``, ``overlap`` and both against the JAX package's step
under ``shard_map`` on its 8 virtual CPU devices, two steps from one
state: :func:`test_torch_wide.check_against_jax` (its bars are stated
there)."""

import pytest

from test_torch_wide import check_against_jax


@pytest.mark.parametrize("option", ["zero", "overlap", "zero_overlap"])
def test_pipeline_sharded_or_overlapped_matches_jax(option):
    check_against_jax("pipeline", option)
