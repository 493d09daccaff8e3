"""The pipeline step on the (1, 2, 2, 2) dp/pp/sp/tp, 2 microbatches mesh under the lossy
codecs (``codec=int8``, ``codec=bf16``) against the JAX package's step
under ``shard_map`` on its 8 virtual CPU devices, two steps from one
state: :func:`test_torch_wide.check_against_jax` (its bars are stated
there).  ``test_torch_wide_jax_pipeline_zero.py`` holds the other options
(split so that two test workers share the JAX compiles)."""

import pytest

from test_torch_wide import check_against_jax


@pytest.mark.parametrize("option", ["int8", "bf16"])
def test_pipeline_option_matches_jax(option):
    check_against_jax("pipeline", option)
