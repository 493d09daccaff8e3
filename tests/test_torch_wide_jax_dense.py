"""The dense step on the (2, 2, 2) dp/sp/tp mesh under each wide-mesh option
(``codec=int8``, ``codec=bf16``, ``shard_optimizer``, ``overlap``,
``shard_optimizer+overlap``) against the JAX package's step under
``shard_map`` on its 8 virtual CPU devices, two steps from one state:
:func:`test_torch_wide.check_against_jax` (its bars are stated there)."""

import pytest

from test_torch_wide import OPTIONS, check_against_jax


@pytest.mark.parametrize("option", list(OPTIONS))
def test_dense_option_matches_jax(option):
    check_against_jax("dense", option)
