"""The port's train step on the (2, 2, 2) and (1, 2, 1) meshes, each
sp_impl, against JAX ``make_train_step`` on the same mesh and against the
port's one-rank step: :func:`test_torch_model_parallel.check_step` (its
tolerances are stated there)."""

import pytest

from test_torch_model_parallel import IMPLS, check_step, jax_state  # noqa: F401


@pytest.mark.parametrize("shape", [(2, 2, 2), (1, 2, 1)])
@pytest.mark.parametrize("impl", IMPLS)
def test_step_matches_jax_and_one_rank(jax_state, impl, shape):  # noqa: F811
    check_step(jax_state, shape, impl)
