"""The port's train step on the (1, 1, 2) and (2, 1, 2) meshes (tensor
parallelism, with and without data parallelism; sp 1 runs the ring at
one rank, as the JAX step does), each sp_impl, against JAX
``make_train_step`` on the same mesh and against the port's one-rank
step: :func:`test_torch_model_parallel.check_step` (its tolerances are
stated there)."""

import pytest

from test_torch_model_parallel import IMPLS, check_step, jax_state  # noqa: F401


@pytest.mark.parametrize("shape", [(1, 1, 2), (2, 1, 2)])
@pytest.mark.parametrize("impl", IMPLS)
def test_step_matches_jax_and_one_rank(jax_state, impl, shape):  # noqa: F811
    check_step(jax_state, shape, impl, seed=1)
