"""The port's serving bench against the JAX bench, and
``prefill_ragged`` against the JAX function: the bench's workload stream,
constants and cache config are the JAX bench's (``tools/bench_serving.py``),
and ``prefill_ragged`` gives the JAX function's logits (float32, atol 1e-5)
and its cache lengths exactly, on the same converted weights, with a
decode step from the ragged cache agreeing too."""

from __future__ import annotations

import importlib
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flextree_tpu_torch.convert import params_from_numpy
from flextree_tpu_torch.models.transformer import TransformerConfig as TCfg
from flextree_tpu_torch.tools import bench_serving as tbs

tgen = importlib.import_module("flextree_tpu_torch.models.generate")
jt = importlib.import_module("flextree_tpu.models.transformer")
jgen = importlib.import_module("flextree_tpu.models.generate")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)


def _jax_bench():
    """The JAX bench as a module (it lives in ``tools/``, no package)."""
    spec = importlib.util.spec_from_file_location(
        "jax_bench_serving", os.path.join(REPO, "tools", "bench_serving.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_workload_and_constants_are_the_jax_bench():
    jb = _jax_bench()
    for name in ("MIN_THROUGHPUT_RATIO", "PROMPT_LENS", "OUT_LENS",
                 "OUT_PROBS", "STATIC_BATCH", "CONT_SLOTS"):
        assert getattr(tbs, name) == getattr(jb, name), name
    assert tbs._pcfg().max_len == jb._pcfg().max_len
    assert (tbs._pcfg().num_blocks, tbs._pcfg().block_size) == \
        (jb._pcfg().num_blocks, jb._pcfg().block_size)
    assert tbs.WIDTHS["jax"] == {k: getattr(jb._model()[0], k) for k in
                                 tbs.WIDTHS["jax"]}
    for seed in (0, 3):
        for n, rate in ((16, 200.0), (48, 50.0)):
            t, j = tbs.build_workload(seed, n, rate), \
                jb.build_workload(seed, n, rate)
            assert [(r.rid, r.prompt.tobytes(), r.max_new_tokens,
                     r.arrival_s) for r in t] == \
                [(r.rid, r.prompt.tobytes(), r.max_new_tokens, r.arrival_s)
                 for r in j]


@pytest.fixture(scope="module")
def model():
    jcfg = jt.TransformerConfig(**DIMS)
    jparams = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, TCfg(**DIMS), tparams


@pytest.mark.parametrize("lengths", [(3, 7, 5, 7), (1, 2, 7, 4)])
def test_prefill_ragged_matches_jax(model, lengths):
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(sum(lengths))
    b, t, max_len = len(lengths), max(lengths), 16
    tokens = np.zeros((b, t), np.int32)
    for i, n in enumerate(lengths):
        tokens[i, :n] = rng.integers(0, DIMS["vocab_size"], n)
    lens = np.asarray(lengths, np.int32)
    jlast, jcache = jgen.prefill_ragged(jparams, jnp.asarray(tokens),
                                        jnp.asarray(lens), jcfg, max_len)
    tlast, tcache = tgen.prefill_ragged(tparams, torch.from_numpy(tokens),
                                        torch.from_numpy(lens), tcfg, max_len)
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(tcache["length"].numpy(),
                                  np.asarray(jcache["length"]))
    assert tcache["length"].dtype == torch.int32
    # a decode step from the ragged cache: each row at its own length
    tok = np.asarray(jnp.argmax(jlast, -1), np.int32)
    jl, _ = jgen.decode_step(jparams, jcache, jnp.asarray(tok), jcfg)
    tl, _ = tgen.decode_step(tparams, tcache, torch.from_numpy(tok).long(),
                             tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="exceeds max_len"):
        tgen.prefill_ragged(tparams, torch.from_numpy(tokens),
                            torch.from_numpy(lens), tcfg, t - 1)
