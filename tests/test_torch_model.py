"""The port's model layer (``flextree_tpu_torch.models``) against the JAX
package's, on the same converted weights and the same numpy inputs.

Tolerances (float32 on the CPU): each op within 1e-6 of its JAX twin (the
two differ only in the last bits of pow/sin/rsqrt and summation order);
logits within 1e-4 (a few layers of those differences); greedy tokens
identical.  JAX runs with ``jax_enable_x64`` under this suite's conftest,
so every input is handed over as an explicit float32 / int32 array.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flextree_tpu.models import transformer as jt
from flextree_tpu_torch.convert import params_from_numpy
from flextree_tpu_torch.models import transformer as tt

jg = importlib.import_module("flextree_tpu.models.generate")
tg = importlib.import_module("flextree_tpu_torch.models.generate")

OP_ATOL = 1e-6
LOGIT_ATOL = 1e-4
DIMS = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)


@pytest.fixture(scope="module")
def model():
    jcfg = jt.TransformerConfig(**DIMS)
    tcfg = tt.TransformerConfig(**DIMS)
    jparams = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


def _np(x):
    return x.detach().cpu().numpy()


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=atol, rtol=0)


def test_init_params_matches_jax_shapes(model):
    jcfg, jparams, tcfg, _ = model
    mine = tt.init_params(tcfg, torch.Generator().manual_seed(0),
                          device="cpu")
    ref = jax.tree.map(lambda a: tuple(a.shape), jparams)
    got = {"embed": tuple(mine["embed"].shape),
           "ln_f": tuple(mine["ln_f"].shape),
           "layers": [{k: tuple(v.shape) for k, v in layer.items()}
                      for layer in mine["layers"]]}
    assert got == ref
    again = tt.init_params(tcfg, torch.Generator().manual_seed(0),
                           device="cpu")
    assert torch.equal(mine["layers"][1]["w2"], again["layers"][1]["w2"])


def test_params_from_numpy_is_loud_on_missing_keys(model):
    _, jparams, _, _ = model
    tree = jax.tree.map(np.asarray, jparams)
    del tree["layers"][0]["w1"]
    with pytest.raises(ValueError, match="layer 0"):
        params_from_numpy(tree, device="cpu")


def test_rms_norm(model):
    _, jparams, _, tparams = model
    h = np.random.default_rng(1).standard_normal((2, 5, 32)).astype(np.float32)
    scale = np.random.default_rng(2).standard_normal(32).astype(np.float32)
    a = jt.rms_norm(jnp.asarray(h), jnp.asarray(scale))
    b = tt.rms_norm(torch.from_numpy(h), torch.from_numpy(scale))
    _close(a, _np(b), OP_ATOL)


@pytest.mark.parametrize("shared", [True, False])
def test_apply_rope(shared):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 4, 8)).astype(np.float32)
    pos = (np.arange(6, dtype=np.int32) + 5 if shared
           else rng.integers(0, 1000, (2, 6)).astype(np.int32))
    a = jt.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    b = tt.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    _close(a, _np(b), OP_ATOL)


def test_mlp_block_uses_tanh_gelu(model):
    """``jax.nn.gelu`` defaults to the tanh approximation; the exact GELU
    would be ~3e-4 off here."""
    jcfg, jparams, tcfg, tparams = model
    h = np.random.default_rng(4).standard_normal((2, 5, 32)).astype(np.float32)
    a = jt.mlp_block(jparams["layers"][0], jnp.asarray(h), jcfg)
    b = tt.mlp_block(tparams["layers"][0], torch.from_numpy(h), tcfg)
    _close(a, _np(b), OP_ATOL)


def test_final_logits(model):
    _, jparams, _, tparams = model
    h = np.random.default_rng(5).standard_normal((2, 3, 32)).astype(np.float32)
    a = jt.final_logits(jparams["embed"], jparams["ln_f"], jnp.asarray(h))
    b = tt.final_logits(tparams["embed"], tparams["ln_f"], torch.from_numpy(h))
    assert b.dtype == torch.float32
    _close(a, _np(b), OP_ATOL)


def test_forward_logits(model):
    jcfg, jparams, tcfg, tparams = model
    tok = np.random.default_rng(6).integers(0, 64, (2, 12)).astype(np.int32)
    a = jt.forward(jparams, jnp.asarray(tok), jcfg)
    b = tt.forward(tparams, torch.from_numpy(tok), tcfg)
    assert tuple(b.shape) == (2, 12, 64)
    _close(a, _np(b), LOGIT_ATOL)


def test_forward_bf16_compute_is_close(model):
    """bf16 compute on the CPU: same function, bf16 rounding in both
    frameworks at slightly different places — a loose bound that still
    catches a wrong cast (which moves logits by O(1))."""
    _, jparams, _, tparams = model
    jcfg = jt.TransformerConfig(**DIMS, dtype=jnp.bfloat16)
    tcfg = tt.TransformerConfig(**DIMS, dtype=torch.bfloat16)
    tok = np.random.default_rng(7).integers(0, 64, (1, 8)).astype(np.int32)
    a = jt.forward(jparams, jnp.asarray(tok), jcfg)
    b = tt.forward(tparams, torch.from_numpy(tok), tcfg)
    _close(a, _np(b), 0.05)


def test_cast_params_computes_the_same_function(model):
    _, _, _, tparams = model
    tcfg = tt.TransformerConfig(**DIMS, dtype=torch.bfloat16)
    tok = torch.from_numpy(
        np.random.default_rng(8).integers(0, 64, (1, 8)).astype(np.int64))
    cast = tt.cast_params(tparams, torch.bfloat16, "cpu")
    assert cast["layers"][0]["wq"].dtype == torch.bfloat16
    assert cast["ln_f"].dtype == torch.float32
    assert torch.equal(tt.forward(cast, tok, tcfg),
                       tt.forward(tparams, tok, tcfg))


def test_prefill_and_decode_step(model):
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(9)
    tok = rng.integers(0, 64, (2, 7)).astype(np.int32)
    ja, jcache = jg.prefill(jparams, jnp.asarray(tok), jcfg, max_len=16)
    ta, tcache = tg.prefill(tparams, torch.from_numpy(tok), tcfg, max_len=16)
    _close(ja, _np(ta), LOGIT_ATOL)
    for layer in range(2):
        _close(jcache["k"][layer], _np(tcache["k"][layer]), 1e-5)
        _close(jcache["v"][layer], _np(tcache["v"][layer]), 1e-5)
    nxt = rng.integers(0, 64, (2,)).astype(np.int32)
    jb, jcache = jg.decode_step(jparams, jcache, jnp.asarray(nxt), jcfg)
    tb, tcache = tg.decode_step(tparams, tcache, torch.from_numpy(nxt), tcfg)
    _close(jb, _np(tb), LOGIT_ATOL)
    np.testing.assert_array_equal(np.asarray(jcache["length"]),
                                  _np(tcache["length"]))


def test_ragged_decode_positions(model):
    """Per-row start positions (the serving batcher's ragged batch)."""
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(10)
    tok = rng.integers(0, 64, (3, 9)).astype(np.int32)
    _, jcache = jg.prefill(jparams, jnp.asarray(tok), jcfg, max_len=16)
    _, tcache = tg.prefill(tparams, torch.from_numpy(tok), tcfg, max_len=16)
    lengths = np.array([3, 9, 6], np.int32)
    jcache["length"] = jnp.asarray(lengths)
    tcache["length"] = torch.from_numpy(lengths)
    nxt = rng.integers(0, 64, (3,)).astype(np.int32)
    ja, _ = jg.decode_step(jparams, jcache, jnp.asarray(nxt), jcfg)
    ta, _ = tg.decode_step(tparams, tcache, torch.from_numpy(nxt), tcfg)
    _close(ja, _np(ta), LOGIT_ATOL)


def test_prefill_suffix_matches_full_prefill(model):
    jcfg, jparams, tcfg, tparams = model
    tok = np.random.default_rng(11).integers(0, 64, (1, 10)).astype(np.int32)
    full, cache = tg.prefill(tparams, torch.from_numpy(tok), tcfg, max_len=16)
    prefix = {kind: [c[:, :6].clone() for c in cache[kind]]
              for kind in ("k", "v")}
    suf, _ = tg.prefill_suffix(tparams, torch.from_numpy(tok[:, 6:]), prefix,
                               tcfg, max_len=16)
    _close(_np(full), _np(suf), LOGIT_ATOL)
    jprefix = {kind: [jnp.asarray(_np(c)) for c in prefix[kind]]
               for kind in ("k", "v")}
    jsuf, _ = jg.prefill_suffix(jparams, jnp.asarray(tok[:, 6:]), jprefix,
                                jcfg, max_len=16)
    _close(jsuf, _np(suf), LOGIT_ATOL)


@pytest.mark.parametrize("batch,prompt_len", [(1, 5), (3, 8)])
def test_generate_greedy_tokens_identical(model, batch, prompt_len):
    jcfg, jparams, tcfg, tparams = model
    rng = np.random.default_rng(12 + batch)
    tok = rng.integers(0, 64, (batch, prompt_len)).astype(np.int32)
    want = jg.generate(jparams, jnp.asarray(tok), jcfg, max_new_tokens=12,
                       max_len=24)
    got = tg.generate(tparams, torch.from_numpy(tok), tcfg,
                      max_new_tokens=12, max_len=24)
    np.testing.assert_array_equal(np.asarray(want), _np(got))


def test_generate_stop_tokens_identical(model):
    jcfg, jparams, tcfg, tparams = model
    tok = np.random.default_rng(14).integers(0, 64, (3, 6)).astype(np.int32)
    free = np.asarray(jg.generate(jparams, jnp.asarray(tok), jcfg,
                                  max_new_tokens=10))
    stop = (int(free[0, 3]), int(free[1, 1]))
    want, wlen = jg.generate(jparams, jnp.asarray(tok), jcfg,
                             max_new_tokens=10, stop_tokens=stop, pad_token=7)
    got, glen = tg.generate(tparams, torch.from_numpy(tok), tcfg,
                            max_new_tokens=10, stop_tokens=stop, pad_token=7)
    np.testing.assert_array_equal(np.asarray(want), _np(got))
    np.testing.assert_array_equal(np.asarray(wlen), _np(glen))


def test_sample_token_semantics():
    logits = torch.from_numpy(
        np.random.default_rng(15).standard_normal((4, 64)).astype(np.float32))
    greedy = tg.sample_token(logits)
    assert torch.equal(greedy, logits.argmax(-1))
    # top_k=1 sampling can only pick the argmax
    top1 = tg.sample_token(logits, temperature=0.8, top_k=1,
                           generator=torch.Generator().manual_seed(0))
    assert torch.equal(top1, greedy)
    a = tg.sample_token(logits, temperature=1.0, top_k=8,
                        generator=torch.Generator().manual_seed(3))
    b = tg.sample_token(logits, temperature=1.0, top_k=8,
                        generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    kth = torch.topk(logits, 8, dim=-1)[0][:, -1]
    assert bool((logits[torch.arange(4), a] >= kth).all())
    with pytest.raises(ValueError, match="generator"):
        tg.sample_token(logits, temperature=1.0)
    with pytest.raises(ValueError, match="top_k"):
        tg.sample_token(logits, top_k=3)


def test_generate_sampled_is_deterministic_per_generator(model):
    _, _, tcfg, tparams = model
    tok = torch.from_numpy(np.arange(5, dtype=np.int64)[None])
    runs = [tg.generate(tparams, tok, tcfg, max_new_tokens=8,
                        temperature=1.0, generator=torch.Generator().manual_seed(s))
            for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1])
    with pytest.raises(ValueError, match="generator"):
        tg.generate(tparams, tok, tcfg, max_new_tokens=2, temperature=1.0)
