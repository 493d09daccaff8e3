"""The port's ring attention (``parallel/ring_attention.py``) against the
JAX package's under ``shard_map``.

- The reference ring (an online softmax a visiting block) at sp 1, 2 and
  4, causal and not: each rank's output within 2e-6 of JAX's, and the
  gradients of q, k and v (a seeded cotangent, through the port's
  ``ppermute`` and JAX's) within 1e-5.
- The flash ring on the CPU (the kernels' plain versions, one call a hop,
  merged by ``hop_merge``) against the same JAX reference ring, within
  1e-5 and 2e-5; and at sp 2 against JAX's flash ring in interpret mode.
- ``hop_merge``/``hop_finalize`` and ``attention_reference(return_lse=)``
  against JAX's, within 1e-6: a row no hop touched gives zeros, not NaN.
- A future block launches nothing: the causal flash ring calls the flash
  forward ``n + n(n-1)/2`` times a group.

Inputs are seeded float32 numpy arrays; JAX runs in x64 mode on the
conftest's 8 CPU devices.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from flextree_tpu_torch.ops import flash_attention as tfa
from flextree_tpu_torch.parallel import ring_attention as tra
from flextree_tpu_torch.parallel.mesh import Mesh
from flextree_tpu_torch.parallel.spmd import axis

jra = importlib.import_module("flextree_tpu.parallel.ring_attention")


def _qkv(b=2, t=32, h=4, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32)
            for _ in range(4)]  # q, k, v and the output's cotangent


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=atol, rtol=0)


def _jax_sp(fn, sp, q, k, v, g):
    """JAX's sequence-parallel attention under ``shard_map`` over (sp,):
    the output and the gradients of ``sum(out * g)``."""
    mesh = jax.make_mesh((sp,), ("sp",))
    sharded = jax.shard_map(lambda q, k, v: fn(q, k, v, "sp"), mesh=mesh,
                            in_specs=(P(None, "sp"),) * 3,
                            out_specs=P(None, "sp"), check_vma=False)

    @jax.jit
    def run(q, k, v, g):
        out, vjp = jax.vjp(sharded, q, k, v)
        return out, vjp(g)

    out, grads = run(*(jnp.asarray(x) for x in (q, k, v, g)))
    return np.array(out), [np.array(x) for x in grads]


def _port_sp(fn, sp, q, k, v, g):
    """The port's over an ``sp``-rank in-process mesh: each rank its
    sequence shard; the output and gradients concatenated back."""
    ax = axis(Mesh(("cpu",) * sp, ("sp",)), "sp")
    ins = [[torch.from_numpy(s.copy()).requires_grad_()
            for s in np.split(x, sp, axis=1)] for x in (q, k, v)]
    outs = fn(*ins, ax)
    gs = [torch.from_numpy(s.copy()) for s in np.split(g, sp, axis=1)]
    grads = torch.autograd.grad(outs, [x for xs in ins for x in xs],
                                grad_outputs=gs)
    cat = [torch.cat(grads[i * sp:(i + 1) * sp], 1).numpy()
           for i in range(3)]
    return torch.cat(outs, 1).detach().numpy(), cat


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sp", [1, 2, 4])
def test_reference_ring_matches_jax(sp, causal):
    q, k, v, g = _qkv(seed=sp)
    want, wgrads = _jax_sp(
        lambda q, k, v, ax: jra.ring_attention(q, k, v, ax, causal=causal),
        sp, q, k, v, g)
    got, grads = _port_sp(
        lambda q, k, v, ax: tra.ring_attention(q, k, v, ax, causal=causal),
        sp, q, k, v, g)
    _close(got, want, 2e-6)
    for a, b in zip(grads, wgrads):
        _close(a, b, 1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sp", [1, 2, 4])
def test_flash_ring_matches_jax_reference(sp, causal):
    q, k, v, g = _qkv(seed=10 + sp)
    want, wgrads = _jax_sp(
        lambda q, k, v, ax: jra.ring_attention(q, k, v, ax, causal=causal),
        sp, q, k, v, g)
    got, grads = _port_sp(
        lambda q, k, v, ax: tra.ring_attention(q, k, v, ax, causal=causal,
                                               impl="flash"),
        sp, q, k, v, g)
    _close(got, want, 1e-5)
    for a, b in zip(grads, wgrads):
        _close(a, b, 2e-5)


def test_flash_ring_matches_jax_flash_ring():
    """JAX's flash ring runs its Pallas kernels in interpret mode: one
    small case, forward and gradients."""
    q, k, v, g = _qkv(b=1, t=32, h=2, d=16, seed=7)
    want, wgrads = _jax_sp(
        lambda q, k, v, ax: jra.ring_attention(q, k, v, ax, impl="flash"),
        2, q, k, v, g)
    got, grads = _port_sp(
        lambda q, k, v, ax: tra.ring_attention(q, k, v, ax, impl="flash"),
        2, q, k, v, g)
    _close(got, want, 1e-5)
    for a, b in zip(grads, wgrads):
        _close(a, b, 2e-5)


def test_hop_merge_and_finalize_match_jax():
    """Three hops merged and finalized; one row sees no hop (its lse the
    -1e30 sentinel each time) and must come out as zeros, not NaN."""
    rng = np.random.default_rng(3)
    b, t, h, d = 2, 5, 3, 8
    outs = [rng.standard_normal((b, t, h, d)).astype(np.float32)
            for _ in range(3)]
    lses = [rng.standard_normal((b, t, h)).astype(np.float32) * 4
            for _ in range(3)]
    for lse, out in zip(lses, outs):
        lse[:, 2] = -1e30
        out[:, 2] = 0.0
    m = np.full((b, t, h), -1e30, np.float32)
    carry_j = (jnp.asarray(m), jnp.zeros((b, t, h, d), jnp.float32),
               jnp.zeros((b, t, h), jnp.float32))
    carry_t = (torch.from_numpy(m.copy()), torch.zeros(b, t, h, d),
               torch.zeros(b, t, h))
    for out, lse in zip(outs, lses):
        carry_j = jra.hop_merge(carry_j, jnp.asarray(out), jnp.asarray(lse))
        carry_t = tra.hop_merge(carry_t, torch.from_numpy(out),
                                torch.from_numpy(lse))
    for a, c in zip(carry_t, carry_j):
        _close(a.numpy(), np.array(c), 1e-6)
    got = tra.hop_finalize(carry_t).numpy()
    _close(got, np.array(jra.hop_finalize(carry_j)), 1e-6)
    assert np.isfinite(got).all() and (got[:, 2] == 0).all()


@pytest.mark.parametrize("causal", [True, False])
def test_attention_reference_lse_matches_jax(causal):
    q, k, v, _ = _qkv(t=24, seed=5)
    out_j, lse_j = jra.attention_reference(
        *(jnp.asarray(x) for x in (q, k, v)), causal=causal, scale=0.3,
        return_lse=True)
    out_t, lse_t = tra.attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal, scale=0.3,
        return_lse=True)
    _close(out_t.numpy(), np.array(out_j), 1e-6)
    _close(lse_t.numpy(), np.array(lse_j), 1e-5)
    plain = tra.attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal, scale=0.3)
    _close(plain.numpy(), np.array(jra.attention_reference(
        *(jnp.asarray(x) for x in (q, k, v)), causal=causal, scale=0.3)),
        1e-6)


@pytest.mark.parametrize("sp", [2, 4])
def test_causal_flash_ring_launches_nothing_for_future_blocks(sp,
                                                              monkeypatch):
    """Each rank calls the flash forward on its resident block and on each
    block from an earlier rank of its group: ``n + n(n-1)/2`` calls a
    group; the non-causal ring calls it on every hop, ``n^2``."""
    calls = []
    real = tfa.flash_fwd

    def counted(*a, **kw):
        calls.append(kw["causal"])
        return real(*a, **kw)

    monkeypatch.setattr(tfa, "flash_fwd", counted)
    q, k, v, g = _qkv(seed=20)
    for causal, want in ((True, sp + sp * (sp - 1) // 2), (False, sp * sp)):
        calls.clear()
        _port_sp(lambda q, k, v, ax: tra.ring_attention(
            q, k, v, ax, causal=causal, impl="flash"), sp, q, k, v, g)
        assert len(calls) == want
        assert calls.count(True) == (sp if causal else 0)
