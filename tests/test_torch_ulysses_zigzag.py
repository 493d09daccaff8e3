"""The port's Ulysses and zigzag sequence parallelism
(``parallel/ulysses.py``, ``parallel/zigzag.py``) against the JAX
package's under ``shard_map``.

- The layout moves, bitwise JAX's on integer payloads: ``seq_to_heads``
  / ``heads_to_seq`` (the tiled all-to-alls) and ``zigzag_split`` /
  ``zigzag_merge`` (the chunk-pair permutes), and each pair a round trip.
- The attentions with gradients (a seeded cotangent): the reference impls
  against JAX's within 2e-6 (output) and 1e-5 (gradients) at sp 2 and 4
  (zigzag also 3, and its zigzag layout); the flash impls on the CPU (the
  kernels' plain versions) against JAX's flash in interpret mode at sp 2,
  within 1e-5 and 2e-5.
- The refusals: heads the axis does not divide, an odd local length, an
  unknown layout or impl.
- The zigzag hop schedule, the port's ``hop_branches`` equal to JAX's and
  balanced as ``tests/test_zigzag.py`` checks it; its flash forward calls
  ``2n + 1`` a rank, none on a masked pair.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from flextree_tpu_torch.ops import flash_attention as tfa
from flextree_tpu_torch.parallel import ulysses as tul
from flextree_tpu_torch.parallel import zigzag as tzz
from flextree_tpu_torch.parallel.mesh import Mesh
from flextree_tpu_torch.parallel.spmd import axis

jul = importlib.import_module("flextree_tpu.parallel.ulysses")
jzz = importlib.import_module("flextree_tpu.parallel.zigzag")


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), atol=atol, rtol=0)


def _qkv(b=2, t=32, h=4, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32)
            for _ in range(4)]


def _ax(sp):
    return axis(Mesh(("cpu",) * sp, ("sp",)), "sp")


def _jax_map(fn, sp, *xs):
    """``fn`` under ``shard_map`` over (sp,), every input and the output
    split along dim 1."""
    mesh = jax.make_mesh((sp,), ("sp",))
    return np.array(jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(P(None, "sp"),) * len(xs),
        out_specs=P(None, "sp"), check_vma=False))(
            *(jnp.asarray(x) for x in xs)))


def _port_map(fn, sp, *xs):
    ins = [[torch.from_numpy(s.copy()) for s in np.split(x, sp, axis=1)]
           for x in xs]
    return torch.cat(fn(*ins, _ax(sp)), 1).numpy()


def _jax_vjp(fn, sp, q, k, v, g):
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


def _port_vjp(fn, sp, q, k, v, g):
    ins = [[torch.from_numpy(s.copy()).requires_grad_()
            for s in np.split(x, sp, axis=1)] for x in (q, k, v)]
    outs = fn(*ins, _ax(sp))
    grads = torch.autograd.grad(
        outs, [x for xs in ins for x in xs],
        grad_outputs=[torch.from_numpy(s.copy())
                      for s in np.split(g, sp, axis=1)])
    return (torch.cat(outs, 1).detach().numpy(),
            [torch.cat(grads[i * sp:(i + 1) * sp], 1).numpy()
             for i in range(3)])


def _ints(shape, seed=0):
    return np.random.default_rng(seed).integers(
        -2 ** 30, 2 ** 30, shape).astype(np.int32)


# ------------------------------------------------------------ layouts


@pytest.mark.parametrize("sp", [2, 4])
def test_seq_heads_moves_are_jax_bitwise(sp):
    x = _ints((2, 4 * sp, 8, 3), seed=sp)
    for tfn, jfn in ((tul.seq_to_heads, jul.seq_to_heads),
                     (tul.heads_to_seq, jul.heads_to_seq)):
        got = _port_map(lambda a, ax: tfn(a, ax), sp, x)
        want = _jax_map(lambda a: jfn(a, "sp"), sp, x)
        np.testing.assert_array_equal(got, want)
    rt = _port_map(lambda a, ax: tul.heads_to_seq(tul.seq_to_heads(a, ax),
                                                  ax), sp, x)
    np.testing.assert_array_equal(rt, x)


@pytest.mark.parametrize("sp", [2, 3, 4])
def test_zigzag_moves_are_jax_bitwise(sp):
    x = _ints((2, 4 * sp, 3, 2), seed=10 + sp)
    for tfn, jfn in ((tzz.zigzag_split, jzz.zigzag_split),
                     (tzz.zigzag_merge, jzz.zigzag_merge)):
        got = _port_map(lambda a, ax: tfn(a, ax), sp, x)
        want = _jax_map(lambda a: jfn(a, "sp"), sp, x)
        np.testing.assert_array_equal(got, want)
    rt = _port_map(lambda a, ax: tzz.zigzag_merge(tzz.zigzag_split(a, ax),
                                                  ax), sp, x)
    np.testing.assert_array_equal(rt, x)


# ---------------------------------------------------------- attentions


@pytest.mark.parametrize("sp", [1, 2, 4])
def test_ulysses_matches_jax(sp):
    q, k, v, g = _qkv(seed=sp)
    want, wgrads = _jax_vjp(lambda q, k, v, ax: jul.ulysses_attention(
        q, k, v, ax), sp, q, k, v, g)
    got, grads = _port_vjp(lambda q, k, v, ax: tul.ulysses_attention(
        q, k, v, ax), sp, q, k, v, g)
    _close(got, want, 2e-6)
    for a, b in zip(grads, wgrads):
        _close(a, b, 1e-5)


@pytest.mark.parametrize("sp,layout", [
    (1, "contiguous"), (2, "contiguous"), (3, "contiguous"),
    (4, "contiguous"), (2, "zigzag"), (4, "zigzag")])
def test_zigzag_matches_jax(sp, layout):
    q, k, v, g = _qkv(t=8 * sp, seed=20 + sp)

    def jfn(q, k, v, ax):
        return jzz.zigzag_ring_attention(q, k, v, ax, layout=layout,
                                         impl="reference")

    def tfn(q, k, v, ax):
        return tzz.zigzag_ring_attention(q, k, v, ax, layout=layout,
                                         impl="reference")

    want, wgrads = _jax_vjp(jfn, sp, q, k, v, g)
    got, grads = _port_vjp(tfn, sp, q, k, v, g)
    _close(got, want, 2e-6)
    for a, b in zip(grads, wgrads):
        _close(a, b, 1e-5)


def test_zigzag_odd_length_on_one_rank_matches_jax():
    q, k, v, g = _qkv(t=15, seed=4)
    for impl in ("reference", "flash"):
        want, wgrads = _jax_vjp(lambda q, k, v, ax: jzz.zigzag_ring_attention(
            q, k, v, ax, impl="reference"), 1, q, k, v, g)
        got, grads = _port_vjp(lambda q, k, v, ax: tzz.zigzag_ring_attention(
            q, k, v, ax, impl=impl), 1, q, k, v, g)
        _close(got, want, 1e-5)
        for a, b in zip(grads, wgrads):
            _close(a, b, 2e-5)


@pytest.mark.parametrize("which", ["ulysses", "zigzag"])
def test_flash_impls_match_jax_flash(which):
    """JAX's flash runs its Pallas kernels in interpret mode; the port's
    flash on the CPU runs the kernels' plain versions."""
    q, k, v, g = _qkv(b=1, t=32, h=2, d=16, seed=30)
    fns = {"ulysses": (jul.ulysses_attention, tul.ulysses_attention),
           "zigzag": (jzz.zigzag_ring_attention,
                      tzz.zigzag_ring_attention)}[which]
    want, wgrads = _jax_vjp(lambda q, k, v, ax: fns[0](
        q, k, v, ax, impl="flash"), 2, q, k, v, g)
    got, grads = _port_vjp(lambda q, k, v, ax: fns[1](
        q, k, v, ax, impl="flash"), 2, q, k, v, g)
    _close(got, want, 1e-5)
    for a, b in zip(grads, wgrads):
        _close(a, b, 2e-5)


# ----------------------------------------------------------- refusals


def test_refusals():
    ax = _ax(2)
    q = [torch.zeros(1, 4, 3, 8)] * 2  # 3 heads over 2 ranks
    with pytest.raises(ValueError, match="divisible"):
        tul.ulysses_attention(q, q, q, ax)
    odd = [torch.zeros(1, 3, 2, 8)] * 2
    with pytest.raises(ValueError, match="even"):
        tzz.zigzag_split(odd, ax)
    with pytest.raises(ValueError, match="even"):
        tzz.zigzag_merge(odd, ax)
    with pytest.raises(ValueError, match="even"):
        tzz.zigzag_ring_attention(odd, odd, odd, ax, layout="zigzag")
    ok = [torch.zeros(1, 4, 2, 8)] * 2
    with pytest.raises(ValueError, match="layout"):
        tzz.zigzag_ring_attention(ok, ok, ok, ax, layout="striped")
    with pytest.raises(ValueError, match="impl"):
        tzz.zigzag_ring_attention(ok, ok, ok, ax, impl="stock")
    with pytest.raises(ValueError, match="flash kwargs|impl"):
        tul.ulysses_attention(ok, ok, ok, ax, impl="stock")
    with pytest.raises(ValueError, match="tensors"):
        tzz.zigzag_split(ok[:1], ax)


# ------------------------------------------------------ the schedule


@pytest.mark.parametrize("n", [2, 3, 4, 8, 12])
def test_zigzag_schedule_matches_jax_and_is_balanced(n):
    """Every rank runs 2 visible chunk pairs a hop (3 at the diagonal hop),
    as ``tests/test_zigzag.py`` checks the JAX schedule."""
    for i in range(n):
        for s in range(n):
            src = (i - s) % n
            br = tzz.hop_branches(src, i)
            assert br == tuple(int(b) for b in jzz.hop_branches(src, i))
            work = 1 + (br[0] != 2) + (br[1] != 2)
            assert work == (3 if src == i else 2)
            assert (br[0] == 0) == (src == i) == (br[1] == 0)


@pytest.mark.parametrize("sp", [2, 4])
def test_zigzag_flash_calls(sp, monkeypatch):
    """``2n + 1`` flash forwards a rank: both chunk pairs and the
    late-vs-early pair at the diagonal hop, one visible pair and the
    late-vs-early pair at every other hop; a masked pair calls nothing."""
    calls = []
    real = tfa.flash_fwd

    def counted(*a, **kw):
        calls.append(kw["causal"])
        return real(*a, **kw)

    monkeypatch.setattr(tfa, "flash_fwd", counted)
    q, k, v, g = _qkv(t=8 * sp, seed=40)
    _port_vjp(lambda q, k, v, ax: tzz.zigzag_ring_attention(
        q, k, v, ax, impl="flash"), sp, q, k, v, g)
    assert len(calls) == sp * (2 * sp + 1)
    assert calls.count(True) == 2 * sp
