"""The port's compressed collectives (``parallel/compressed.py``) against
the JAX package's on the conftest's 8 CPU devices (``shard_map``, as
``tests/test_quantize.py`` runs them), on the same seeded numpy inputs.

Every shape kind (``8``, ``4,2``, ``2,2,2``, the ring, ``3,2+1`` and
``7+1``, and the width-2 ``2`` and ring on 2 ranks), both lossy codecs,
counts on the block, with a tail and with padding, ``chunks`` 1 and 2,
``return_residual``:

- every rank's result bitwise every other rank's (replica consistency);
- the port and the JAX function each within ``Codec.error_bound`` of the
  exact float64 sum, and the port's residual within one float32 rounding
  of JAX's (the same encode bits; see below);
- int8: element by element within a few float32 roundings of JAX's (the
  same stochastic roundings at every stage, hop and chunk: a wrong salt
  or layout would move elements by a quantization step);
- bitwise against JAX where XLA adds in the port's order and rounding:
  the bf16 codec on every shape whose sums have two terms.

Why the int8 collectives are not bitwise against *compiled* JAX: XLA:CPU
contracts the decode's product into the add that follows it (the fold
``dec.sum(0)``, the residual ``x - q * s``) as a fused multiply-add, one
rounding where the port's plain decode and the fold kernel round twice.
``test_torch_compressed_bits.py`` runs the JAX functions op by op
(``jax.disable_jit``), where they are bitwise the port's.

Then the port alone: ``compressed_all_gather(compressed_reduce_scatter(x))``
bitwise ``compressed_allreduce(x)`` on block-aligned buffers (the JAX
contract), the step keying the rounding, the identity codec bitwise
``allreduce``, the EF running mean converging (the JAX
``TestErrorFeedback``), and one spawn of 3 gloo processes bitwise the
in-process mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from flextree_tpu.parallel import compressed as jc
from flextree_tpu.parallel.mesh import flat_mesh as j_flat_mesh
from flextree_tpu_torch.bench.harness import digest, dist_compressed_cases
from flextree_tpu_torch.ops.quantize import get_codec
from flextree_tpu_torch.parallel import allreduce as tar
from flextree_tpu_torch.parallel import compressed as tc
from flextree_tpu_torch.parallel import launch
from flextree_tpu_torch.parallel.mesh import flat_mesh
from flextree_tpu_torch.schedule.stages import LonelyTopology, Topology

SHAPES = ((8, "8"), (8, "4,2"), (8, "2,2,2"), (8, "1"), (7, "3,2+1"),
          (8, "7+1"), (2, "2"), (2, "1"))
WIDTH_TWO = {(2, "2"), (2, "1"), (8, "2,2,2")}


def _rows(n, size, seed, scale=3.0):
    return (np.random.default_rng(seed).standard_normal((n, size))
            * scale).astype(np.float32)


def _jax(n, fn, x):
    """``fn`` on each device's row under ``shard_map``; the rows of each
    result stacked."""
    mesh = j_flat_mesh(n, "ft")

    def body(row):
        out = fn(row[0])
        return tuple(o[None] for o in (out if isinstance(out, tuple)
                                       else (out,)))

    got = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("ft"),
                                out_specs=P("ft"), check_vma=False))(
        jnp.asarray(x))
    return [np.array(g) for g in got]


def _port(fn, x, *a, **kw):
    got = fn(list(torch.from_numpy(x.copy())), flat_mesh(len(x), "cpu"), *a,
             **kw)
    parts = got if isinstance(got, tuple) else (got,)
    return [np.stack([t.numpy() for t in p]) for p in parts]


def _bound(n, spec, codec, x):
    t = Topology.resolve(n, spec)
    widths, lonely = (t.tree.widths, t.lonely) \
        if isinstance(t, LonelyTopology) else (t.widths, 0)
    return get_codec(codec).error_bound(float(np.abs(x).max()), n, widths,
                                        lonely)


def assert_same_roundings(got, want, scale):
    """Int8 results element by element against compiled JAX: the same
    stochastic roundings, so every element within a few float32 roundings
    of ``scale`` (the sum's largest magnitude, ``n * amax``) and none a
    quantization step apart.  A wrong salt, step or index layout at any
    stage, hop or chunk moves about half the elements it touches by a
    step of their block (``amax / 127`` and more)."""
    gap = np.abs(got.astype(np.float64) - want)
    assert gap.max() <= 2.0 ** -18 * scale


def _consistent(out):
    return all(out[0].tobytes() == r.tobytes() for r in out[1:])


CASES = [(n, spec, size, chunks) for n, spec in SHAPES
         for size in ((4096, 4100, 777) if spec in ("8", "3,2+1")
                      else (4096, 4100))
         for chunks in ((1, 2) if spec in ("4,2", "2,2,2") else (1,))]


@pytest.mark.parametrize("codec", ("int8", "bf16"))
@pytest.mark.parametrize("n,spec,size,chunks", CASES,
                         ids=[f"{s}-n{n}-{z}-c{c}" for n, s, z, c in CASES])
def test_compressed_allreduce_against_jax(n, spec, size, chunks, codec):
    x = _rows(n, size, seed=size + n)
    want, want_res = _jax(n, lambda v: jc.compressed_allreduce(
        v, "ft", topo=spec, codec=codec, chunks=chunks, step=5,
        return_residual=True), x)
    got, res = _port(tc.compressed_allreduce, x, spec, codec, chunks, 5,
                     return_residual=True)
    exact = x.astype(np.float64).sum(0)
    bound = _bound(n, spec, codec, x) + 1e-5
    assert _consistent(got) and _consistent(want)
    assert np.abs(got - exact).max() <= bound
    assert np.abs(want - exact).max() <= bound
    # the residual: the same encode; the decode's product rounded once
    # more than under XLA's fused multiply-add
    amax = float(np.abs(x).max())
    np.testing.assert_allclose(res, want_res, rtol=0, atol=2.0 ** -22 * amax)
    assert np.abs(res).max() <= amax / (127.0 if codec == "int8" else 256.0)
    if codec == "int8":
        assert_same_roundings(got, want, n * amax)
    if codec == "bf16" and (n, spec) in WIDTH_TWO and (n == 2 or size % n == 0):
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("codec", ("int8", "bf16"))
@pytest.mark.parametrize("n,spec", ((8, "4,2"), (8, "1"), (7, "3,2+1"),
                                    (2, "2")))
def test_compressed_split_phases_against_jax(n, spec, codec):
    """``compressed_reduce_scatter`` shards (and residuals) and
    ``compressed_all_gather`` of them, each within the bound of the JAX
    functions' on the same rows, the shards in the same layout, with a
    tail."""
    count = 2051 * (n if n != 7 else 6) + 3
    x = _rows(n, count, seed=7 * n)
    j_shard, j_res = _jax(n, lambda v: jc.compressed_reduce_scatter(
        v, "ft", topo=spec, codec=codec, step=2, return_residual=True), x)
    shard, res = _port(tc.compressed_reduce_scatter, x, spec, codec, 2,
                       return_residual=True)
    (j_full,) = _jax(n, lambda s: jc.compressed_all_gather(
        s, "ft", topo=spec, out_shape=(count,), codec=codec, step=2), j_shard)
    (full,) = _port(tc.compressed_all_gather, shard, spec, (count,), codec, 2)
    bound = _bound(n, spec, codec, x) + 1e-5
    exact = x.astype(np.float64).sum(0)
    assert shard.shape == j_shard.shape
    assert np.abs(shard - j_shard).max() <= bound
    assert np.abs(full - exact).max() <= bound
    assert np.abs(j_full - exact).max() <= bound
    assert _consistent(full)
    if codec == "int8":
        amax = float(np.abs(x).max())
        assert_same_roundings(shard, j_shard, n * amax)
        assert_same_roundings(full, j_full, n * amax)
    np.testing.assert_allclose(res, j_res, rtol=0,
                               atol=2.0 ** -22 * float(np.abs(x).max()))


@pytest.mark.parametrize("codec", ("int8", "bf16"))
@pytest.mark.parametrize("n,spec", ((8, "8"), (8, "4,2"), (8, "2,2,2"),
                                    (8, "1"), (7, "3,2+1"), (8, "3,2+2")))
def test_split_phases_compose_to_the_allreduce(n, spec, codec):
    """On a block-aligned buffer the two halves are the allreduce, bitwise
    (JAX ``compressed.py``'s contract), and a shape whose tree shard is
    block-aligned returns the wire's residual, bitwise the local map's."""
    m = Topology.resolve(n, spec)
    owners = m.tree.num_nodes if isinstance(m, LonelyTopology) else n
    count = owners * 2 * 1024
    x = _rows(n, count, seed=n)
    full, res = _port(tc.compressed_allreduce, x, spec, codec, 1, 9,
                      return_residual=True)
    (shard,) = _port(tc.compressed_reduce_scatter, x, spec, codec, 9)
    (back,) = _port(tc.compressed_all_gather, shard, spec, (count,), codec, 9)
    assert back.tobytes() == full.tobytes()
    local = np.stack([tc.local_residual(torch.from_numpy(r.copy()), codec, 9)
                      .numpy() for r in x])
    assert res.tobytes() == local.tobytes()


def test_step_keys_the_rounding_and_identity_is_allreduce():
    x = _rows(8, 2048, seed=10)
    a, b, c = (_port(tc.compressed_allreduce, x, "8", "int8", 1, s)[0]
               for s in (3, 3, 4))
    assert a.tobytes() == b.tobytes() != c.tobytes()
    for spec in ("8", "4,2", "1", "7+1"):
        for size in (4096, 4100):
            x = _rows(8, size, seed=size)
            got, res = _port(tc.compressed_allreduce, x, spec, "f32", 2, 0,
                             return_residual=True)
            (want,) = _port(tar.allreduce, x, spec, "sum", 2)
            assert got.tobytes() == want.tobytes() and not res.any()
    (one,) = _port(tc.compressed_allreduce, x[:1], None, "int8")
    assert one.tobytes() == x[:1].tobytes()
    with pytest.raises(ValueError, match="unsupported codec"):
        tc.compressed_allreduce(list(torch.from_numpy(x)),
                                flat_mesh(8, "cpu"), "8", "fp4")
    with pytest.raises(ValueError, match="unsupported codec"):
        tar.reduce_scatter(list(torch.from_numpy(x)), flat_mesh(8, "cpu"),
                           "4,2", codec="identity")


def test_constant_gradient_running_mean_converges():
    """The JAX ``TestErrorFeedback`` contract on the port: sync ``g + e``
    compressed, carry ``e' = input - C(input)``; the running mean of the
    synced gradient converges to the exact ``n * g`` at ~1/N."""
    n = 8
    g = np.random.default_rng(3).standard_normal(2048).astype(np.float32)
    exact = n * g.astype(np.float64)
    bound = get_codec("int8").error_bound(float(np.abs(g).max()), n, (n,))
    e = np.zeros_like(g)
    acc = np.zeros_like(exact)
    errs = {}
    for step in range(1, 25):
        x = np.tile(g + e, (n, 1))
        out, res = _port(tc.compressed_allreduce, x, "8", "int8", 1, step,
                         return_residual=True)
        acc += out[0].astype(np.float64)
        e = res[0]
        errs[step] = np.abs(acc / step - exact).max()
        assert np.abs(e).max() <= float(np.abs(g + e).max()) / 127.0 + 1e-6
    assert errs[1] <= bound + 1e-5
    assert errs[24] < errs[1] / 8
    assert errs[24] < bound / 10


def test_gloo_ranks_bitwise_the_mesh():
    """One spawn of 3 gloo processes, each a rank of the process group: its
    allreduce, residual, shard and gather bitwise the in-process mesh's
    rank, on the tree, the ring and a lonely shape, both codecs, a tail."""
    cases = [("3", 3 * 1100 + 2, "int8", 1, 2, 3),
             ("1", 3 * 1030 + 1, "int8", 2, 1, 4),
             ("2+1", 2 * 1500 + 1, "int8", 3, 1, 5),
             ("3", 3 * 700 + 2, "bf16", 4, 1, 6),
             ("2+1", 2 * 700 + 1, "bf16", 5, 1, 7)]
    got = launch.spawn(dist_compressed_cases, 3, (cases,), backend="gloo",
                       timeout=120)
    from flextree_tpu_torch.bench.harness import seeded_row

    mesh = flat_mesh(3, "cpu")
    for k, (topo, count, codec, seed, chunks, step) in enumerate(cases):
        xs = [seeded_row(r, count, torch.float32, seed) for r in range(3)]
        full, res = tc.compressed_allreduce(xs, mesh, topo, codec, chunks,
                                            step, return_residual=True)
        shard = tc.compressed_reduce_scatter(xs, mesh, topo, codec, step)
        back = tc.compressed_all_gather(shard, mesh, topo, (count,), codec,
                                        step)
        for r in range(3):
            assert got[r][k] == tuple(digest(t[r]) for t in
                                      (full, res, shard, back)), (k, r)
