"""The port's paged decode attention (``flextree_tpu_torch.ops.
paged_attention``) against the JAX package's, on the same numpy inputs.

On the CPU the wrapper computes the plain stream (its CUDA kernel runs
only on the card, where ``chip_smoke.py`` holds it against the same plain
versions).  Held here:

- the port's stream and gather against JAX's gather oracle and against
  its Pallas kernel run interpreted, as the JAX package's own tests run
  it: within ``FUSED_DECODE_ATOL`` in float32, 0.05 in bfloat16;
- the poisoned-null-block invariance, bitwise, at boundary lengths;
- loud shape errors, and no silent fallback off the CPU;
- the plain version of the kernel's split-K against JAX's Pallas kernel
  and gather oracle, at lengths on either side of a split's edge, and the
  kernel's split width read from its source;
- the paged decode step, fused and gather, against the JAX one.
"""

import re
from pathlib import Path


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flextree_tpu.models.transformer import TransformerConfig as JCfg
from flextree_tpu.models.transformer import init_params as j_init_params
from flextree_tpu.ops import paged_attention as jpa
from flextree_tpu.serving import kv_cache as jkv
from flextree_tpu_torch.convert import params_from_numpy
from flextree_tpu_torch.models.transformer import TransformerConfig as TCfg
from flextree_tpu_torch.ops.paged_attention import (
    FUSED_DECODE_ATOL,
    paged_attention,
    KERNEL_BLOCKS_PER_SPLIT,
    paged_attention_gather,
    paged_attention_split_plain,
    paged_attention_stream,
)
from flextree_tpu_torch.serving import kv_cache as tkv

S, H, D, N, BS, P = 5, 4, 16, 32, 8, 7
#: empty row, short, block-aligned, mid-block, near-full
LENGTHS = (0, 3, 8, 17, 41)
#: the boundary classes: 0, 1, bs-1, bs, bs+1, P*bs-1
BOUNDARY = (0, 1, BS - 1, BS, BS + 1, P * BS - 1)

#: either side of a split's edge (C blocks of BS), and a full table row
C = KERNEL_BLOCKS_PER_SPLIT
SPLIT_EDGES = (0, C * BS - 1, C * BS, C * BS + 1, P * BS - 1)
CSRC = Path(__file__).resolve().parents[1] / "flextree_tpu_torch" / "csrc"

_TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}
_JAX = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TOL = {"f32": FUSED_DECODE_ATOL, "bf16": 0.05}


def _inputs(lengths=LENGTHS, seed=0):
    """numpy float32 q, k_new, v_new, k_pool, v_pool, int32 tables and
    lengths; each row owns ``length // BS + 1`` private blocks."""
    rng = np.random.default_rng(seed)
    s = len(lengths)
    q, kn, vn = (rng.standard_normal((s, H, D)).astype(np.float32)
                 for _ in range(3))
    kp, vp = (rng.standard_normal((N, BS, H, D)).astype(np.float32)
              for _ in range(2))
    tables = np.zeros((s, P), np.int32)
    free = list(range(1, N))
    for i, length in enumerate(lengths):
        n = min(int(length) // BS + 1, P)
        tables[i, :n] = [free.pop() for _ in range(n)]
    return q, kn, vn, kp, vp, tables, np.asarray(lengths, np.int32)


def _to_torch(args, dtype):
    *floats, tables, lengths = args
    return ([torch.from_numpy(a).to(dtype) for a in floats]
            + [torch.from_numpy(tables), torch.from_numpy(lengths)])


def _to_jax(args, dtype):
    *floats, tables, lengths = args
    return ([jnp.asarray(a, dtype) for a in floats]
            + [jnp.asarray(tables), jnp.asarray(lengths)])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("reference", ["jax_gather", "jax_pallas"])
@pytest.mark.parametrize("port", ["wrapper", "stream", "gather"])
def test_port_matches_jax(dtype, reference, port):
    args = _inputs()
    jargs = _to_jax(args, _JAX[dtype])
    if reference == "jax_gather":
        want = jpa.paged_attention_gather(*jargs)
    else:
        want = jpa.paged_attention(*jargs, impl="pallas")
    targs = _to_torch(args, _TORCH[dtype])
    if port == "wrapper":
        got = paged_attention(*targs)
    elif port == "stream":
        got = paged_attention(*targs, impl="torch")
    else:
        got = paged_attention_gather(*targs)
    assert got.dtype == _TORCH[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=_TOL[dtype],
                               rtol=0)


def test_stream_matches_gather_at_boundary_lengths():
    args = _to_torch(_inputs(BOUNDARY, seed=1), torch.float32)
    ref = paged_attention_gather(*args)
    out = paged_attention_stream(*args, scale=1.0 / D ** 0.5)
    np.testing.assert_allclose(out.numpy(), ref.numpy(),
                               atol=FUSED_DECODE_ATOL, rtol=0)


def test_port_gather_tracks_jax_gather_tightly():
    args = _inputs(BOUNDARY, seed=2)
    want = jpa.paged_attention_gather(*_to_jax(args, jnp.float32))
    got = paged_attention_gather(*_to_torch(args, torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_poisoned_null_block_invariance_bitwise(dtype):
    """Null-block content — values big enough to overflow the score
    product — changes nothing, bitwise, at every boundary length."""
    q, kn, vn, kp, vp, tables, lengths = _to_torch(
        _inputs(BOUNDARY, seed=3), _TORCH[dtype])
    pk, pv = kp.clone(), vp.clone()
    pk[0] = 1e30
    pv[0] = 1e30
    a = paged_attention(q, kn, vn, kp, vp, tables, lengths)
    b = paged_attention(q, kn, vn, pk, pv, tables, lengths)
    assert torch.equal(a, b)
    assert bool(torch.isfinite(a.float()).all())


def test_inactive_slot_returns_v_new_exactly():
    q, kn, vn, kp, vp, tables, lengths = _to_torch(
        _inputs((0, 0), seed=4), torch.float32)
    out = paged_attention(q, kn, vn, kp, vp, torch.zeros_like(tables),
                          lengths)
    assert torch.equal(out, vn)


def test_unwritten_tail_of_current_block_is_invisible():
    q, kn, vn, kp, vp, tables, lengths = _to_torch(_inputs(), torch.float32)
    row = 3  # length 17: block 2 holds 16..23; 16 written, 17.. unwritten
    blk = int(tables[row, 2])
    pk, pv = kp.clone(), vp.clone()
    pk[blk, 1:] = 1e30  # from position 17, the first masked position
    pv[blk, 1:] = 1e30
    a = paged_attention(q, kn, vn, kp, vp, tables, lengths)
    b = paged_attention(q, kn, vn, pk, pv, tables, lengths)
    assert torch.equal(a[row], b[row])


def test_shape_validation_is_loud():
    q, kn, vn, kp, vp, tables, lengths = _to_torch(_inputs(), torch.float32)
    with pytest.raises(ValueError, match="queries"):
        paged_attention(q[0], kn, vn, kp, vp, tables, lengths)
    with pytest.raises(ValueError, match="new-token"):
        paged_attention(q, kn[:, :2], vn, kp, vp, tables, lengths)
    with pytest.raises(ValueError, match="pools"):
        paged_attention(q, kn, vn, kp, vp[:-1], tables, lengths)
    with pytest.raises(ValueError, match="head/dim"):
        paged_attention(q, kn, vn, kp[..., :8], vp[..., :8], tables, lengths)
    with pytest.raises(ValueError, match="tables"):
        paged_attention(q, kn, vn, kp, vp, tables[0], lengths)
    with pytest.raises(ValueError, match="lengths"):
        paged_attention(q, kn, vn, kp, vp, tables, lengths[:-1])
    with pytest.raises(ValueError, match="impl"):
        paged_attention(q, kn, vn, kp, vp, tables, lengths, impl="pallas")


def test_no_fallback_off_the_cpu_and_no_cpu_launch_count():
    """Only a CPU tensor takes the plain version; any other device goes
    to the kernel path, which refuses what it cannot run instead of
    computing something else.  CPU calls never count as launches."""
    args = _to_torch(_inputs(), torch.float32)
    paged_attention.launches = 0
    paged_attention(*args)
    assert paged_attention.launches == 0
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention(*meta)
    assert paged_attention.launches == 0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("reference", ["jax_gather", "jax_pallas"])
def test_split_plain_matches_jax(dtype, reference):
    """The plain split-K (the kernel's partition and ordered merge) against
    JAX's gather oracle and its Pallas kernel run interpreted, at length 0,
    either side of a split's edge and a full table row."""
    args = _inputs(SPLIT_EDGES, seed=6)
    jargs = _to_jax(args, _JAX[dtype])
    if reference == "jax_gather":
        want = jpa.paged_attention_gather(*jargs)
    else:
        want = jpa.paged_attention(*jargs, impl="pallas")
    got = paged_attention_split_plain(*_to_torch(args, _TORCH[dtype]),
                                      scale=1.0 / D ** 0.5)
    assert got.dtype == _TORCH[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=_TOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("blocks_per_split", [1, 2, C, P, P + 3])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_split_plain_matches_port_gather(dtype, blocks_per_split):
    """Any split width gives the oracle's answer up to summation order;
    one split covering the whole table is the one-pass softmax."""
    args = _to_torch(_inputs(SPLIT_EDGES, seed=7), _TORCH[dtype])
    want = paged_attention_gather(*args)
    got = paged_attention_split_plain(*args, scale=1.0 / D ** 0.5,
                                      blocks_per_split=blocks_per_split)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=_TOL[dtype],
                               rtol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_split_plain_poisoned_null_block_and_inactive_slot(dtype):
    """Null-block content changes nothing, bitwise; the inactive slot
    (length 0, every entry the null block) returns v_new exactly."""
    q, kn, vn, kp, vp, tables, lengths = _to_torch(
        _inputs(SPLIT_EDGES, seed=8), _TORCH[dtype])
    pk, pv = kp.clone(), vp.clone()
    pk[0] = 1e30
    pv[0] = 1e30
    a = paged_attention_split_plain(q, kn, vn, kp, vp, tables, lengths,
                                    scale=0.25)
    b = paged_attention_split_plain(q, kn, vn, pk, pv, tables, lengths,
                                    scale=0.25)
    assert torch.equal(a, b)
    assert bool(torch.isfinite(a.float()).all())
    assert torch.equal(a[0], vn[0])


def test_split_plain_refuses_an_empty_split():
    args = _to_torch(_inputs(), torch.float32)
    with pytest.raises(ValueError, match="blocks_per_split"):
        paged_attention_split_plain(*args, scale=0.25, blocks_per_split=0)


def test_kernel_split_width_is_the_plain_versions():
    """The CUDA kernel cuts its float32 partials every kBlocksPerSplit
    table blocks; the plain split-K mirrors it only if its default is the
    kernel's constant, read here from the source."""
    text = (CSRC / "paged_attention.cu").read_text()
    widths = re.findall(r"constexpr int kBlocksPerSplit = (\d+);", text)
    assert widths == [str(KERNEL_BLOCKS_PER_SPLIT)]


# ------------------------------------------------------------ decode step


@pytest.fixture(scope="module")
def model():
    dims = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
    jcfg, tcfg = JCfg(**dims), TCfg(**dims)
    jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tcfg, tparams


def _decode_state(lengths, seed):
    pcfg = tkv.PagedCacheConfig(num_blocks=24, block_size=8, blocks_per_seq=6)
    rng = np.random.default_rng(seed)
    shape = (pcfg.num_blocks, pcfg.block_size, 4, 8)
    pools = {kind: [rng.standard_normal(shape).astype(np.float32)
                    for _ in range(2)] for kind in ("k", "v")}
    alloc = tkv.BlockAllocator(pcfg.num_blocks)
    tables = np.zeros((len(lengths), pcfg.blocks_per_seq), np.int32)
    for s, length in enumerate(lengths):
        n = int(length) // pcfg.block_size + 1
        tables[s, :n] = alloc.alloc(n)
    tokens = rng.integers(0, 64, (len(lengths),)).astype(np.int32)
    return pools, tables, np.asarray(lengths, np.int32), tokens


@pytest.mark.parametrize("fused", [False, True])
def test_paged_decode_step_matches_jax(model, fused):
    jcfg, jparams, tcfg, tparams = model
    pools, tables, lengths, tokens = _decode_state((0, 5, 12, 24, 33), 5)
    want, jpools = jkv.paged_decode_step(
        jparams, {k: [jnp.asarray(p) for p in v] for k, v in pools.items()},
        jnp.asarray(tables), jnp.asarray(lengths), jnp.asarray(tokens), jcfg,
        fused=False,
    )
    tpools = {k: [torch.from_numpy(p.copy()) for p in v]
              for k, v in pools.items()}
    got = tkv.paged_decode_step(
        tparams, tpools, torch.from_numpy(tables), torch.from_numpy(lengths),
        torch.from_numpy(tokens), tcfg, fused=fused,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                  np.asarray(want).argmax(-1))
    # the in-place pool writes land where JAX's scatter put them; layer 0's
    # K/V depend only on the embedding, so match to op tolerance
    for kind in ("k", "v"):
        np.testing.assert_allclose(tpools[kind][0].numpy(),
                                   np.asarray(jpools[kind][0]), atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(tpools[kind][1].numpy(),
                                   np.asarray(jpools[kind][1]),
                                   atol=FUSED_DECODE_ATOL, rtol=0)
