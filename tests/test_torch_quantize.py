"""The port's wire codecs (``flextree_tpu_torch/ops/quantize.py``) against
the JAX package's ``ops/quantize.py``, bitwise, on the same seeded numpy
inputs: ``encode_int8``'s payload and scales, ``decode_int8``, every
codec's ``roundtrip``, and ``wire_bytes``, ``hops_for`` and
``error_bound`` exactly, over lengths on and off the block, 2-D
``(w, tile)`` batches (the hash index runs over the padded batch), salts
up to the ring's ``0x52490000 + 7``, the default block and a small one,
all-zero blocks and +-amax; then the port's versions of the JAX
``TestCodecUnits``.  The JAX functions run eagerly, op by op, as the port
does (the suite runs JAX with ``jax_enable_x64``: inputs are explicit
float32 / int32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flextree_tpu.ops import quantize as jq
from flextree_tpu.schedule.stages import LonelyTopology, Topology
from flextree_tpu_torch.ops import quantize as tq

SALTS = (0, 1, 3, 0x41470000, 0x4C4F0000 - 3, 0x4C4F0000 + 16 * 2 + 1,
         0x4C4F0000 + 4096, 0x52490000 - 1, 0x52490000 + 7)
SHAPES = ((4096,), (5000,), (777,), (3, 1030), (8, 256), (2, 16))


def _data(shape, seed, block):
    v = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    v *= 7
    flat = v.reshape(-1, shape[-1])
    flat[0, :min(block, shape[-1])] = 0.0  # an all-zero block
    flat[-1, -1] = np.abs(v).max() * 2  # +amax
    flat[-1, 0] = -flat[-1, -1]  # -amax
    return v


def _bits(a) -> bytes:
    return np.ascontiguousarray(np.asarray(a)).tobytes()


@pytest.mark.parametrize("block", (1024, 16))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_encode_decode_bitwise(shape, block):
    for k, salt in enumerate(SALTS):
        step = (0, 1, 5, 123456, -3, 2**31 - 1)[k % 6]
        v = _data(shape, 10 * k + len(shape), block)
        jqv, jsv = jq.encode_int8(jnp.asarray(v), jnp.int32(step), salt=salt,
                                  block=block)
        q, s = tq.encode_int8(torch.from_numpy(v.copy()), step, salt=salt,
                              block=block)
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert _bits(jqv) == _bits(q.numpy()), (shape, salt, step)
        assert _bits(jsv) == _bits(s.numpy()), (shape, salt, step)
        # a 0-d step tensor keys the same rounding as the int
        q2, _ = tq.encode_int8(torch.from_numpy(v.copy()),
                               torch.tensor(step, dtype=torch.int32),
                               salt=salt, block=block)
        assert torch.equal(q, q2)
        for length in (shape[-1], None):
            assert _bits(jq.decode_int8(jqv, jsv, length, block=block)) == \
                _bits(tq.decode_int8(q, s, length, block=block).numpy())


def test_uniforms_bitwise_and_batch_is_not_rows_one_at_a_time():
    for salt in SALTS:
        for step in (0, 7, -1):
            want = np.asarray(jq._uniform01(3000, jnp.int32(step), salt))
            got = tq._uniform01(3000, step, salt).numpy()
            assert _bits(want) == _bits(got)
            assert ((got >= 0) & (got < 1)).all()
    v = torch.from_numpy(_data((2, 1030), 3, 1024))
    q, _ = tq.encode_int8(v, 2)
    rows = torch.cat([tq.encode_int8(r, 2)[0] for r in v])
    assert not torch.equal(q.reshape(-1), rows)


@pytest.mark.parametrize("name", ("f32", "bf16", "int8"))
def test_roundtrip_bitwise(name):
    for shape in SHAPES:
        v = _data(shape, 1, 1024)
        want = jq.get_codec(name).roundtrip(jnp.asarray(v), jnp.int32(4),
                                            salt=3)
        got = tq.get_codec(name).roundtrip(torch.from_numpy(v.copy()), 4,
                                           salt=3)
        assert got.shape == v.shape and got.dtype == torch.float32
        assert _bits(want) == _bits(got.numpy()), shape


def test_codec_fields_and_accounting_equal():
    assert set(tq.CODECS) == set(jq.CODECS)
    for name, c in tq.CODECS.items():
        j = jq.CODECS[name]
        assert (c.name, c.wire_ratio, c.lossy, c.hop_cost, c.block) == \
            (j.name, j.wire_ratio, j.lossy, j.hop_cost, j.block)
        for n_elems in (0, 1, 1023, 1024, 1025, 16_781_824):
            assert c.wire_bytes(n_elems) == j.wire_bytes(n_elems)
        for n, spec in ((8, "8"), (8, "4,2"), (8, "2,2,2"), (8, "1"),
                        (7, "3,2+1"), (8, "7+1"), (2, "2"), (1, None)):
            t = Topology.resolve(n, spec)
            widths, lonely = (t.tree.widths, t.lonely) \
                if isinstance(t, LonelyTopology) else (t.widths, 0)
            for w in (widths, None):
                assert c.hops_for(n, w, lonely) == j.hops_for(n, w, lonely)
                assert c.error_bound(2.5, n, w, lonely) == \
                    j.error_bound(2.5, n, w, lonely)


def test_flagship_wire_bytes():
    """The int8 wire of the flagship's gradient (16,781,824 float32 a
    rank) against float32's."""
    c = tq.get_codec("int8")
    assert c.wire_bytes(16_781_824) == 16_847_892
    assert tq.get_codec("f32").wire_bytes(16_781_824) == 67_127_296


# ------------------------------------------- the JAX TestCodecUnits, ported


def test_registry():
    assert set(tq.CODECS) == {"f32", "bf16", "int8"}
    assert not tq.get_codec("f32").lossy
    assert tq.get_codec(None).name == "f32"
    assert tq.get_codec(tq.get_codec("int8")).name == "int8"
    for bad in ("fp4", "identity"):
        with pytest.raises(ValueError, match="unsupported codec"):
            tq.get_codec(bad)


def test_int8_roundtrip_error_within_one_step():
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.standard_normal(5000).astype(np.float32) * 7)
    q, s = tq.encode_int8(v, step=3)
    out = tq.decode_int8(q, s, v.shape[0])
    blocks = torch.nn.functional.pad(v, (0, q.shape[0] - v.shape[0]))
    scales = blocks.view(-1, 1024).abs().amax(1) / 127.0
    err = (out - v).abs()
    assert (err <= scales.repeat_interleave(1024)[:5000] + 1e-7).all()


def test_int8_deterministic_in_step():
    v = torch.from_numpy(
        np.random.default_rng(1).standard_normal(2048).astype(np.float32))
    q1, _ = tq.encode_int8(v, step=5)
    q2, _ = tq.encode_int8(v, step=5)
    q3, _ = tq.encode_int8(v, step=6)
    assert torch.equal(q1, q2) and not torch.equal(q1, q3)


def test_zeros_and_pad_are_exact():
    q, s = tq.encode_int8(torch.zeros(1500), step=0)
    assert q.max() == 0
    out = tq.decode_int8(q, s, 1500)
    assert out.shape == (1500,) and not out.any()


def test_roundtrip_maps():
    v = torch.from_numpy(
        np.random.default_rng(2).standard_normal(1000).astype(np.float32))
    assert torch.equal(tq.get_codec("f32").roundtrip(v), v)
    bf = tq.get_codec("bf16").roundtrip(v)
    assert bf.dtype == v.dtype
    assert (bf - v).abs().max() <= v.abs().max() * 2 ** -8


def test_error_bound_hops():
    c = tq.get_codec("int8")
    assert c.hops_for(8, (4, 2)) == 3
    assert c.hops_for(8, (1,)) == 8
    assert c.hops_for(8, (7,), lonely=1) == 4
    assert tq.get_codec("f32").error_bound(10.0, 8, (4, 2)) == 0.0
    assert c.error_bound(1.0, 8, (4, 2)) == pytest.approx(3 * 8 / 127.0)
