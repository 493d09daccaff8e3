"""The port's KV migration wire format, block export/import and the
serving cost planner, held against the JAX package on the CPU.

- ``pack_kv``'s meta and blob are the JAX packer's, byte for byte, for the
  f32 and int8 codecs at several block counts and two geometries; each
  package unpacks the other's payload to the same values;
- ``migration_error_bound`` agrees; int8 stays inside it; poisoned
  payloads are refused with ``FT_MIGRATION_REFUSED``;
- ``export_blocks`` / ``write_imported`` move the blocks the JAX pair
  moves, in place, leaving every other block's bits alone;
- every function of ``serving/costs.py`` returns what JAX's returns under
  the same ``TpuCostParams`` values, the crossover included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flextree_tpu.models.transformer import TransformerConfig as JCfg
from flextree_tpu.planner.cost_model import LinkParams as JLink
from flextree_tpu.planner.cost_model import TpuCostParams as JParams
from flextree_tpu.serving import costs as jcosts
from flextree_tpu.serving.kv_cache import PagedCacheConfig as JPcfg
from flextree_tpu.serving.kv_cache import export_blocks as j_export
from flextree_tpu.serving.kv_cache import write_imported as j_import
from flextree_tpu.serving.migration import migration_error_bound as j_bound
from flextree_tpu.serving.migration import pack_kv as j_pack
from flextree_tpu.serving.migration import unpack_kv as j_unpack
from flextree_tpu_torch.models.transformer import TransformerConfig as TCfg
from flextree_tpu_torch.planner.cost_model import LinkParams as TLink
from flextree_tpu_torch.planner.cost_model import TpuCostParams as TParams
from flextree_tpu_torch.serving import (
    MigrationError,
    PagedCacheConfig,
    export_blocks,
    migration_error_bound,
    pack_kv,
    unpack_kv,
    write_imported,
)
from flextree_tpu_torch.serving import costs as tcosts

# (block_size, heads, head_dim, layers): the JAX test's toy geometry and
# the flagship's per-layer block shape
GEOMETRIES = [(4, 2, 16, 2), (16, 8, 64, 2)]


def _rand_kv(rng, n_blocks, bs=4, heads=2, dh=16, layers=2):
    shape = (n_blocks, bs, heads, dh)
    return {
        kind: [rng.standard_normal(shape).astype(np.float32)
               for _ in range(layers)]
        for kind in ("k", "v")
    }


def _same_values(a: dict, b: dict) -> bool:
    return all(
        np.array_equal(np.asarray(x), np.asarray(y))
        for kind in ("k", "v") for x, y in zip(a[kind], b[kind])
    )


# ---------------------------------------------------------------- the wire


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=["toy", "flagship"])
@pytest.mark.parametrize("n_blocks", [1, 2, 5])
@pytest.mark.parametrize("codec", ["f32", "int8"])
def test_pack_kv_bytes_are_the_jax_packers(codec, n_blocks, geometry):
    bs, heads, dh, layers = geometry
    rng = np.random.default_rng(n_blocks * 10 + bs)
    kv = _rand_kv(rng, n_blocks, bs, heads, dh, layers)
    meta, blob = pack_kv(kv, codec=codec)
    j_meta, j_blob = j_pack(kv, codec=codec)
    assert meta == j_meta
    assert blob == j_blob
    assert meta["n_blocks"] == n_blocks and meta["codec"] == codec


@pytest.mark.parametrize("codec", ["f32", "int8"])
def test_each_package_unpacks_the_others_payload(codec):
    rng = np.random.default_rng(1)
    kv = _rand_kv(rng, 3)
    t_meta, t_blob = pack_kv(kv, codec=codec)
    j_meta, j_blob = j_pack(kv, codec=codec)
    port_of_jax = unpack_kv(j_meta, j_blob)
    jax_of_port = j_unpack(t_meta, t_blob)
    assert _same_values(port_of_jax, jax_of_port)
    assert _same_values(port_of_jax, j_unpack(j_meta, j_blob))
    for arr in port_of_jax["k"] + port_of_jax["v"]:
        assert arr.dtype == np.float32 and arr.flags.writeable
    if codec == "f32":
        assert _same_values(port_of_jax, kv)


@pytest.mark.parametrize("codec", ["f32", "int8"])
def test_error_bound_agrees_and_holds(codec):
    rng = np.random.default_rng(7)
    kv = _rand_kv(rng, 3)
    meta, blob = pack_kv(kv, codec=codec)
    bound = migration_error_bound(meta)
    assert bound == j_bound(j_pack(kv, codec=codec)[0])
    out = unpack_kv(meta, blob)
    worst = max(float(np.max(np.abs(a - b)))
                for kind in ("k", "v") for a, b in zip(kv[kind], out[kind]))
    if codec == "f32":
        assert bound == 0.0 and worst == 0.0
    else:
        assert 0.0 < worst <= bound
        assert len(blob) < len(pack_kv(kv, codec="f32")[1])


def test_unknown_and_non_migration_codecs_refused():
    kv = _rand_kv(np.random.default_rng(0), 1)
    with pytest.raises(ValueError):
        pack_kv(kv, codec="fp4")
    with pytest.raises(MigrationError, match="not a migration codec"):
        pack_kv(kv, codec="bf16")


@pytest.mark.parametrize("codec", ["f32", "int8"])
def test_poisoned_payloads_refused(codec):
    """The JAX test's poisons (a flipped byte, truncation, a shape lie, a
    layer-count lie), plus a duplicated tensor entry and a tensor CRC that
    disagrees with its bytes; every refusal carries the JAX code."""
    kv = _rand_kv(np.random.default_rng(3), 2)
    meta, blob = pack_kv(kv, codec=codec)
    torn = bytearray(blob)
    torn[len(torn) // 2] ^= 0x40
    poisons = [
        (meta, bytes(torn)),
        (meta, blob[:-8]),
        (dict(meta, n_blocks=3), blob),
        (dict(meta, n_layers=1), blob),
        (dict(meta, tensors=[meta["tensors"][0]] * 4), blob),
        (dict(meta, tensors=[dict(meta["tensors"][0], crc32=0)]
              + meta["tensors"][1:]), blob),
        ({k: v for k, v in meta.items() if k != "codec"}, blob),
    ]
    for bad_meta, bad_blob in poisons:
        with pytest.raises(MigrationError) as ei:
            unpack_kv(bad_meta, bad_blob)
        assert ei.value.code == "FT_MIGRATION_REFUSED"
        assert str(ei.value).startswith("FT_MIGRATION_REFUSED")
        # and the JAX package refuses the same payload
        with pytest.raises(Exception):
            j_unpack(bad_meta, bad_blob)


# ----------------------------------------------------- block export/import


def test_export_import_match_the_jax_pair():
    rng = np.random.default_rng(11)
    shape = (8, 4, 2, 16)
    src = {kind: [rng.standard_normal(shape).astype(np.float32)
                  for _ in range(2)] for kind in ("k", "v")}
    dst = {kind: [rng.standard_normal(shape).astype(np.float32)
                  for _ in range(2)] for kind in ("k", "v")}
    ids = [5, 2, 7]
    t_src = {k: [torch.from_numpy(a.copy()) for a in v] for k, v in src.items()}
    t_dst = {k: [torch.from_numpy(a.copy()) for a in v] for k, v in dst.items()}
    kv = export_blocks(t_src, ids)
    j_kv = j_export({k: [jnp.asarray(a) for a in v] for k, v in src.items()},
                    ids)
    assert _same_values(kv, j_kv)
    # a copy, never a view of the pool
    kv["k"][0].fill_(0.0)
    assert np.array_equal(t_src["k"][0].numpy(), src["k"][0])
    kv = export_blocks(t_src, ids)
    out = write_imported(t_dst, kv, ids)
    assert out is t_dst  # in place
    j_out = j_import({k: [jnp.asarray(a) for a in v] for k, v in dst.items()},
                     j_kv, ids)
    assert _same_values(t_dst, j_out)
    others = [i for i in range(8) if i not in ids]
    for kind in ("k", "v"):
        for before, after in zip(dst[kind], t_dst[kind]):
            np.testing.assert_array_equal(after.numpy()[others],
                                          before[others])


def test_import_casts_to_the_pool_dtype_and_refuses_shapes():
    rng = np.random.default_rng(2)
    pools = {kind: [torch.zeros((6, 4, 2, 8), dtype=torch.bfloat16)]
             for kind in ("k", "v")}
    vals = torch.from_numpy(rng.standard_normal((2, 4, 2, 8)).astype(
        np.float32)).to(torch.bfloat16)
    # a bfloat16 pool's blocks travel as float32 and land bit for bit
    write_imported(pools, {"k": [vals.float()], "v": [vals.float()]}, [3, 1])
    assert torch.equal(pools["k"][0][[3, 1]], vals)
    assert torch.equal(pools["v"][0][[3, 1]], vals)
    bad = {kind: [torch.zeros((2, 4, 2, 4))] for kind in ("k", "v")}
    with pytest.raises(ValueError, match="expected"):
        write_imported(pools, bad, [1, 2])
    with pytest.raises(ValueError, match="expected"):
        write_imported(pools, {"k": [vals.float()], "v": [vals.float()]},
                       [1, 2, 3])


# ------------------------------------------------------------ the planner

DIMS = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64)
CACHE = dict(num_blocks=40, block_size=4, blocks_per_seq=8)
PARAMS = dict(reduce_bw_GBps=123.0, codec_bw_GBps=45.0, bwd_GFLOPs=77.0)
LINK = dict(bandwidth_GBps=3.5, latency_us=40.0)


def _both(dtype="f32", bwd=True):
    kw = dict(PARAMS, bwd_GFLOPs=PARAMS["bwd_GFLOPs"] if bwd else 0.0)
    jp = JParams(dcn=JLink(**LINK), ici=JLink(**LINK), **kw)
    tp = TParams(dcn=TLink(**LINK), ici=TLink(**LINK), **kw)
    jcfg = JCfg(**DIMS, dtype=jnp.bfloat16 if dtype == "bf16"
                else jnp.float32)
    tcfg = TCfg(**DIMS, dtype=torch.bfloat16 if dtype == "bf16"
                else torch.float32)
    return (jcfg, JPcfg(**CACHE), jp), (tcfg, PagedCacheConfig(**CACHE), tp)


COST_CASES = {
    "decode_round_flops": lambda m, c, p, k: m.decode_round_flops(c, 3, 17),
    "decode_round_bytes": lambda m, c, p, k: m.decode_round_bytes(c, p, 3, 5),
    "predict_decode_round_us": lambda m, c, p, k: m.predict_decode_round_us(
        c, p, 3, 17, k),
    "predict_decode_round_us_idle": lambda m, c, p, k:
        m.predict_decode_round_us(c, p, 0, 17, k),
    "predict_prefill_us": lambda m, c, p, k: m.predict_prefill_us(c, 13, k),
    "predict_prefill_us_cached": lambda m, c, p, k: m.predict_prefill_us(
        c, 13, k, cached_tokens=8),
    "kv_migration_elems": lambda m, c, p, k: m.kv_migration_elems(c, p, 9),
    "predict_migration_us_f32": lambda m, c, p, k: m.predict_migration_us(
        c, p, 9, "f32", k),
    "predict_migration_us_int8": lambda m, c, p, k: m.predict_migration_us(
        c, p, 9, "int8", k),
    "plan_migration": lambda m, c, p, k: [
        m.plan_migration(c, p, t, codec, k)
        for t in (1, 5, 17, 32) for codec in ("f32", "int8")],
    "migration_crossover_tokens": lambda m, c, p, k: [
        m.migration_crossover_tokens(c, p, codec, k)
        for codec in ("f32", "int8")],
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(COST_CASES))
def test_cost_functions_equal_jax_under_the_same_params(case, dtype):
    (jc, jpc, jp), (tc, tpc, tp) = _both(dtype)
    fn = COST_CASES[case]
    assert fn(tcosts, tc, tpc, tp) == fn(jcosts, jc, jpc, jp)


def test_default_rate_on_the_cpu_is_the_jax_hosts():
    """With ``bwd_GFLOPs`` left at 0 the rate comes from the device: the
    CPU's is the JAX package's host figure, so the CPU crossover agrees."""
    (jc, jpc, jp), (tc, tpc, tp) = _both(bwd=False)
    assert tcosts.predict_prefill_us(tc, 13, tp, device="cpu") == \
        jcosts.predict_prefill_us(jc, 13, jp)
    got = tcosts.migration_crossover_tokens(tc, tpc, "int8", tp,
                                            device="cpu")
    assert got == jcosts.migration_crossover_tokens(jc, jpc, "int8", jp)
    assert got is not None and 1 < got <= tpc.max_len
    assert not tcosts.plan_migration(tc, tpc, got - 1, "int8", tp,
                                     device="cpu")["migrate"]
    assert tcosts.plan_migration(tc, tpc, got, "int8", tp,
                                 device="cpu")["migrate"]


@pytest.mark.parametrize("codec", ["f32", "int8"])
def test_priced_wire_bytes_are_the_packers(codec):
    """The planner prices the bytes ``pack_kv`` puts on the wire."""
    _, (tc, tpc, tp) = _both()
    rng = np.random.default_rng(9)
    for plen in (3, 8, 13):
        kv = _rand_kv(rng, tpc.blocks_for(plen), tpc.block_size,
                      tc.n_heads, tc.head_dim, tc.n_layers)
        priced = tcosts.predict_migration_us(tc, tpc, plen, codec, tp,
                                             )["bytes_on_wire"]
        assert priced == len(pack_kv(kv, codec=codec)[1])
