"""The transports' per-rank message and byte counters
(``parallel/allreduce.py``: ``WireCounters``, ``counting_wire``) against
the JAX package's static count of the same programs
(``analysis.hlo_lint.collective_wire_bytes`` and ``collective_counts``):

- a mesh and a 2-process gloo world count one schedule alike;
- the port's replicated, sharded and int8 sharded train steps on 2 ranks
  send exactly the bytes the JAX steps lowered over 2 devices carry in
  their collectives, but the loss's 4-byte ``all_reduce`` (the port sums
  the loss outside the transports): the f32 ratio is exactly 1.0 on both
  sides and the int8 ratio differs by that term alone;
- ``bench_sharded``'s wire floors catch an uncompressed sharded wire and
  ``bench_overlap``'s equal-counts check an extra message.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flextree_tpu_torch.models.transformer import TransformerConfig
from flextree_tpu_torch.ops.quantize import get_codec
from flextree_tpu_torch.parallel import allreduce as ar
from flextree_tpu_torch.parallel import zero
from flextree_tpu_torch.parallel.launch import spawn
from flextree_tpu_torch.parallel.mesh import flat_mesh
from flextree_tpu_torch.parallel.train import (
    TrainConfig,
    init_train_state,
    make_train_step,
)
from flextree_tpu_torch.tools import bench_overlap as bo
from flextree_tpu_torch.tools import bench_sharded as bs

WIDTHS = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)
BATCH = (4, 16)
VARIANTS = {
    "replicated_f32": dict(grad_topo="2"),
    "sharded_f32": dict(grad_topo="2", shard_optimizer=True),
    "sharded_int8": dict(grad_topo="2", shard_optimizer=True, codec="int8"),
}


@pytest.fixture(scope="module")
def jax_wire():
    """``collective_wire_bytes`` of the JAX steps on a (2, 1, 1) mesh."""
    from flextree_tpu.analysis.hlo_lint import collective_wire_bytes
    from flextree_tpu.models.transformer import TransformerConfig as JCfg
    from flextree_tpu.parallel.train import TrainConfig as JTC
    from flextree_tpu.parallel.train import init_train_state as jinit
    from flextree_tpu.parallel.train import make_mesh_nd
    from flextree_tpu.parallel.train import make_train_step as jstep

    cfg = JCfg(**WIDTHS)
    mesh = make_mesh_nd(2, (2, 1, 1), ("dp", "sp", "tp"))
    tok = jax.ShapeDtypeStruct(BATCH, jnp.int32)
    out = {}
    for name, kw in VARIANTS.items():
        tc = JTC(**kw)
        sds = jax.eval_shape(lambda k, tc=tc: jinit(k, cfg, tc, mesh=mesh),
                             jax.random.PRNGKey(0))
        ir = jstep(mesh, cfg, tc).lower(sds, tok, tok).as_text()
        out[name] = collective_wire_bytes(ir)
    return out


def port_steps(variants=VARIANTS):
    """``{name: (step, state)}`` of the port's steps on a 2-rank mesh."""
    cfg = TransformerConfig(**WIDTHS)
    mesh = flat_mesh(2, "cpu", "dp")
    out = {}
    for name, kw in variants.items():
        tc = TrainConfig(**kw)
        out[name] = (make_train_step(cfg, tc, comm=mesh),
                     init_train_state(cfg, torch.Generator().manual_seed(0),
                                      tc, device="cpu", comm=mesh))
    return out


def tokens():
    return torch.as_tensor(np.random.default_rng(0).integers(
        0, WIDTHS["vocab_size"], BATCH).astype(np.int32))


@pytest.fixture(scope="module")
def port_wire():
    toks = tokens()
    return {name: bs.step_wire(step, st, toks)[1]
            for name, (step, st) in port_steps().items()}


def test_counting_resets_and_reads_per_rank():
    m = flat_mesh(2, "cpu", "ft")
    x = [torch.randn(1000) for _ in range(2)]
    ar.allreduce(x, m, topo="2")
    with ar.counting_wire() as w:
        ar.allreduce(x, m, topo="2")
    # a tile of 500 f32 read by the partner's fold, and one gathered back
    assert w.read() == {"messages": {0: 2, 1: 2}, "bytes": {0: 4000, 1: 4000}}
    # counting stops with the block: a later collective adds nothing
    assert not w.on
    ar.allreduce(x, m, topo="2")
    assert w.read() == {"messages": {0: 2, 1: 2}, "bytes": {0: 4000, 1: 4000}}
    w.reset()
    assert w.read() == {"messages": {}, "bytes": {}}


def _dist_counts(rank, world, count):
    x = torch.from_numpy(np.random.default_rng(rank).standard_normal(
        count).astype(np.float32))
    out = {}
    for name, fn in (
            ("allreduce", lambda: ar.allreduce(x, None, topo="2")),
            ("split_int8", lambda: ar.all_gather(
                ar.reduce_scatter(x, None, topo="2", codec="int8"), None,
                topo="2", out_shape=x.shape, codec="int8"))):
        with ar.counting_wire() as w:
            fn()
        got = w.read()
        out[name] = (got["messages"][rank], got["bytes"][rank])
    return out


def test_a_mesh_and_a_gloo_world_count_one_schedule_alike():
    count = 1003
    dist = spawn(_dist_counts, 2, (count,), timeout=60)
    m = flat_mesh(2, "cpu", "ft")
    x = [torch.randn(count) for _ in range(2)]
    for name, fn in (
            ("allreduce", lambda: ar.allreduce(x, m, topo="2")),
            ("split_int8", lambda: ar.all_gather(
                ar.reduce_scatter(x, m, topo="2", codec="int8"), m,
                topo="2", out_shape=(count,), codec="int8"))):
        with ar.counting_wire() as w:
            fn()
        got = w.read()
        for r in range(2):
            assert dist[r][name] == (got["messages"][r], got["bytes"][r]), \
                (name, r)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_step_bytes_are_the_jax_collective_bytes(name, jax_wire, port_wire):
    j, p = jax_wire[name], port_wire[name]
    # the JAX step's only all_reduce is the loss's f32 scalar (4 bytes a
    # chip); the port sums the loss outside the transports
    assert j["all_reduce"] == 4.0
    for rank in (0, 1):
        assert p["bytes"][rank] == j["total"] - j["all_reduce"]


def test_wire_ratios_hold_against_the_jax_count(jax_wire, port_wire):
    def ratio(wire, name, key):
        return wire[name][key] / wire["replicated_f32"][key]

    jt = {k: {"total": v["total"]} for k, v in jax_wire.items()}
    pt = {k: {"total": v["bytes"][0]} for k, v in port_wire.items()}
    # f32: the seam relocates the all-gather; exactly 1.0 on both sides
    assert ratio(jt, "sharded_f32", "total") == 1.0
    assert ratio(pt, "sharded_f32", "total") == 1.0
    # int8: the one term that differs is the loss's 4-byte all_reduce,
    # which moves the JAX ratio toward 1 by at most 4 / replicated bytes
    p8, j8 = ratio(pt, "sharded_int8", "total"), ratio(jt, "sharded_int8",
                                                       "total")
    assert p8 <= j8 <= p8 + 4.0 / jt["replicated_f32"]["total"]
    assert p8 <= bs.MAX_WIRE_RATIO
    assert bs.wire_violations(p8, ratio(pt, "sharded_f32", "total")) == []


def test_wire_ratio_catches_an_uncompressed_sharded_wire(monkeypatch,
                                                          port_wire):
    real = zero._rs_wire

    def uncompressed(ranks, fused, topo, codec, step):
        # the int8 step's reduce-scatter on the f32 wire, zero residual
        shards, _ = real(ranks, fused, topo, get_codec("f32"), step)
        return shards, [torch.zeros_like(f) for f in fused]

    monkeypatch.setattr(zero, "_rs_wire", uncompressed)
    steps = port_steps({"sharded_int8": VARIANTS["sharded_int8"]})
    step, st = steps["sharded_int8"]
    got = bs.step_wire(step, st, tokens())[1]
    ratio = got["bytes"][0] / port_wire["replicated_f32"]["bytes"][0]
    assert ratio > bs.MAX_WIRE_RATIO
    assert any("sharded-int8 wire bytes" in v
               for v in bs.wire_violations(ratio, 1.0))


def _overlap_counts(extra: bool = False) -> dict:
    """Messages a rank of one overlapped and one serialized step on a
    2-rank mesh; ``extra`` sends one more message in the overlapped
    step (a mutation)."""
    cfg = TransformerConfig(**WIDTHS)
    mesh = flat_mesh(2, "cpu", "dp")
    tc = TrainConfig(overlap=True)
    st = init_train_state(cfg, torch.Generator().manual_seed(0),
                          device="cpu")
    toks = tokens()
    out = {}
    for name, twin in (("ours_overlapped", False),
                       ("ours_overlap_serialized", True)):
        step = make_train_step(cfg, tc, comm=mesh, serialize_overlap=twin)
        with ar.counting_wire() as w:
            step(st, toks, toks)
            if extra and not twin:
                # one message a rank: each reads the other's element
                ar.dense_allreduce([torch.ones(1), torch.ones(1)], mesh)
        out[name] = {"messages": w.read()["messages"][0],
                     "bytes": w.read()["bytes"][0]}
    return out


def _scored(counts) -> list:
    block = {"exposed_med_ms": {"ours_overlap_serialized": 2.0,
                                "ours_overlapped": 1.0}}
    xproc = {"blocks": [block], "bitwise": {"ours_overlapped": True},
             "collective_counts_by_rank": [counts],
             "plan": {"n_buckets": 2}}
    return bo.score(xproc, quick=True)[0]


def test_overlapped_and_serialized_steps_send_equal_counts():
    counts = _overlap_counts()
    assert counts["ours_overlapped"] == counts["ours_overlap_serialized"]
    assert counts["ours_overlapped"]["messages"] > 0
    assert _scored(counts) == []


def test_equal_counts_check_catches_an_extra_message():
    counts = _overlap_counts(extra=True)
    assert counts["ours_overlapped"]["messages"] == \
        counts["ours_overlap_serialized"]["messages"] + 1
    assert any("collective counts differ" in v for v in _scored(counts))
