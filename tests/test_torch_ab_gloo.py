"""The port's A/B drivers over a 2-process gloo world on the CPU, at tiny
sizes: ``tools.bench_quantize``, ``tools.bench_sharded`` and
``tools.bench_overlap`` run once each, their reports carrying the JAX
tools' keys, their correctness checks holding, and the sharded world's
per-rank wire bytes the same schedule's bytes on an in-process mesh.
Timing floors are recorded, never asserted (``--quick``)."""

from __future__ import annotations

import numpy as np
import torch
from test_torch_bench_tools import jax_dict_keys
from test_torch_chaos_drivers import no_open_sockets  # noqa: F401

from flextree_tpu_torch.parallel.mesh import flat_mesh
from flextree_tpu_torch.parallel.train import (
    TrainConfig,
    init_train_state,
    make_train_step,
)
from flextree_tpu_torch.tools import bench_overlap as bo
from flextree_tpu_torch.tools import bench_quantize as bq
from flextree_tpu_torch.tools import bench_sharded as bs

TINY = dict(vocab_size=256, d_model=32, n_heads=4, n_layers=2, d_ff=64)


def nested_jax_keys(tool: str, key: str) -> set:
    """Keys of the dict literal under ``key`` inside the JAX tool's
    ``doc = {...}``."""
    import ast
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "tools", f"{tool}.py"),
              encoding="utf-8") as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(ast.unparse(t) == "doc" for t in node.targets):
            for k, v in zip(node.value.keys, node.value.values):
                if k is not None and k.value == key and \
                        isinstance(v, ast.Dict):
                    return {kk.value for kk in v.keys}
    return set()


def test_quantize_world_runs_with_every_check(no_open_sockets):  # noqa: F811
    doc = bq.run_bench(quick=True, device="cpu", sizes=(1 << 12, 1 << 13),
                       repeat=2, inproc_leaf=1 << 10, log=lambda m: None)
    assert jax_dict_keys("bench_quantize", "doc") <= set(doc)
    assert nested_jax_keys("bench_quantize", "headline") == \
        set(doc["headline"])
    assert doc["violations"] == []
    for sec in doc["cross_process"].values():
        assert set(sec["rows"]) == {"plain_f32", *bq.CODECS}
        assert all(sec["checks"][k] for k in (
            "identity_bitwise", "f32_exact", "bf16_within_bound",
            "int8_within_bound"))
        rows = sec["rows"]
        # the wire: f32 the plain allreduce's bytes, bf16 half, int8 less
        # (a quarter and its scales, each tile padded to whole blocks)
        assert rows["f32"]["wire_bytes"] == rows["plain_f32"]["wire_bytes"]
        assert rows["bf16"]["wire_bytes"] * 2 == rows["f32"]["wire_bytes"]
        assert rows["int8"]["wire_bytes"] < rows["bf16"]["wire_bytes"]
    assert {"ours_fused_bf16", "ours_fused_int8"} <= \
        set(doc["in_process"]["rows"])


def test_sharded_world_runs_with_every_floor(no_open_sockets):  # noqa: F811
    doc = bs.run_bench(quick=True, device="cpu", widths=TINY,
                       sync_sizes=(1 << 10,), repeat=2, steps_n=2,
                       log=lambda m: None)
    assert jax_dict_keys("bench_sharded", "doc") <= set(doc)
    assert nested_jax_keys("bench_sharded", "headline") == \
        set(doc["headline"])
    assert doc["violations"] == []
    h = doc["headline"]
    assert h["wire_ratio_f32_vs_replicated_f32"] == 1.0
    assert h["wire_ratio_int8_vs_replicated_f32"] <= bs.MAX_WIRE_RATIO
    assert h["bitwise_f32_in_run"] and h["opt_state_ratio"] == 0.5
    for name, want in doc["opt_state_analytic"].items():
        assert doc["opt_state_bytes"][name] == want["sharded_bytes_per_rank"]
    # the gloo ranks' bytes are the same steps' bytes on a 2-rank mesh
    cfg = bs.model_config("cpu", TINY)
    mesh = flat_mesh(2, "cpu", "dp")
    toks = torch.as_tensor(bs._tokens(2, cfg.vocab_size))
    for name, kw in (("replicated_f32", {}),
                     ("sharded_f32", dict(shard_optimizer=True)),
                     ("sharded_int8", dict(shard_optimizer=True,
                                           codec="int8"))):
        tc = TrainConfig(grad_topo="2", **kw)
        st = init_train_state(cfg, torch.Generator().manual_seed(0), tc,
                              device="cpu", comm=mesh)
        got = bs.step_wire(make_train_step(cfg, tc, comm=mesh), st, toks)[1]
        for rank, by_name in enumerate(doc["wire_bytes_by_rank"]):
            assert by_name[name] == got["bytes"][rank], (name, rank)


def test_overlap_world_runs_with_every_correctness_check(
        no_open_sockets):  # noqa: F811
    doc = bo.run_bench(quick=True, device="cpu",
                       widths=dict(TINY, n_layers=3), rounds=4, n_blocks=1,
                       inproc_model=dict(vocab_size=64, d_model=32,
                                         n_heads=4, d_ff=64),
                       log=lambda m: None)
    assert jax_dict_keys("bench_overlap", "doc") <= set(doc)
    assert nested_jax_keys("bench_overlap", "headline") <= set(doc["headline"])
    xp = doc["cross_process"]
    assert jax_dict_keys("bench_overlap", "result") <= set(xp)
    assert jax_dict_keys("bench_overlap", "blocks.append") <= \
        set(xp["blocks"][0])
    assert doc["violations"] == []
    assert all(xp["bitwise"].values()) and xp["plan"]["n_buckets"] >= 2
    for counts in xp["collective_counts_by_rank"]:
        assert counts["ours_overlapped"] == counts["ours_overlap_serialized"]
    # pinned a core a rank where the host has two
    assert xp["pinned"] == (len(xp["cores_by_rank"]) == 2)
    if xp["pinned"]:
        assert [len(c) for c in xp["cores_by_rank"]] == [1, 1]
        assert xp["cores_by_rank"][0] != xp["cores_by_rank"][1]
    assert np.isfinite(doc["headline"]["exposed_comm_reduction"])
    assert doc["in_process"]["identical"]


def _agree(rank, world):
    # each rank's own "measurement", then the one every rank plans with
    return bo.agreed(100.0 + rank, 2.5 * (rank + 1), f"rank{rank}")


def test_overlap_ranks_plan_from_rank_zeros_calibration():
    from flextree_tpu_torch.parallel.launch import spawn

    assert spawn(_agree, 2, timeout=60) == [[100.0, 2.5, "rank0"]] * 2
