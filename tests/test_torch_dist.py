"""The port's collectives over ``torch.distributed`` (multi-process gloo on
the CPU), against the in-process mesh and the JAX package's simulator.

One spawn per world size (2, 4, 7, 8) runs every case inside the workers
(``bench.harness.dist_allreduce_cases``); each rank reports digests of its
allreduce result, its ``reduce_scatter`` shard and the ``all_gather`` of
that shard.  Held, bitwise: every rank's result is the in-process mesh's,
every rank's shard is the mesh's shard of that rank, the gathered shard is
the allreduce, and integer ops are the simulator's; the IR families
(``swing``, ``gen:2,2@1``, sums only) on 4 ranks: every rank's allreduce
is the mesh's, each sender's block crossing the wire.  Also: the bench in
``dist`` mode, and a bring-up against an absent coordinator, which raises
``BringupTimeout`` within its budget.  Every spawn has a deadline, kills
stragglers and destroys its process groups."""

import time

import numpy as np
import pytest
import torch

from flextree_tpu.backends import simulate_allreduce as j_simulate
from flextree_tpu_torch.bench.harness import (
    BenchConfig,
    digest,
    dist_allreduce_cases,
    dist_bench,
    seeded_rows,
    torch_dtype,
)
from flextree_tpu_torch.parallel import allreduce as tar
from flextree_tpu_torch.parallel import launch
from flextree_tpu_torch.parallel.mesh import flat_mesh
from flextree_tpu_torch.schedule.ir import is_ir_family_spec

SPECS = {2: ("2", "1"), 4: ("4", "2,2", "1", "3+1", "swing", "gen:2,2@1"),
         7: ("7", "1", "3,2+1"), 8: ("8", "4,2", "2,4", "2,2,2", "1")}
OPS = (("sum", "float32"), ("sum", "bfloat16"), ("bxor", "int32"),
       ("max", "float64"), ("sum", "uint16"), ("band", "bool"))


def cases(world):
    """Every spec x count x op x dtype; the IR families (swing,
    generalized) run ``op="sum"`` only."""
    return [(spec, count, op, dt, 11 * count + world, chunks)
            for spec in SPECS[world] for count in (1, 35, 64)
            for op, dt in OPS if op == "sum" or not is_ir_family_spec(spec)
            for chunks in ((1, 3) if "," in spec else (1,))]


@pytest.mark.parametrize("world", sorted(SPECS))
def test_dist_equals_the_mesh_on_every_rank(world):
    todo = cases(world)
    got = launch.spawn(dist_allreduce_cases, world, (todo,), timeout=90)
    mesh = flat_mesh(world, "cpu")
    for k, (spec, count, op, dt, seed, chunks) in enumerate(todo):
        x = seeded_rows(world, count, torch_dtype(dt), seed)
        full = tar.allreduce(list(x), mesh, spec, op, chunks=chunks)
        want = digest(full[0])
        if is_ir_family_spec(spec):  # no standalone phases
            assert all(got[r][k][:3] == (want, None, None)
                       for r in range(world)), (spec, count, op, dt)
            continue
        shards = tar.reduce_scatter(list(x), mesh, spec, op)
        for r in range(world):
            full_d, shard_d, back_d, launches = got[r][k]
            assert full_d == want == back_d == digest(full[r]), (r, spec, count, op, dt)
            assert shard_d == digest(shards[r]), (r, spec, count, op, dt)
            assert launches == 0  # a CPU tensor takes the plain fold
        if not torch_dtype(dt).is_floating_point:
            sim = j_simulate(x.numpy(), spec, op)
            assert digest(torch.from_numpy(np.ascontiguousarray(sim[0]))) == \
                want, (spec, count, op, dt)


def test_bench_in_dist_mode():
    cfg = BenchConfig(size=35, repeat=2, topo="2,2", devices=None,
                      device="cpu", dist=True)
    payloads = launch.spawn(dist_bench, 4, (cfg,), timeout=90)
    assert all(p["correct"] and p["num_devices"] == 4 for p in payloads)


def test_bring_up_to_an_absent_coordinator_times_out():
    port = launch.free_port()
    cfg = launch.ClusterConfig(f"127.0.0.1:{port}", 2, 1)
    t0 = time.monotonic()
    with pytest.raises(launch.BringupTimeout) as err:
        launch.init_distributed(cfg, backend="gloo", timeout=1.0, retries=1,
                                backoff=0.1, merge_env=False)
    assert time.monotonic() - t0 < 10
    assert err.value.attempts == 2 and len(err.value.errors) == 2
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("cfg", [
    launch.ClusterConfig("127.0.0.1:1", 2, 5),
    launch.ClusterConfig("no-port", 2, 0),
    launch.ClusterConfig("127.0.0.1:1", 2, None),
])
def test_malformed_configs_raise_at_once(cfg):
    with pytest.raises(launch.BringupConfigError):
        launch.init_distributed(cfg, backend="gloo", timeout=1.0,
                                merge_env=False)


def test_single_process_needs_no_bring_up(monkeypatch):
    for var in ("FT_COORDINATOR", "FT_NUM_PROCESSES", "FT_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    report = launch.init_distributed(None, backend="gloo")
    assert report.backend is None and not torch.distributed.is_initialized()


def test_spawn_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1"):
        launch.spawn(dist_allreduce_cases, 2, ([("3", 4, "sum", "float32", 0,
                                                 1)],), timeout=60)


def _dies_or_waits(rank, world):
    """Rank 1 exits without reporting; rank 0 stays blocked (as a rank
    stuck in a collective with a dead peer may, until its process group's
    timeout)."""
    import os

    if rank == 1:
        os._exit(3)
    time.sleep(100)
    return rank


def test_spawn_stops_waiting_when_a_rank_dies():
    # without the dead rank ending the wait, spawn would wait out rank 0's
    # 100 s block (its 120 s deadline)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"ranks \[.*1.*\] did not report"):
        launch.spawn(_dies_or_waits, 2, timeout=120)
    assert time.monotonic() - t0 < 60
