"""The port's in-process replica pool (``flextree_tpu_torch/serving/
pool.py``) on the CPU: the JAX package's pool tests
(``tests/test_serving.py``'s elastic-pool section, the arbiter's
membership and parallel-round cases, the registry-view report) ported at
the same small width and short timeouts, every completion held to the
contiguous-cache ``generate``'s greedy tokens; then the port's pool
against the JAX pool itself on one scenario, on the same converted
weights: the same completed tokens on the gather path and a report with
the same keys and counts."""

from __future__ import annotations

import dataclasses
import importlib

import jax
import numpy as np
import pytest
import torch

from flextree_tpu_torch.convert import params_from_numpy
from flextree_tpu_torch.models.transformer import TransformerConfig as TCfg
from flextree_tpu_torch.runtime import supervisor as tsup
from flextree_tpu_torch.serving import (
    BatcherConfig,
    PagedCacheConfig,
    PoolConfig,
    ReplicaFailed,
    ReplicaPool,
    Request,
    ServingEngine,
)
from flextree_tpu_torch.serving import engine as teng

jt = importlib.import_module("flextree_tpu.models.transformer")
tgen = importlib.import_module("flextree_tpu_torch.models.generate")
jserving = importlib.import_module("flextree_tpu.serving")

DIMS = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)


@pytest.fixture(scope="module")
def model():
    jcfg = jt.TransformerConfig(**DIMS)
    jparams = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    tcfg = TCfg(**DIMS)

    def reference(prompt, max_new, max_len):
        """The contiguous-cache ``generate``'s greedy tokens (the port's,
        held to the JAX function's by ``test_torch_model.py``; the JAX
        pool itself is the last test's reference)."""
        return tgen.generate(tparams, torch.as_tensor(
            np.asarray(prompt), dtype=torch.long)[None], tcfg,
            max_new_tokens=max_new, max_len=max_len)[0].numpy()

    return tcfg, tparams, reference, jcfg, jparams


def _pcfg(**kw):
    base = dict(num_blocks=32, block_size=8, blocks_per_seq=6)  # max_len 48
    base.update(kw)
    return PagedCacheConfig(**base)


def _prompt(rng, t):
    return rng.integers(0, 64, (t,)).astype(np.int32)


def _engine(model, pcfg, bcfg, fused=True):
    cfg, params = model[:2]
    return ServingEngine(params, cfg, pcfg, bcfg, fused=fused, device="cpu")


def _mk_pool(model, tmp_path, n=2, **cfg_kw):
    pcfg = _pcfg(num_blocks=24)
    engines = [_engine(model, pcfg, BatcherConfig(slots=2)) for _ in range(n)]
    kw = dict(heartbeat_dir=str(tmp_path / "hb"), step_timeout_s=120.0,
              lease_s=30.0, max_suspect_strikes=2)
    kw.update(cfg_kw)
    return ReplicaPool(engines, PoolConfig(**kw)), pcfg


def _reqs(n, seed=7):
    rng = np.random.default_rng(seed)
    return [Request(rid=100 + i, prompt=_prompt(rng, 5 + i), max_new_tokens=5)
            for i in range(n)]


def _check_tokens(model, pool, reqs, pcfg):
    reference = model[2]
    for r in reqs:
        want = reference(r.prompt, r.max_new_tokens, pcfg.max_len)
        np.testing.assert_array_equal(pool.completed[r.rid].tokens, want)


# ------------------------------------------- the JAX pool tests, ported


def test_pool_routes_balanced_and_completes(model, tmp_path):
    pool, pcfg = _mk_pool(model, tmp_path)
    reqs = _reqs(6)
    for r in reqs:
        pool.submit(r)
    pool.step()
    assert sorted(len(r.assigned) for r in pool.replicas) == [3, 3]
    rep = pool.run_until_idle()
    assert rep["completed"] == 6 and not rep["degraded"]
    _check_tokens(model, pool, reqs, pcfg)
    pool.shutdown()


def test_pool_rejected_request_is_recorded_not_lost(model, tmp_path):
    pool, _ = _mk_pool(model, tmp_path)
    for r in _reqs(2):
        pool.submit(r)
    pool.submit(Request(rid=999, prompt=np.zeros(40, np.int32),
                        max_new_tokens=20))  # > max_len 48
    rep = pool.run_until_idle()
    assert rep["completed"] == 2
    assert [rid for rid, _ in rep["rejected"]] == [999]
    assert rep["metrics"]["counters"]["pool.rejected"] == 1
    pool.shutdown()


def test_pool_reroute_preserves_original_arrival_stamp(model, tmp_path,
                                                       monkeypatch):
    t = {"now": 100.0}
    monkeypatch.setattr(teng, "_now", lambda: t["now"])
    pool, _ = _mk_pool(model, tmp_path)
    for r in _reqs(4):
        pool.submit(r)
    t["now"] = 101.0
    pool.step()
    t["now"] = 105.0  # the doomed replica holds them for 4 "seconds"
    pool.kill(1, mode="raise")
    rep = pool.run_until_idle()
    assert rep["completed"] == 4 and rep["reroutes"] > 0
    for done in pool.completed.values():
        assert done.arrival_s == 100.0 and done.ttft_s >= 0
    rerouted = [d.ttft_s for d in pool.completed.values()
                if d.first_token_s >= 105.0]
    assert rerouted and all(x >= 5.0 for x in rerouted)
    pool.shutdown()


def test_pool_crash_kill_drains_and_reroutes(model, tmp_path):
    pool, pcfg = _mk_pool(model, tmp_path)
    reqs = _reqs(6)
    for r in reqs:
        pool.submit(r)
    pool.step()
    pool.kill(1, mode="raise")
    rep = pool.run_until_idle()
    assert rep["completed"] == 6
    assert rep["degraded"] and rep["alive"] == 1 and rep["reroutes"] > 0
    assert rep["kills"] == [{"rank": 1, "mode": "raise"}]
    _check_tokens(model, pool, reqs, pcfg)
    pool.shutdown()


def test_pool_silent_death_confirmed_by_lease_wall_clock(model, tmp_path,
                                                         monkeypatch):
    t = {"now": 1000.0}
    monkeypatch.setattr(tsup, "_wall", lambda: t["now"])
    pool, _ = _mk_pool(model, tmp_path, lease_s=3.0, straggler_s=1.0)
    for r in _reqs(4):
        pool.submit(r)
    pool.step()
    pool.kill(0, mode="silent")
    pool.step()  # inside the lease: still counted alive
    assert len(pool.alive_replicas) == 2
    t["now"] += 10.0  # past the lease; the survivor re-beats at the new time
    pool.replicas[1].supervisor.beat_now()
    pool.step()
    assert [r.rank for r in pool.alive_replicas] == [1]
    rep = pool.run_until_idle()
    assert rep["completed"] == 4 and rep["degraded"] and rep["reroutes"] > 0
    pool.shutdown()


def test_pool_hang_kill_watchdog_converts_to_drain(model, tmp_path):
    pool, pcfg = _mk_pool(model, tmp_path, step_timeout_s=0.5,
                          max_suspect_strikes=3)
    pool.warmup([5, 6, 7, 8])  # on the rounds' own worker threads
    reqs = _reqs(4)
    for r in reqs:
        pool.submit(r)
    pool.step()
    pool.kill(0, mode="hang")
    rep = pool.run_until_idle()
    assert rep["completed"] == 4 and rep["degraded"] and rep["reroutes"] > 0
    assert pool.replicas[0].watchdog.abandoned == 1
    _check_tokens(model, pool, reqs, pcfg)
    pool.shutdown()


def test_pool_results_are_exactly_once(model, tmp_path):
    pool, pcfg = _mk_pool(model, tmp_path)
    reqs = _reqs(6)
    for r in reqs:
        pool.submit(r)
    for _ in range(3):
        pool.step()
    pool.kill(1, mode="raise")
    rep = pool.run_until_idle()
    assert rep["completed"] == 6 == len(set(pool.completed))
    _check_tokens(model, pool, reqs, pcfg)
    pool.shutdown()


def test_pool_drain_reroutes_preempted_sequences(model, tmp_path):
    pcfg = _pcfg(num_blocks=10)
    engines = [_engine(model, pcfg,
                       BatcherConfig(slots=3, admission="ondemand"))
               for _ in range(2)]
    pool = ReplicaPool(engines, PoolConfig(
        heartbeat_dir=str(tmp_path / "hb"), step_timeout_s=120.0,
        lease_s=30.0, max_suspect_strikes=2))
    rng = np.random.default_rng(16)
    reqs = [Request(rid=200 + i, prompt=_prompt(rng, 9), max_new_tokens=20)
            for i in range(6)]
    for r in reqs:
        pool.submit(r)
    for _ in range(40):
        pool.step()
        if engines[1].batcher.preempted:
            break
    assert engines[1].batcher.preempted, "scenario did not reach preemption"
    parked = [p.state.rid for p in engines[1].batcher.preempted]
    assert set(parked) <= {r.rid for r in
                           engines[1].batcher.inflight_requests()}
    pool.kill(1, mode="raise")
    rep = pool.run_until_idle()
    assert rep["completed"] == 6 and rep["degraded"]
    _check_tokens(model, pool, reqs, pcfg)
    assert all(rid in pool.completed for rid in parked)
    pool.shutdown()


def test_add_then_release_exactly_once(model, tmp_path):
    pcfg = _pcfg()
    mk = lambda: _engine(model, pcfg, BatcherConfig(slots=2))  # noqa: E731
    pool = ReplicaPool([mk()], PoolConfig(heartbeat_dir=str(tmp_path)))
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, prompt=_prompt(rng, 4), max_new_tokens=12)
            for i in range(8)]
    for r in reqs[:4]:
        pool.submit(r)
    pool.step()
    assert pool.add_replica(mk()) == 1
    for r in reqs[4:]:
        pool.submit(r)
    pool.step()
    pool.step()
    assert pool.replicas[1].assigned  # the new replica took load
    rerouted = pool.release_replica(1)
    assert rerouted
    assert pool.replicas[1].released and not pool.replicas[1].alive
    assert not pool.degraded  # a release is not a degradation
    report = pool.run_until_idle()
    assert report["completed"] == 8
    assert report["released"] == 1 and report["alive"] == 1
    assert not report["rejected"]
    assert sorted(pool.completed) == list(range(8))
    assert pool.reroutes == len(rerouted)
    _check_tokens(model, pool, reqs, pcfg)
    pool.shutdown()


def test_release_is_idempotent_and_routes_around(model, tmp_path):
    pcfg = _pcfg()
    pool = ReplicaPool(
        [_engine(model, pcfg, BatcherConfig(slots=2)) for _ in range(2)],
        PoolConfig(heartbeat_dir=str(tmp_path)))
    assert pool.release_replica(1) == []
    assert pool.release_replica(1) == []  # second release: no-op
    for r in _reqs(3):
        pool.submit(r)
    pool.run_until_idle()
    assert len(pool.completed) == 3
    assert not pool.replicas[1].assigned  # never routed to
    pool.shutdown()


def test_parallel_rounds_complete_and_survive_a_kill(model, tmp_path):
    pool, pcfg = _mk_pool(model, tmp_path, parallel_rounds=True,
                          step_timeout_s=10.0)
    reqs = _reqs(6)
    for r in reqs:
        pool.submit(r)
    pool.step()
    pool.kill(1, mode="raise")
    report = pool.run_until_idle()
    assert report["completed"] == 6 and report["degraded"] is True
    _check_tokens(model, pool, reqs, pcfg)
    pool.shutdown()


def test_parallel_rounds_propagate_unexpected_exceptions(model, tmp_path):
    pool, _ = _mk_pool(model, tmp_path, parallel_rounds=True,
                       step_timeout_s=None)
    for r in _reqs(4):
        pool.submit(r)

    def broken_step():
        raise ValueError("cache accounting bug")

    pool.replicas[1].engine.step = broken_step
    with pytest.raises(ValueError, match="cache accounting bug"):
        pool.step()
    pool.shutdown()


def test_pool_refusals_and_the_report_is_a_registry_view(model, tmp_path):
    with pytest.raises(ValueError, match="at least one engine"):
        ReplicaPool([], PoolConfig(heartbeat_dir=str(tmp_path)))
    pool, _ = _mk_pool(model, tmp_path, n=1)
    with pytest.raises(ValueError, match="unknown kill mode"):
        pool.kill(0, mode="melt")
    pool.submit(Request(rid=9, prompt=np.arange(4, dtype=np.int32),
                        max_new_tokens=2))
    report = pool.run_until_idle()
    pool.shutdown()
    assert report["submitted"] == 1 == pool.submitted
    assert report["completed"] == 1 and pool.reroutes == 0
    assert report["metrics"]["counters"]["pool.submitted"] == 1
    assert report["replica_metrics"][0]["counters"]["serve.finished"] == 1
    assert ReplicaFailed.code == jserving.ReplicaFailed.code


# ------------------------------------------------ against the JAX pool


def _both_pools(model, tmp_path, mode):
    """The same scenario on the JAX pool and the port's, both on the
    gather path: 6 requests over 2 replicas, replica 1 killed in ``mode``
    after two rounds.  Returns ``{"jax": (pool, report), "torch": ...}``."""
    tcfg, tparams, _, jcfg, jparams = model
    pcfg = _pcfg(num_blocks=24)
    out = {}
    for name in ("jax", "torch"):
        if name == "jax":
            S = jserving
            engines = [S.ServingEngine(jparams, jcfg, S.PagedCacheConfig(
                **dataclasses.asdict(pcfg)), S.BatcherConfig(slots=2),
                fused=False) for _ in range(2)]
        else:
            S = importlib.import_module("flextree_tpu_torch.serving")
            engines = [_engine(model, pcfg, BatcherConfig(slots=2),
                               fused=False) for _ in range(2)]
        pool = S.ReplicaPool(engines, S.PoolConfig(
            heartbeat_dir=str(tmp_path / name), step_timeout_s=120.0,
            lease_s=30.0, max_suspect_strikes=2))
        rng = np.random.default_rng(11)
        for i in range(6):
            pool.submit(S.Request(rid=i, prompt=_prompt(rng, 4 + i),
                                  max_new_tokens=6))
        pool.step()
        pool.step()
        pool.kill(1, mode=mode)
        out[name] = (pool, pool.run_until_idle())
        pool.shutdown()
    return out


def test_gather_path_tokens_and_report_match_the_jax_pool(model, tmp_path):
    out = _both_pools(model, tmp_path, "raise")
    (jpool, jrep), (tpool, trep) = out["jax"], out["torch"]
    assert sorted(tpool.completed) == sorted(jpool.completed) == \
        list(range(6))
    for rid in range(6):
        np.testing.assert_array_equal(tpool.completed[rid].tokens,
                                      np.asarray(jpool.completed[rid].tokens))
    assert set(trep) == set(jrep)
    for key in ("replicas", "alive", "released", "degraded", "submitted",
                "completed", "rejected", "reroutes", "kills"):
        assert trep[key] == jrep[key], key
    assert trep["metrics"] == jrep["metrics"]
    assert set(trep["replica_metrics"]) == set(jrep["replica_metrics"]) == \
        {0, 1}
