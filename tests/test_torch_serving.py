"""The port's serving layer (``flextree_tpu_torch.serving``) on the CPU.

Host-side state machines (allocator, batcher) on their own; the pool
writes and reads bitwise; and the port's engine — fused (the plain stream
standing in for the CUDA kernel on the CPU) and gather — against the JAX
package's ``generate`` on the same converted weights: identical greedy
tokens through ragged joins, on-demand preemption (swap and recompute),
prefix-cache hits and stop tokens.  Sampled requests are held to
determinism per seed (``jax.random``'s draws cannot be matched).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flextree_tpu.models.generate import generate as jax_generate
from flextree_tpu.models.transformer import TransformerConfig as JCfg
from flextree_tpu.models.transformer import init_params as j_init_params
from flextree_tpu_torch import resolve_device
from flextree_tpu_torch.convert import params_from_numpy
from flextree_tpu_torch.models.generate import prefill
from flextree_tpu_torch.models.transformer import TransformerConfig as TCfg
from flextree_tpu_torch.obs import flight_recorder, record_event
from flextree_tpu_torch.serving import (
    BatcherConfig,
    BlockAllocator,
    CacheExhausted,
    ContinuousBatcher,
    PagedCacheConfig,
    Request,
    ServingEngine,
    gather_seq,
    init_pools,
    write_prefill,
    write_prefill_at,
    write_swapped,
)
from flextree_tpu_torch.serving.__main__ import main as serving_main

DIMS = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64)


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = JCfg(**DIMS), TCfg(**DIMS)
    jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    refs: dict = {}

    def reference(prompt, max_new, max_len):
        """JAX greedy tokens for one prompt (memoized per module)."""
        key = (bytes(np.asarray(prompt, np.int32)), max_new, max_len)
        if key not in refs:
            refs[key] = np.asarray(jax_generate(
                jparams, jnp.asarray(prompt, jnp.int32)[None], jcfg,
                max_new_tokens=max_new, max_len=max_len,
            ))[0]
        return refs[key]

    return tcfg, tparams, reference


def _engine(model, pcfg, bcfg, fused=True):
    tcfg, tparams, _ = model
    return ServingEngine(tparams, tcfg, pcfg, bcfg, fused=fused,
                         device="cpu")


def _check_against_jax(model, eng, reqs, pcfg):
    _, _, reference = model
    assert len(eng.completed) == len(reqs)
    for r in reqs:
        want = reference(r.prompt, r.max_new_tokens, pcfg.max_len)
        np.testing.assert_array_equal(eng.completed[r.rid].tokens, want)


# ------------------------------------------------------- host-side pieces


def test_allocator_refcounts_and_loud_misuse():
    a = BlockAllocator(6)
    blocks = a.alloc(3)
    assert blocks == [1, 2, 3] and a.num_free == 2
    a.retain([blocks[0]])
    with pytest.raises(ValueError, match="shared"):
        a.free([blocks[0]])
    twin = a.fork_block(blocks[0])
    assert twin == 4 and a.refcount(blocks[0]) == 2
    a.release([blocks[0]])
    a.free(blocks)
    with pytest.raises(ValueError, match="not allocated"):
        a.free([blocks[1]])
    with pytest.raises(CacheExhausted):
        a.alloc(5)
    assert a.num_free == 4  # all-or-nothing: the failed alloc took nothing


def test_batcher_admission_modes():
    pcfg = PagedCacheConfig(num_blocks=9, block_size=4, blocks_per_seq=8)
    req = Request(rid=0, prompt=np.arange(5, dtype=np.int32),
                  max_new_tokens=10)
    reserve = ContinuousBatcher(pcfg, BatcherConfig(slots=2))
    ondemand = ContinuousBatcher(pcfg, BatcherConfig(slots=2,
                                                     admission="ondemand"))
    assert reserve.blocks_needed(req) == 4 and ondemand.blocks_needed(req) == 2
    assert not reserve.submit(dataclasses.replace(req, rid=1,
                                                  max_new_tokens=40))
    assert not reserve.submit(dataclasses.replace(req, rid=2,
                                                  temperature=1.0))
    assert reserve.submit(req)
    [(slot, state)] = reserve.try_admit()
    assert state.length == 5 and len(state.block_ids) == 4
    tables, lengths, tokens, active = reserve.batch_arrays()
    assert tables[slot, :4].tolist() == state.block_ids
    assert lengths.tolist() == [5, 0] and active.tolist() == [True, False]


def test_write_prefill_gather_seq_roundtrip_bitwise(model):
    tcfg, tparams, _ = model
    pcfg = PagedCacheConfig(num_blocks=12, block_size=4, blocks_per_seq=5)
    pools = init_pools(tcfg, pcfg, "cpu")
    tok = torch.from_numpy(np.arange(3, 14, dtype=np.int64))[None]  # 11
    _, cache = prefill(tparams, tok, tcfg, pcfg.max_len)
    blocks = [7, 2, 9]
    write_prefill(pools, cache, blocks)
    view = gather_seq(pools, blocks, length=11)
    for kind in ("k", "v"):
        for layer in range(tcfg.n_layers):
            assert torch.equal(view[kind][layer], cache[kind][layer][0, :11])
    # a gathered row is a copy, never a view of the pool
    pools["k"][0][7] = 99.0
    assert not torch.equal(view["k"][0][:4], pools["k"][0][7])
    # swap round trip: the saved bytes come back bit for bit elsewhere
    saved = gather_seq(pools, blocks)
    write_swapped(pools, saved, [1, 3, 5])
    again = gather_seq(pools, [1, 3, 5])
    assert all(torch.equal(a, b) for a, b in zip(saved["k"], again["k"]))
    # the suffix scatter never touches the blocks below start_block
    before = pools["v"][1][1].clone()
    write_prefill_at(pools, cache, [6, 8], 1)
    assert torch.equal(pools["v"][1][1], before)
    assert torch.equal(pools["v"][1][6],
                       cache["v"][1][0, 4:8])


# ------------------------------------------------------- engine vs JAX


def _ragged_requests(seed, n, plen=(3, 12), new=(6, 14)):
    rng = np.random.default_rng(seed)
    return [Request(rid=i,
                    prompt=rng.integers(0, 64, (int(rng.integers(*plen)),))
                    .astype(np.int32),
                    max_new_tokens=int(rng.integers(*new)))
            for i in range(n)]


@pytest.mark.parametrize("fused", [True, False])
def test_engine_ragged_joins_match_jax_generate(model, fused):
    pcfg = PagedCacheConfig(num_blocks=40, block_size=8, blocks_per_seq=4)
    eng = _engine(model, pcfg, BatcherConfig(slots=2), fused=fused)
    eng.warmup()
    reqs = _ragged_requests(0, 5)
    for r in reqs:
        assert eng.submit(r)
    eng.run_until_idle()
    _check_against_jax(model, eng, reqs, pcfg)
    assert eng.report()["counters"]["serve.decode_tokens"] == sum(
        r.max_new_tokens - 1 for r in reqs)


@pytest.mark.parametrize("preempt,fused", [("swap", True),
                                           ("recompute", True),
                                           ("swap", False)])
def test_engine_ondemand_preemption_matches_jax_generate(model, preempt,
                                                         fused):
    pcfg = PagedCacheConfig(num_blocks=10, block_size=8, blocks_per_seq=6)
    eng = _engine(model, pcfg, BatcherConfig(slots=4, admission="ondemand",
                                             preempt=preempt), fused=fused)
    rng = np.random.default_rng(1)
    reqs = [Request(rid=i, prompt=rng.integers(0, 64, (9,)).astype(np.int32),
                    max_new_tokens=20) for i in range(5)]
    for r in reqs:
        assert eng.submit(r)
    eng.run_until_idle()
    counters = eng.report()["counters"]
    assert counters["serve.preempts"] >= 1
    assert counters["serve.resumes"] == counters["serve.preempts"]
    _check_against_jax(model, eng, reqs, pcfg)
    assert eng.batcher.allocator.num_free == pcfg.num_blocks - 1


def test_engine_prefix_cache_hits_match_jax_generate(model):
    pcfg = PagedCacheConfig(num_blocks=30, block_size=8, blocks_per_seq=5)
    eng = _engine(model, pcfg, BatcherConfig(slots=1, prefix_cache=True))
    rng = np.random.default_rng(2)
    shared = rng.integers(0, 64, (16,)).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, 64, (n,))
                               .astype(np.int32)]) for n in (8, 3, 7)]
    prompts.append(prompts[0].copy())  # block-aligned full hit: COW fork
    reqs = [Request(rid=i, prompt=p, max_new_tokens=8)
            for i, p in enumerate(prompts)]
    for r in reqs:
        assert eng.submit(r)
    eng.run_until_idle()
    counters = eng.report()["counters"]
    assert counters["serve.prefix_hits"] == 3
    assert counters["serve.prefix_cow"] >= 1
    _check_against_jax(model, eng, reqs, pcfg)
    eng.release_prefix_cache()
    assert eng.batcher.allocator.num_free == pcfg.num_blocks - 1


def test_engine_stop_tokens_match_jax_generate(model):
    _, _, reference = model
    pcfg = PagedCacheConfig(num_blocks=20, block_size=8, blocks_per_seq=4)
    prompt = np.random.default_rng(3).integers(0, 64, (6,)).astype(np.int32)
    free = reference(prompt, 12, pcfg.max_len)
    stop = int(free[4])
    eng = _engine(model, pcfg, BatcherConfig(slots=2))
    eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=12,
                       stop_tokens=(stop,)))
    eng.run_until_idle()
    got = eng.completed[0].tokens
    cut = int(np.argmax(free == stop)) + 1
    np.testing.assert_array_equal(got, free[:cut])


def test_sampled_requests_deterministic_per_seed(model):
    """A sampled request's tokens depend on its seed alone: the same in
    any batch mix and across preemption, different for another seed."""
    pcfg = PagedCacheConfig(num_blocks=10, block_size=8, blocks_per_seq=6)
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, 64, (9,)).astype(np.int32)
    sampled = Request(rid=100, prompt=prompt, max_new_tokens=20,
                      temperature=0.9, top_k=16, seed=5)

    def run(extra, seed=5):
        eng = _engine(model, pcfg, BatcherConfig(slots=4,
                                                 admission="ondemand"))
        for r in extra:
            eng.submit(r)
        eng.submit(dataclasses.replace(sampled, seed=seed))
        eng.run_until_idle()
        return eng.completed[100].tokens, eng.report()["counters"]

    alone, _ = run([])
    crowd = [Request(rid=i, prompt=rng.integers(0, 64, (9,)).astype(np.int32),
                     max_new_tokens=20) for i in range(4)]
    mixed, counters = run(crowd)
    assert counters.get("serve.preempts", 0) >= 1
    np.testing.assert_array_equal(alone, mixed)
    other, _ = run([], seed=6)
    assert not np.array_equal(alone, other)


# ------------------------------------------------------- entry points


def test_engine_without_gpu_raises_instead_of_falling_back(model,
                                                           monkeypatch):
    tcfg, tparams, _ = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(tparams, tcfg, PagedCacheConfig(num_blocks=4))
    assert resolve_device("cpu").type == "cpu"


def test_engine_events_and_metrics(model, tmp_path):
    record_event("ignored_without_recorder", x=1)  # a no-op
    pcfg = PagedCacheConfig(num_blocks=20, block_size=8, blocks_per_seq=4)
    with flight_recorder(tmp_path, rank=0) as rec:
        eng = _engine(model, pcfg, BatcherConfig(slots=2))
        for r in _ragged_requests(5, 3):
            eng.submit(r)
        eng.run_until_idle()
    with open(rec.event_path, encoding="utf-8") as f:
        events = [json.loads(line) for line in f]
    kinds = {e["kind"] for e in events}
    assert {"serve_admit", "serve_prefill", "serve_decode",
            "serve_retire"} <= kinds
    assert [e["seq"] for e in events] == list(range(len(events)))
    report = eng.report()
    assert report["completed"] == 3
    ttft = report["histograms"]["serve.ttft_ms"]
    assert ttft["count"] == 3 and ttft["window"]["count"] == 3


def test_serving_cli_on_cpu(tmp_path, capsys):
    out = tmp_path / "report.json"
    rc = serving_main(["--cpu", "--requests", "4", "--admission", "ondemand",
                       "--blocks", "9", "--max-new", "12", "--d-model", "32",
                       "--n-heads", "4", "--d-ff", "64", "--vocab", "64",
                       "--report", str(out)])
    assert rc == 0
    report = json.loads(out.read_text())
    assert report["completed"] == 4 and report["config"]["device"] == "cpu"
    assert report["config"]["decode_impl"] == "cuda"
    capsys.readouterr()
