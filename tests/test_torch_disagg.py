"""Prefill/decode disaggregation in the port's engine, against the JAX
engine on the CPU (the port's counterpart of
``tests/test_disagg.py::TestEngineMigration``):

- a sequence prefilled on one port engine, exported, packed, unpacked and
  admitted on another decodes to the JAX colocated engine's greedy tokens
  and to the port's own colocated tokens (f32, float32, the gather path;
  the fused path against its own colocated run); int8 under the JAX
  test's rule (its offsets, where the quantization flips no greedy tie);
- export blocks release on the ack and never before, exactly once;
  aborts count; sampled, oversized and mis-shaped migrations are refused,
  a full decode engine refuses with ``None``;
- a migrated arrival seeds the prefix index; ``intervals_s``;
- the prefix drain handoff: the export's token prefixes are the JAX
  engine's, a port export prewarms a fresh port engine with no hash
  mismatch, and a corrupted hash refuses its entry and its subtree;
- the per-round cost feedback: one ``serve.round_residual`` sample and one
  ``serve_round_measured`` event a decode round.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flextree_tpu.models.transformer import TransformerConfig as JCfg
from flextree_tpu.models.transformer import init_params as j_init_params
from flextree_tpu.serving import BatcherConfig as JBcfg
from flextree_tpu.serving import ContinuousBatcher as JBatcher
from flextree_tpu.serving import PagedCacheConfig as JPcfg
from flextree_tpu.serving import Request as JRequest
from flextree_tpu.serving import ServingEngine as JEngine
from flextree_tpu_torch.convert import params_from_numpy
from flextree_tpu_torch.models.transformer import TransformerConfig as TCfg
from flextree_tpu_torch.obs import flight_recorder
from flextree_tpu_torch.serving import (
    BatcherConfig,
    ContinuousBatcher,
    MigrationError,
    PagedCacheConfig,
    Request,
    ServingEngine,
)

DIMS = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64)
CACHE = dict(num_blocks=40, block_size=4, blocks_per_seq=8)  # max_len 32
MAX_NEW = 6
F32_LENS = (3, 4, 5, 8, 9, 13)
INT8_LENS = (3, 4, 5, 8, 9)  # the JAX test's int8 offsets


def _prompt(plen):
    rng = np.random.default_rng(100 + plen)
    return rng.integers(0, 64, (plen,)).astype(np.int32)


@pytest.fixture(scope="module")
def model():
    """Port params converted from the JAX init, and the JAX colocated
    engine's greedy tokens for every prompt length the tests use."""
    jcfg = JCfg(**DIMS)
    jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    jeng = JEngine(jparams, jcfg, JPcfg(**CACHE), JBcfg(slots=4),
                   fused=False)
    for plen in F32_LENS:
        jeng.submit(JRequest(rid=plen, prompt=_prompt(plen),
                             max_new_tokens=MAX_NEW))
    jeng.run_until_idle()
    jax_tokens = {plen: np.asarray(jeng.completed[plen].tokens)
                  for plen in F32_LENS}
    return TCfg(**DIMS), tparams, jax_tokens


def _engine(model, pcfg=None, fused=False, **bkw):
    cfg, params, _ = model
    bkw.setdefault("slots", 4)
    return ServingEngine(params, cfg, pcfg or PagedCacheConfig(**CACHE),
                         BatcherConfig(**bkw), fused=fused, device="cpu")


def _migrate(model, req, codec="f32", fused=False, dec=None):
    pre = _engine(model, fused=fused)
    out = pre.prefill_for_migration(req, codec=codec)
    assert out is not None
    dec = dec or _engine(model, fused=fused)
    slot = dec.admit_migrated(req, out["first_token"], out["meta"],
                              out["blob"])
    assert slot is not None
    dec.run_until_idle()
    assert pre.release_exported(req.rid, acked=True)
    return dec


@pytest.mark.parametrize("codec,plen", [("f32", p) for p in F32_LENS]
                         + [("int8", p) for p in INT8_LENS])
def test_migrated_tokens_match_colocated(model, codec, plen):
    """Every block-boundary offset (bs=4: partial, exact, mid-tail)
    through export → pack → unpack → admit, on the gather path."""
    _, _, jax_tokens = model
    req = Request(rid=1, prompt=_prompt(plen), max_new_tokens=MAX_NEW)
    dec = _migrate(model, req, codec)
    col = _engine(model)
    assert col.submit(req)
    col.run_until_idle()
    got = dec.completed[1].tokens
    np.testing.assert_array_equal(got, jax_tokens[plen])
    np.testing.assert_array_equal(got, col.completed[1].tokens)


@pytest.mark.parametrize("plen", [5, 13])
def test_fused_migration_matches_fused_colocated(model, plen):
    """The fused decode (the plain stream on the CPU, the CUDA kernel on
    the card) from imported blocks gives the colocated fused tokens."""
    req = Request(rid=2, prompt=_prompt(plen), max_new_tokens=MAX_NEW)
    dec = _migrate(model, req, fused=True)
    col = _engine(model, fused=True)
    assert col.submit(req)
    col.run_until_idle()
    np.testing.assert_array_equal(dec.completed[2].tokens,
                                  col.completed[2].tokens)


def test_export_blocks_release_on_ack_never_before(model):
    eng = _engine(model)
    free0 = eng.batcher.allocator.num_free
    req = Request(rid=5, prompt=_prompt(9), max_new_tokens=4)
    assert eng.prefill_for_migration(req) is not None
    held = PagedCacheConfig(**CACHE).blocks_for(9)
    assert eng.batcher.allocator.num_free == free0 - held
    with pytest.raises(MigrationError, match="in flight"):
        eng.prefill_for_migration(req)
    assert eng.release_exported(5, acked=True)
    assert eng.batcher.allocator.num_free == free0
    assert not eng.release_exported(5, acked=True)  # exactly once
    assert eng.metrics.counter("serve.migration_acked").value == 1
    assert eng.metrics.counter("serve.migration_exports").value == 1


def test_abort_releases_and_counts(model):
    eng = _engine(model)
    free0 = eng.batcher.allocator.num_free
    req = Request(rid=6, prompt=_prompt(5), max_new_tokens=4)
    assert eng.prefill_for_migration(req) is not None
    assert eng.release_exported(6, acked=False)
    assert eng.batcher.allocator.num_free == free0
    assert eng.metrics.counter("serve.migration_aborted").value == 1
    assert eng.metrics.counter("serve.migration_acked").value == 0


def test_sampled_and_oversized_requests_never_migrate(model):
    eng = _engine(model)
    with pytest.raises(MigrationError, match="greedy-only"):
        eng.prefill_for_migration(Request(
            rid=7, prompt=_prompt(5), max_new_tokens=4, temperature=0.7,
            seed=1,
        ))
    with pytest.raises(MigrationError, match="outside"):
        eng.prefill_for_migration(Request(
            rid=8, prompt=np.ones(40, np.int32), max_new_tokens=4,
        ))
    assert eng.batcher.allocator.num_free == CACHE["num_blocks"] - 1


def test_admit_refuses_geometry_and_oversize(model):
    cfg, params, _ = model
    req = Request(rid=9, prompt=_prompt(6), max_new_tokens=4)
    pre = ServingEngine(
        params, cfg,
        PagedCacheConfig(num_blocks=40, block_size=8, blocks_per_seq=4),
        BatcherConfig(slots=4), fused=False, device="cpu",
    )
    out = pre.prefill_for_migration(req)
    dec = _engine(model)  # block size 4 here
    with pytest.raises(MigrationError, match="geometry"):
        dec.admit_migrated(req, out["first_token"], out["meta"],
                           out["blob"])
    long = Request(rid=9, prompt=_prompt(6), max_new_tokens=40)
    with pytest.raises(MigrationError, match="exceeds"):
        dec.admit_migrated(long, out["first_token"], out["meta"],
                           out["blob"])
    assert dec.batcher.num_active == 0
    assert dec.batcher.allocator.num_free == CACHE["num_blocks"] - 1
    pre.release_exported(9, acked=False)


def test_admit_capacity_refusal_is_none_not_raise(model):
    dec = _engine(model, slots=1)
    assert dec.submit(Request(rid=20, prompt=_prompt(5), max_new_tokens=4))
    dec.step()  # fills the only slot
    req = Request(rid=21, prompt=_prompt(5), max_new_tokens=4)
    pre = _engine(model)
    out = pre.prefill_for_migration(req)
    assert dec.admit_migrated(req, out["first_token"], out["meta"],
                              out["blob"]) is None
    assert dec.metrics.counter("serve.migration_refused").value == 1
    pre.release_exported(21, acked=False)
    dec.run_until_idle()
    assert 20 in dec.completed and 21 not in dec.completed


def test_batcher_admit_migrated_matches_jax():
    t = ContinuousBatcher(PagedCacheConfig(**CACHE), BatcherConfig(slots=2))
    j = JBatcher(JPcfg(**CACHE), JBcfg(slots=2))
    for rid, plen in ((30, 6), (31, 9)):
        got = t.admit_migrated(Request(rid=rid, prompt=_prompt(plen),
                                       max_new_tokens=4), 42, now_s=1.0)
        want = j.admit_migrated(JRequest(rid=rid, prompt=_prompt(plen),
                                         max_new_tokens=4), 42, now_s=1.0)
        (slot, st), (jslot, jst) = got, want
        assert slot == jslot and t.slots[slot] is st
        assert (st.length, st.pending_token, st.generated, st.block_ids,
                st.first_token_s, st.token_times) == (
            jst.length, jst.pending_token, jst.generated, jst.block_ids,
            jst.first_token_s, jst.token_times)
    # no free slot: refused, as in JAX
    assert t.admit_migrated(Request(rid=32, prompt=_prompt(3),
                                    max_new_tokens=4), 1) is None


def test_migrated_sequence_seeds_prefix_index(model):
    req = Request(rid=31, prompt=_prompt(9), max_new_tokens=4)
    pre = _engine(model)
    out = pre.prefill_for_migration(req)
    dec = _engine(model, prefix_cache=True)
    assert dec.admit_migrated(req, out["first_token"], out["meta"],
                              out["blob"]) is not None
    hit = dec.batcher.prefix_index.match(np.asarray(req.prompt))
    assert len(hit) == 2  # 2 full blocks of 4; the partial tail is private
    dec.run_until_idle()
    assert 31 in dec.completed
    pre.release_exported(31, acked=True)


def test_completed_request_reports_decode_intervals(model):
    eng = _engine(model)
    assert eng.submit(Request(rid=40, prompt=_prompt(5), max_new_tokens=5))
    eng.run_until_idle()
    done = eng.completed[40]
    assert len(done.token_times) == len(done.tokens)
    assert len(done.intervals_s) == len(done.tokens) - 1
    assert all(d >= 0.0 for d in done.intervals_s)


def test_round_feedback_once_per_decode_round(model, tmp_path):
    with flight_recorder(tmp_path, rank=0) as rec:
        eng = _engine(model)
        for rid, plen in ((1, 3), (2, 9)):
            assert eng.submit(Request(rid=rid, prompt=_prompt(plen),
                                      max_new_tokens=5))
        eng.run_until_idle()
    hist = eng.report()["histograms"]["serve.round_residual"]
    assert hist["count"] == eng.decode_steps > 0
    events = [e for e in rec.events if e["kind"] == "serve_round_measured"]
    assert len(events) == eng.decode_steps
    assert all(e["predicted_us"] > 0 and e["measured_us"] > 0
               for e in events)
    # the frontier: the longest active length of the round
    assert events[0]["max_len"] == 9 and events[0]["n_active"] == 2
    prefills = [e for e in rec.events if e["kind"] == "serve_prefill"]
    assert all(e["predicted_us"] > 0 for e in prefills)


def _shared_prompts():
    base = np.arange(1, 13, dtype=np.int32)  # three full blocks of 4
    return [np.concatenate([base[:n], [50 + i] * 3]).astype(np.int32)
            for i, n in enumerate((12, 8, 12, 4))]


def test_handoff_export_matches_jax_and_prewarms(model):
    cfg, params, _ = model
    jcfg = JCfg(**DIMS)
    jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
    jeng = JEngine(jparams, jcfg, JPcfg(**CACHE),
                   JBcfg(slots=1, prefix_cache=True), fused=False)
    eng = _engine(model, slots=1, prefix_cache=True)
    for i, p in enumerate(_shared_prompts()):
        jeng.submit(JRequest(rid=i, prompt=p, max_new_tokens=3))
        assert eng.submit(Request(rid=i, prompt=p, max_new_tokens=3))
    jeng.run_until_idle()
    eng.run_until_idle()
    doc = eng.export_prefix_handoff()
    jdoc = jeng.export_prefix_handoff()
    assert doc["version"] == jdoc["version"] == 1
    assert doc["block_size"] == jdoc["block_size"]
    prefixes = sorted(e["prefix"] for e in doc["entries"])
    assert prefixes == sorted(e["prefix"] for e in jdoc["entries"])
    assert len(prefixes) >= 3
    warm = _engine(model, slots=1, prefix_cache=True)
    stats = warm.prewarm_prefix_from_handoff(doc)
    assert stats == {"inserted": len(prefixes), "skipped": 0,
                     "hash_mismatches": 0, "refused": None}
    assert sorted(e["prefix"] for e in
                  warm.export_prefix_handoff()["entries"]) == prefixes
    # a prefix hit on the warm engine gives the cold engine's tokens
    p = _shared_prompts()[0]
    assert warm.submit(Request(rid=9, prompt=p, max_new_tokens=3))
    warm.run_until_idle()
    np.testing.assert_array_equal(warm.completed[9].tokens,
                                  eng.completed[0].tokens)
    assert warm.metrics.counter("serve.prefix_hits").value == 1


def test_handoff_corrupt_hash_refuses_entry_and_subtree(model):
    eng = _engine(model, slots=1, prefix_cache=True)
    for i, p in enumerate(_shared_prompts()):
        assert eng.submit(Request(rid=i, prompt=p, max_new_tokens=3))
    eng.run_until_idle()
    doc = eng.export_prefix_handoff()
    root = min(doc["entries"], key=lambda e: len(e["prefix"]))
    root["hash"] = "00000000" if root["hash"] != "00000000" else "ffffffff"
    below = [e for e in doc["entries"] if len(e["prefix"]) > 4
             and e["prefix"][:4] == root["prefix"]]
    assert below
    warm = _engine(model, slots=1, prefix_cache=True)
    stats = warm.prewarm_prefix_from_handoff(doc)
    assert stats["hash_mismatches"] == 1
    assert stats["inserted"] == len(doc["entries"]) - 1 - len(below)
    assert stats["skipped"] == len(below)
    assert warm.metrics.counter("serve.handoff_hash_mismatch").value == 1
    # a wrong block size or version refuses the whole document
    assert warm.prewarm_prefix_from_handoff(
        dict(doc, block_size=8))["refused"] == "incompatible handoff payload"
    assert _engine(model).prewarm_prefix_from_handoff(doc)["refused"] == \
        "prefix cache disabled"


def test_warmup_takes_the_jax_signature(model):
    eng = _engine(model, prefix_cache=True)
    eng.warmup([3, 9], {2, 4}, suffix_buckets=[(4, 2), (6, 1)],
               import_counts={1, 3})
    with pytest.raises(ValueError, match="suffix bucket"):
        eng.warmup([3], suffix_buckets=[(0, 2)])
    # the warmup's writes went to the null block only: serving is unmoved
    req = Request(rid=3, prompt=_prompt(9), max_new_tokens=MAX_NEW)
    assert eng.submit(req)
    eng.run_until_idle()
    np.testing.assert_array_equal(eng.completed[3].tokens, model[2][9])


def test_jax_import_of_a_port_payload_decodes_the_same(model):
    """The wire is one format: a payload the port exported lands in the
    JAX decode engine and decodes to the JAX colocated tokens."""
    _, _, jax_tokens = model
    jcfg = JCfg(**DIMS)
    jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
    req = Request(rid=4, prompt=_prompt(8), max_new_tokens=MAX_NEW)
    out = _engine(model).prefill_for_migration(req)
    jdec = JEngine(jparams, jcfg, JPcfg(**CACHE), JBcfg(slots=4),
                   fused=False)
    jreq = JRequest(rid=4, prompt=jnp.asarray(req.prompt),
                    max_new_tokens=MAX_NEW)
    assert jdec.admit_migrated(jreq, out["first_token"], out["meta"],
                               out["blob"]) is not None
    jdec.run_until_idle()
    np.testing.assert_array_equal(jdec.completed[4].tokens, jax_tokens[8])


def test_prefill_sleep_knob_scales_with_computed_tokens(model, monkeypatch):
    """``FT_RPC_PREFILL_SLEEP`` (a replica's ``chaos_prefill_sleep_s``)
    stretches each prefill by its seconds per computed prompt token, on
    the local and the migration prefill alike; off by default."""
    import types

    from flextree_tpu_torch.serving import engine as engine_mod
    from flextree_tpu_torch.serving.replica_main import (
        ReplicaConfig,
        ReplicaServer,
    )

    slept = []
    monkeypatch.setattr(engine_mod, "time",
                        types.SimpleNamespace(sleep=slept.append))
    eng = _engine(model)
    assert eng.chaos_prefill_sleep_s == 0.0
    monkeypatch.setenv("FT_RPC_PREFILL_SLEEP", "0.25")
    ReplicaServer(eng, ReplicaConfig(0, "unused"))
    assert eng.chaos_prefill_sleep_s == 0.25
    assert eng.submit(Request(rid=1, prompt=_prompt(5), max_new_tokens=2))
    eng.run_until_idle()
    assert eng.prefill_for_migration(
        Request(rid=2, prompt=_prompt(8), max_new_tokens=2)) is not None
    assert slept == [0.25 * 5, 0.25 * 8]


def test_port_import_of_a_jax_payload_decodes_the_same(model):
    """The other direction: the JAX prefill engine's export lands in the
    port's decode engine (on the same converted weights) and decodes to
    the JAX colocated tokens."""
    _, _, jax_tokens = model
    jcfg = JCfg(**DIMS)
    jparams = j_init_params(jax.random.PRNGKey(0), jcfg)
    jpre = JEngine(jparams, jcfg, JPcfg(**CACHE), JBcfg(slots=4),
                   fused=False)
    out = jpre.prefill_for_migration(
        JRequest(rid=6, prompt=_prompt(9), max_new_tokens=MAX_NEW))
    dec = _engine(model)
    req = Request(rid=6, prompt=_prompt(9), max_new_tokens=MAX_NEW)
    assert dec.admit_migrated(req, out["first_token"], out["meta"],
                              out["blob"]) is not None
    dec.run_until_idle()
    np.testing.assert_array_equal(dec.completed[6].tokens, jax_tokens[9])
    assert jpre.release_exported(6, acked=True)
