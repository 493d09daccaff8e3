"""``bench_disagg``'s int8 token-identity gate at the flagship, held
against the JAX package's engines on the CPU:

- the replicas' model (the flagship widths, the port's seed-0 weights)
  converted to the JAX engine, the int8 workload (seed 43), every prompt
  at or past the card's int8 crossover prefilled on one JAX engine,
  packed int8, unpacked and decoded on another: the rids whose tokens
  differ from JAX ``generate``'s are ``INT8_FLAGSHIP_FLIPS``, and f32
  migration of those rids flips none;
- the port's engines on the same weights flip the same rids against the
  port's ``generate``;
- ``only_the_reference_flips`` takes a report whose one violation is
  those flips and refuses any other.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flextree_tpu.models.generate import generate as j_generate
from flextree_tpu.models.transformer import TransformerConfig as JCfg
from flextree_tpu.serving import BatcherConfig as JBcfg
from flextree_tpu.serving import PagedCacheConfig as JPcfg
from flextree_tpu.serving import Request as JRequest
from flextree_tpu.serving import ServingEngine as JEngine
from flextree_tpu_torch.models.generate import generate
from flextree_tpu_torch.models.transformer import init_params
from flextree_tpu_torch.serving import (
    BatcherConfig,
    PagedCacheConfig,
    Request,
    ServingEngine,
)
from flextree_tpu_torch.tools import bench_disagg as bd
from flextree_tpu_torch.tools import rpc_chaos as rc

N = 28  # the full run's requests; --smoke takes the first 10
SLOTS = 4


@pytest.fixture(scope="module")
def flagship():
    """The replicas' config and weights on a card, and the migrated part
    of the int8 workload (prompts at or past the card's crossover)."""
    cfg, seed = rc._model_config(rc.FLAGSHIP_ARGS)
    params = init_params(cfg, torch.Generator().manual_seed(seed),
                         device="cpu")
    cross = bd.crossover("int8", "cuda")["tokens"]
    migrated = [r for r in bd.build_workload(43, N)
                if len(r["prompt"]) >= cross]
    return cfg, params, migrated


def _jax_flips(cfg, jparams, requests, codec):
    jcfg = JCfg(vocab_size=cfg.vocab_size, d_model=cfg.d_model,
                n_heads=cfg.n_heads, n_layers=cfg.n_layers, d_ff=cfg.d_ff)

    def engine():
        return JEngine(jparams, jcfg, JPcfg(**rc.CACHE), JBcfg(slots=SLOTS),
                       fused=False)

    pre, bad = engine(), []
    for i in range(0, len(requests), SLOTS):
        dec, batch = engine(), requests[i:i + SLOTS]
        for r in batch:
            req = JRequest(rid=r["rid"], prompt=jnp.asarray(r["prompt"]),
                           max_new_tokens=r["max_new"])
            out = pre.prefill_for_migration(req, codec=codec)
            assert dec.admit_migrated(req, out["first_token"], out["meta"],
                                      out["blob"]) is not None
            assert pre.release_exported(r["rid"], acked=True)
        dec.run_until_idle()
        for r in batch:
            want = np.asarray(j_generate(
                jparams, jnp.asarray(r["prompt"])[None], jcfg,
                max_new_tokens=r["max_new"], max_len=rc.MAX_LEN))[0]
            if not np.array_equal(dec.completed[r["rid"]].tokens, want):
                bad.append(r["rid"])
    return bad


def test_the_jax_engines_flip_the_same_rids(flagship):
    cfg, params, migrated = flagship
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    assert _jax_flips(cfg, jparams, migrated, "int8") == \
        list(bd.INT8_FLAGSHIP_FLIPS)
    # the flips are the codec's: f32 migration of those rids is bitwise
    flipped = [r for r in migrated if r["rid"] in bd.INT8_FLAGSHIP_FLIPS]
    assert _jax_flips(cfg, jparams, flipped, "f32") == []


def test_the_ports_engines_flip_the_same_rids(flagship):
    cfg, params, migrated = flagship

    def engine():
        return ServingEngine(params, cfg, PagedCacheConfig(**rc.CACHE),
                             BatcherConfig(slots=SLOTS), device="cpu")

    pre, bad = engine(), []
    for r in migrated:
        req = Request(rid=r["rid"], prompt=r["prompt"],
                      max_new_tokens=r["max_new"])
        out = pre.prefill_for_migration(req, codec="int8")
        dec = engine()
        assert dec.admit_migrated(req, out["first_token"], out["meta"],
                                  out["blob"]) is not None
        assert pre.release_exported(r["rid"], acked=True)
        dec.run_until_idle()
        want = generate(params, torch.as_tensor(r["prompt"])[None], cfg,
                        max_new_tokens=r["max_new"], max_len=rc.MAX_LEN)[0]
        if not np.array_equal(dec.completed[r["rid"]].tokens, want.numpy()):
            bad.append(r["rid"])
    assert bad == list(bd.INT8_FLAGSHIP_FLIPS)


def test_reference_flips_by_device_and_size():
    assert bd.reference_flips("cuda", N) == [4, 9]
    assert bd.reference_flips("cuda:0", 5) == [4]
    assert bd.reference_flips("cpu", N) == []


def _report(bad_rids, flips=(4, 9)):
    floors = {"all_completed_exactly_once": True, "launches_the_codes": True}
    runs = {name: {"ok": True, "floors": dict(floors),
                   "checks": {"bitwise_bad_rids": [], "reference_flips": []}}
            for name in bd.SCENARIOS}
    mig8 = runs["migration_int8"]
    mig8["floors"]["bitwise_vs_generate"] = not bad_rids
    mig8["ok"] = not bad_rids
    mig8["checks"] = {"bitwise_bad_rids": list(bad_rids),
                      "reference_flips": list(flips)}
    return {"ok": not bad_rids, "scenarios": runs}


def test_only_the_reference_flips_takes_that_failure_alone():
    assert bd.only_the_reference_flips(_report([4, 9]))
    # bitwise where the reference flips: not the reference's result
    assert not bd.only_the_reference_flips(_report([]))
    assert not bd.only_the_reference_flips(_report([4]))
    assert not bd.only_the_reference_flips(_report([4, 9, 13]))
    other = _report([4, 9])
    other["scenarios"]["migration_f32"]["floors"]["launches_the_codes"] = \
        False
    assert not bd.only_the_reference_flips(other)
    gone = _report([4, 9])
    del gone["scenarios"]["disagg_vs_colocated"]
    assert not bd.only_the_reference_flips(gone)
    crashed = _report([4, 9])
    crashed["scenarios"]["disagg_vs_colocated"]["error"] = "RuntimeError"
    assert not bd.only_the_reference_flips(crashed)
