"""The port's pool arbiter (``flextree_tpu_torch/arbiter/``) against the
JAX package's (``flextree_tpu/arbiter/``), on the CPU.

``DeviceInventory`` and ``PoolArbiter`` run the JAX suite's scripts
(``tests/test_arbiter.py``) on both packages' classes under the same
scripted SLO readings and the same injected wall clock: the same
decision records, ledger epochs, hook calls and flight-record events.
``pool_slo_reader`` reads a real port ``ReplicaPool`` that has served
requests, and ``file_slo_reader`` a metrics snapshot; the arbiter's
events render on the merged timeline's arbiter lane.
"""

from __future__ import annotations

import importlib
import json
import math

import numpy as np
import pytest
import torch

from flextree_tpu_torch import arbiter as tarb
from flextree_tpu_torch.arbiter import core as tcore
from flextree_tpu_torch.runtime import leases as tle

jarb = importlib.import_module("flextree_tpu.arbiter")
jcore = importlib.import_module("flextree_tpu.arbiter.core")
jle = importlib.import_module("flextree_tpu.runtime.leases")
SIDES = {"port": (tarb, tcore, tle), "jax": (jarb, jcore, jle)}


def _inventory_script(arb):
    out = []
    inv = arb.DeviceInventory([0, 1, 2, 3], train=(0, 1, 2))
    out += [inv.chips, inv.grants()]
    with pytest.raises(ValueError, match="held by"):
        inv.move((1, 3), "train", "arbiter")
    out.append(inv.held_by("train"))  # nothing moved
    out += [inv.take("train", 5, keep=1), inv.take("train", 1, keep=1),
            inv.grants(), inv.holder_of(2)]
    out.append(inv.move((1,), "arbiter", "serve"))
    again = arb.DeviceInventory.from_grants(inv.grants())
    out.append(again.grants())
    for bad, match in (([0, 0], "duplicate"), ([], "at least one")):
        with pytest.raises(ValueError, match=match):
            arb.DeviceInventory(bad)
    with pytest.raises(ValueError, match="unknown chips"):
        arb.DeviceInventory([0, 1], train=(7,))
    with pytest.raises(ValueError, match="not in the inventory"):
        arb.DeviceInventory([0]).holder_of(9)
    with pytest.raises(ValueError, match="granted to both"):
        arb.DeviceInventory.from_grants({"train": (0,), "serve": (0,)})
    return out


def test_device_inventory_matches_jax():
    port, jax_ = _inventory_script(tarb), _inventory_script(jarb)
    assert port == jax_
    assert port[3:5] == [(1, 2), ()] and port[6] == "arbiter"


def _readings(side):
    arb = SIDES[side][0]
    return dict(
        BREACH=arb.SloReading(p99_ms=800.0, samples=20),
        CLEAR=arb.SloReading(p99_ms=20.0, samples=20),
        IN_BAND=arb.SloReading(p99_ms=80.0, samples=20),
        THIN=arb.SloReading(p99_ms=9_000.0, samples=2),
        EMPTY=arb.SloReading(p99_ms=float("nan"), samples=0),
        ADMIT0=arb.SloReading(p99_ms=10.0, samples=20, admit_blocked=0.0),
        ADMIT10=arb.SloReading(p99_ms=10.0, samples=20, admit_blocked=10.0),
        ADMIT20=arb.SloReading(p99_ms=10.0, samples=20, admit_blocked=20.0),
    )


#: each script: (config overrides, [(reading, clock advance, ack train?)])
SCRIPTS = {
    "debounced_preempt_grant_after_ack_return": [
        ("BREACH", 1, False), ("BREACH", 1, False), ("BREACH", 1, False),
        ("BREACH", 1, True), ("CLEAR", 0.5, False), ("CLEAR", 0.5, False),
        ("CLEAR", 5.0, False), ("CLEAR", 1, False)],
    "hysteresis_band_holds": [
        ("BREACH", 1, False), ("BREACH", 1, False), ("BREACH", 1, True)]
    + [("IN_BAND", 1, False)] * 8,
    "thin_window_and_empty_clear": [("THIN", 1, False)] * 4 + [
        ("BREACH", 1, False), ("BREACH", 1, False), ("BREACH", 1, True),
        ("EMPTY", 4, False), ("EMPTY", 1, False)],
    "cooldown_blocks_re_preempt": [
        ("BREACH", 1, False), ("BREACH", 1, False), ("BREACH", 1, True),
        ("CLEAR", 4, False), ("CLEAR", 1, False), ("BREACH", 1, False),
        ("BREACH", 1, False), ("BREACH", 3, False)],
    "min_train_floor": [
        ("BREACH", 1, False), ("BREACH", 1, False), ("BREACH", 1, True),
        ("BREACH", 10, False), ("BREACH", 1, False), ("BREACH", 1, False)],
    "grant_restarts_cooldown": [
        ("BREACH", 1, False), ("BREACH", 1, False), ("CLEAR", 1, False),
        ("CLEAR", 1, False), ("CLEAR", 1, True), ("CLEAR", 1, False),
        ("CLEAR", 1, False), ("CLEAR", 2.5, False)],
}
CONFIG = dict(slo_p99_ms=100.0, window_s=5.0, release_frac=0.5,
              breach_ticks=2, clear_ticks=2, cooldown_s=3.0,
              min_train_chips=1, burst_chips=2, min_samples=5)


def _run_arbiter(side, tmp, monkeypatch, script, cfg=None):
    arb, core, le = SIDES[side]
    clock = {"now": 1000.0}
    monkeypatch.setattr(core, "_wall", lambda: clock["now"])
    monkeypatch.setattr(le, "_wall", lambda: clock["now"])
    events = []
    monkeypatch.setattr(core, "record_event",
                        lambda kind, **f: events.append((kind, f)))
    readings = _readings(side)
    cur = [readings[script[0][0]]]
    calls = []
    led = le.LeaseLedger(str(tmp))
    a = arb.PoolArbiter(
        arb.DeviceInventory([0, 1, 2, 3], train=(0, 1, 2)), led,
        arb.ArbiterConfig(**(cfg or CONFIG)), slo_reader=lambda: cur[0],
        on_serve_grant=lambda c: calls.append(("grant", tuple(c))),
        on_serve_return=lambda c: calls.append(("return", tuple(c))))
    decisions = []
    for name, dt, ack in script:
        cur[0] = readings[name]
        clock["now"] += dt
        if ack:
            led.ack("train", led.read().epoch)
        decisions.append(a.tick())
    g = led.read()
    return dict(decisions=json.dumps(decisions, sort_keys=True),
                ledger=(g.epoch, g.grants, g.reason), calls=calls,
                events=json.dumps(events, sort_keys=True),
                loaned=a.loaned, pending=a.pending_handoff,
                actions=[d["action"] for d in decisions])


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_pool_arbiter_decisions_match_jax(name, tmp_path, monkeypatch):
    port = _run_arbiter("port", tmp_path / "p", monkeypatch, SCRIPTS[name])
    jax_ = _run_arbiter("jax", tmp_path / "j", monkeypatch, SCRIPTS[name])
    assert port == jax_
    acts = port["actions"]
    if name == "debounced_preempt_grant_after_ack_return":
        # one tick is not a trend; no grant before training's ack
        assert acts == [None, "preempt", None, "grant", None, None,
                        "return", None]
        assert port["calls"] == [("grant", (1, 2)), ("return", (1, 2))]
        assert port["ledger"][1]["train"] == (0, 1, 2)
        kinds = [k for k, _ in json.loads(port["events"])]
        assert kinds == ["lease_grant", "slo_breach", "lease_preempt",
                         "lease_grant", "lease_return"]
    elif name == "hysteresis_band_holds":
        assert acts[2] == "grant" and acts.count("return") == 0
        assert port["loaned"] == (1, 2)
    elif name == "thin_window_and_empty_clear":
        assert acts[:4] == [None] * 4 and acts[-1] == "return"
    elif name == "cooldown_blocks_re_preempt":
        assert acts[-4:] == ["return", None, None, "preempt"]
    elif name == "min_train_floor":
        assert acts[2:] == ["grant", None, None, None]
        assert port["ledger"][1]["train"] == (0,)
    else:
        assert acts[4:] == ["grant", None, None, "return"]


def test_admit_blocked_growth_and_restart_match_jax(tmp_path, monkeypatch):
    cfg = dict(slo_p99_ms=100.0, breach_ticks=2, cooldown_s=0.5,
               admit_blocked_delta=5.0, min_samples=5)
    script = [("ADMIT0", 0, False), ("ADMIT10", 1, False),
              ("ADMIT20", 1, False)]
    port = _run_arbiter("port", tmp_path / "p", monkeypatch, script, cfg)
    jax_ = _run_arbiter("jax", tmp_path / "j", monkeypatch, script, cfg)
    assert port == jax_
    assert port["actions"] == [None, None, "preempt"]
    # a restart against the same heartbeat dir supersedes the prior
    # ledger with a newer epoch and finishes the parked handoff
    led = tle.LeaseLedger(str(tmp_path / "p"))
    before = led.read().epoch
    a2 = tarb.PoolArbiter(
        tarb.DeviceInventory.from_grants(led.read().grants), led,
        tarb.ArbiterConfig(slo_p99_ms=100.0),
        slo_reader=lambda: tarb.SloReading(p99_ms=1.0, samples=20))
    assert led.read().epoch == before + 1
    assert a2.pending_handoff == (1, 2)
    led.ack("train", before)
    assert a2.tick()["action"] == "grant" and a2.loaned == (1, 2)


class _Eng:
    def __init__(self, registry):
        self.metrics = registry


def test_pool_slo_reader_over_a_port_pool(tmp_path):
    """A real port pool of two tiny engines serves requests on the CPU;
    the reader merges the alive replicas' windowed TTFT and sums their
    admit-blocked counters, enforces the window, and a released replica
    stops counting."""
    from flextree_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )
    from flextree_tpu_torch.obs.metrics import merged_window_percentile
    from flextree_tpu_torch.serving import (
        BatcherConfig,
        PagedCacheConfig,
        PoolConfig,
        ReplicaPool,
        Request,
        ServingEngine,
    )

    cfg = TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                            n_layers=2, d_ff=64)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")

    def engine():
        return ServingEngine(params, cfg, PagedCacheConfig(
            num_blocks=24, block_size=8, blocks_per_seq=4),
            BatcherConfig(slots=2), slo_window_s=6.0, device="cpu")

    pool = ReplicaPool([engine(), engine()],
                       PoolConfig(heartbeat_dir=str(tmp_path / "hb"),
                                  interval_s=0.05))
    try:
        for rid in range(6):
            pool.submit(Request(rid=rid, prompt=np.arange(
                3 + rid % 3, dtype=np.int32), max_new_tokens=3))
        pool.run_until_idle()
        with pytest.raises(ValueError, match="lease window"):
            tarb.pool_slo_reader(pool, window_s=10.0)()
        reading = tarb.pool_slo_reader(pool, window_s=6.0)()
        hists = [r.engine.metrics.windowed_histogram("serve.ttft_ms")
                 for r in pool.replicas]
        p99, n = merged_window_percentile(hists, 99.0)
        assert reading.samples == n == 6
        assert reading.p99_ms == p99 and math.isfinite(p99) and p99 > 0
        pool.release_replica(1)
        after = tarb.pool_slo_reader(pool)()
        assert after.samples == hists[0].window_counts()[1] < 6
    finally:
        pool.shutdown()


def test_file_slo_reader_reads_a_snapshot(tmp_path):
    """The cross-process reader: a registry snapshot on disk reads back
    as the same windowed percentile; a torn file is no evidence."""
    from flextree_tpu_torch.obs.metrics import MetricsRegistry

    reg = MetricsRegistry()
    h = reg.windowed_histogram("serve.ttft_ms", interval_s=1.0, intervals=10)
    for v in (5.0, 50.0, 500.0):
        h.observe(v)
    (tmp_path / "metrics_fd_0.json").write_text(json.dumps(reg.snapshot()))
    (tmp_path / "metrics_fd_1.json").write_text("{torn")
    reading = tarb.file_slo_reader(str(tmp_path), window_s=10.0)()
    assert reading.samples == 3 and reading.p99_ms >= 50.0
    with pytest.raises(ValueError, match="lease window"):
        tarb.file_slo_reader(str(tmp_path), window_s=4.0)()


def test_arbiter_events_render_on_the_arbiter_lane(tmp_path, monkeypatch):
    from flextree_tpu_torch.obs import flight_recorder
    from flextree_tpu_torch.obs.timeline import merge_events, validate_trace

    clock = {"now": 1000.0}
    monkeypatch.setattr(tcore, "_wall", lambda: clock["now"])
    r = _readings("port")
    cur = [r["BREACH"]]
    with flight_recorder(str(tmp_path / "obs"), rank=0) as rec:
        led = tle.LeaseLedger(str(tmp_path / "hb"))
        a = tarb.PoolArbiter(
            tarb.DeviceInventory([0, 1, 2, 3], train=(0, 1, 2)), led,
            tarb.ArbiterConfig(**CONFIG), slo_reader=lambda: cur[0])
        for step in range(3):
            clock["now"] += 1
            a.tick()
            if a.pending_handoff:
                led.ack("train", led.read().epoch)
    doc = merge_events(rec.events)
    assert validate_trace(doc) == []
    lane = [ev for ev in doc["traceEvents"]
            if ev.get("ph") == "i" and ev.get("tid") == 2]
    assert [ev["name"] for ev in lane] == [
        "lease_grant", "slo_breach", "lease_preempt", "lease_grant"]
    assert lane[1]["args"]["p99_ms"] == 800.0
