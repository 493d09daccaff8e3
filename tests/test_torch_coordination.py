"""The port's coordinated control plane
(``flextree_tpu_torch/runtime/coordination.py``) against the JAX
package's (``flextree_tpu/runtime/coordination.py``), on the CPU.

- decision fingerprints are the JAX package's for seeded payloads;
- the control files are one format: a JAX ledger's proposal, acks and
  commit read in the port, the port's in the JAX package, byte for byte
  the same files under one clock;
- scripted handshakes with injected clocks give the same epochs,
  payloads, apply steps and flight-record events on both sides: the happy
  path, coordinator death at propose, ack-wait and commit, a stalled
  follower fenced, a stale replay refused;
- a seeded randomized-interleavings check (coordinator kills at random
  ticks) holds the invariants — one apply sequence for every survivor,
  no epoch applied twice, the commit the proposal's fingerprint — and
  gives the JAX package's sequences.
"""

from __future__ import annotations

import importlib
import os
import random

import numpy as np
import pytest

from flextree_tpu_torch.runtime import coordination as tco
from flextree_tpu_torch.runtime import ctrlfile as tcf

jco = importlib.import_module("flextree_tpu.runtime.coordination")
jcf = importlib.import_module("flextree_tpu.runtime.ctrlfile")
SIDES = {"port": tco, "jax": jco}


def _seeded_payload(rng):
    return {
        "topo": rng.choice(["4", "2,2", "ring", "3,2+1"]),
        "alive": int(rng.integers(1, 9)),
        "dead": sorted(int(r) for r in rng.choice(8, 2, replace=False)),
        "params": {f"k{i}": float(rng.standard_normal()) for i in range(4)},
        "nested": [{"x": int(rng.integers(0, 100))}, "s", None, True],
    }


def test_fingerprints_equal_jax_for_seeded_payloads():
    rng = np.random.default_rng(19)
    for kind in tco.DECISION_KINDS:
        for _ in range(8):
            payload = _seeded_payload(rng)
            assert tco.decision_fingerprint(kind, payload) == \
                jco.decision_fingerprint(kind, payload)
    assert tco.DECISION_KINDS == jco.DECISION_KINDS
    a = tco.decision_fingerprint("replan", {"topo": "4", "x": 1})
    assert a == tco.decision_fingerprint("replan", {"x": 1, "topo": "4"})
    assert a != tco.decision_fingerprint("replan", {"topo": "2,2", "x": 1})


def _write_round(mod, d, monkeypatch):
    monkeypatch.setattr(mod, "_wall", lambda: 500.0)
    led = mod.CoordLedger(str(d))
    dec = mod.ControlDecision(3, "shrink", {"alive": 2, "dead": [2],
                                            "topo": "2"}, (0, 1), 0,
                              apply_step=7, wall=400.0)
    led.publish_proposal(dec, ack_deadline_wall=410.0)
    led.ack(0, 3, extra={"drift": {"k": {"median": 1.5, "count": 4}}})
    led.ack(1, 3)
    led.publish_commit(dec)
    return dec


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_control_files_cross_read(writer, tmp_path, monkeypatch):
    """One side writes proposal, acks and commit; the other reads them
    back, and both sides' files are the same bytes."""
    reader = "port" if writer == "jax" else "jax"
    wmod, rmod = SIDES[writer], SIDES[reader]
    dec = _write_round(wmod, tmp_path / "w", monkeypatch)
    _write_round(rmod, tmp_path / "r", monkeypatch)
    names = sorted(os.listdir(tmp_path / "w"))
    assert names == sorted(os.listdir(tmp_path / "r")) == [
        "coord_ack_00000.json", "coord_ack_00001.json",
        "coord_commit.json", "coord_proposal.json"]
    for n in names:
        assert (tmp_path / "w" / n).read_bytes() == \
            (tmp_path / "r" / n).read_bytes(), n
    led = rmod.CoordLedger(str(tmp_path / "w"))
    prop, deadline = led.read_proposal()
    assert deadline == 410.0
    commit = led.read_commit()
    for got in (prop, commit):
        assert (got.epoch, got.kind, got.payload, got.participants,
                got.coordinator, got.apply_step, got.wall) == (
            dec.epoch, dec.kind, dec.payload, dec.participants,
            dec.coordinator, dec.apply_step, dec.wall)
        assert got.fingerprint == dec.fingerprint
    assert led.read_acks() == {0: 3, 1: 3}
    assert led.read_ack_docs()[0]["drift"] == {"k": {"median": 1.5,
                                                     "count": 4}}
    assert led.next_epoch() == 4
    # the reader's own handle refuses to replay the sealed epoch
    with pytest.raises(rmod.ProtocolViolation, match="must increase"):
        led.publish_proposal(dec, ack_deadline_wall=0.0)
    # and the trailer is the shared ctrlfile's, whichever package wrote
    raw = (tmp_path / "w" / "coord_commit.json").read_bytes()
    assert tcf.read_control_json(str(tmp_path / "w" / "coord_commit.json")) \
        == jcf.read_control_json(str(tmp_path / "w" / "coord_commit.json"))
    assert raw.splitlines()[-1].startswith(b'{"crc32": ')


def test_ledger_rules(tmp_path):
    """The ledger's epoch rules, as the JAX suite pins them."""
    led = tco.CoordLedger(str(tmp_path))
    d0 = tco.ControlDecision(0, "replan", {"topo": "4"}, (0, 1), 0)
    led.publish_proposal(d0, ack_deadline_wall=10.0)
    with pytest.raises(tco.ProtocolViolation, match="must increase"):
        led.publish_proposal(
            tco.ControlDecision(0, "replan", {"topo": "2,2"}, (0, 1), 0), 10.0)
    assert led.next_epoch() == 1
    d3 = tco.ControlDecision(3, "replan", {"topo": "4"}, (0, 1), 0)
    assert led.publish_commit(d3) is True
    assert led.publish_commit(d3) is False  # the failover race: a no-op
    with pytest.raises(tco.ProtocolViolation, match="two decisions"):
        led.publish_commit(
            tco.ControlDecision(3, "replan", {"topo": "2,2"}, (0, 1), 0))
    with pytest.raises(tco.ProtocolViolation, match="backwards"):
        led.publish_commit(
            tco.ControlDecision(2, "replan", {"topo": "4"}, (0, 1), 0))
    (tmp_path / "coord_ack_00007.json").write_text("{garbage")
    led.ack(0, 4)
    led.ack(2, 3)
    assert led.read_acks() == {0: 4, 2: 3}
    (tmp_path / "coord_proposal.json").write_text('{"epoch": 9')
    assert led.read_proposal() is None


# ---------------------------------------------------- scripted handshakes


def _handles(mod, d, members, n, cfg=None, sleep=None):
    return [mod.CoordinationHandle(str(d), r, membership=lambda: dict(members),
                                   cfg=cfg, _sleep=sleep or (lambda s: None))
            for r in range(n)]


def _capture_events(mod, monkeypatch):
    events = []

    def record(self, kind, **fields):
        events.append((self.rank, kind, tuple(sorted(
            (k, repr(v)) for k, v in fields.items()))))

    monkeypatch.setattr(mod.CoordinationHandle, "_record", record)
    return events


def _scenario(mod, name, d, monkeypatch):
    """Run one scripted handshake; return what the two sides must agree
    on: each handle's applies and the final slots, plus the events."""
    now = {"t": 100.0}
    monkeypatch.setattr(mod, "_wall", lambda: now["t"])
    events = _capture_events(mod, monkeypatch)
    out: dict = {}
    cfg = mod.CoordinationConfig(ack_timeout_s=5.0)
    if name == "happy":
        members = {r: "healthy" for r in range(3)}
        hs = _handles(mod, d, members, 3, cfg)
        out["epoch"] = hs[0].propose("replan", {"topo": "3"}, apply_step=5)
        out["follower_propose"] = hs[1].propose("replan", {"topo": "3"})
        for h in hs[1:]:
            assert h.gate(step=2) is None
        assert hs[0].gate(step=2) is None  # every ack in: commit
        for h in hs:
            assert h.gate(step=4) is None  # held until the boundary
            dec = h.gate(step=5)
            h.mark_applied(dec)
        with pytest.raises(mod.ProtocolViolation, match="double-apply"):
            hs[0].mark_applied(dec)
    elif name == "death_at_propose":
        members = {r: "healthy" for r in range(3)}
        hs = _handles(mod, d, members, 3, cfg)
        hs[0].propose("replan", {"topo": "3"})
        os.unlink(os.path.join(d, "coord_ack_00000.json"))
        members[0] = "dead"
        for h in hs[1:]:
            assert h.gate(step=0) is None
        now["t"] += 10.0  # past the ack deadline: the successor proposes
        for r in (1, 2, 1):
            assert hs[r].gate(step=0) is None
        for h in hs[1:]:
            h.mark_applied(h.gate(step=1))
    elif name == "death_at_ackwait":
        members = {r: "healthy" for r in range(3)}
        hs = _handles(mod, d, members, 3, cfg)
        hs[0].propose("replan", {"topo": "ring"})
        for h in hs[1:]:
            assert h.gate(step=0) is None
        members[0] = "dead"  # every ack in, the commit unwritten
        assert hs[1].gate(step=0) is None  # the successor completes it
        for h in hs[1:]:
            h.mark_applied(h.gate(step=1))
    elif name == "death_at_commit":
        members = {r: "healthy" for r in range(3)}
        hs = _handles(mod, d, members, 3, cfg)
        hs[0].propose("replan", {"topo": "3"})
        for r in (1, 2, 0):
            assert hs[r].gate(step=0) is None
        members[0] = "dead"
        for h in hs[1:]:
            h.mark_applied(h.gate(step=1))
        assert hs[1].gate(step=2) is None  # nothing new in flight
    elif name == "stalled_fenced":
        members = {r: "healthy" for r in range(3)}
        hs = _handles(mod, d, members, 3, cfg)
        hs[0].propose("replan", {"topo": "3"})
        assert hs[1].gate(step=0) is None  # rank 2 is frozen
        now["t"] += 6.0
        members[2] = "straggler"
        for r in (0, 1, 0):
            assert hs[r].gate(step=0) is None  # re-propose, ack, commit
        for h in hs[:2]:
            h.mark_applied(h.gate(step=1))
        with pytest.raises(mod.EpochFenced, match="excluded"):
            hs[2].gate(step=1)
        out["phase2"] = hs[2].phase
    elif name == "stale_replay":
        hs = _handles(mod, d, {0: "healthy"}, 1, cfg)
        led = hs[0].ledger
        led.publish_commit(mod.ControlDecision(5, "replan", {"t": 1}, (0,), 0))
        with pytest.raises(mod.ProtocolViolation):
            led.publish_proposal(
                mod.ControlDecision(4, "replan", {"t": 0}, (0,), 0), 0.0)
        out["next"] = led.next_epoch()
        # a sealed decision this rank has not applied: apply it first
        out["propose"] = [hs[0].propose("replan", {"t": 2})]
        hs[0].mark_applied(hs[0].gate(step=0))
        out["propose"].append(hs[0].propose("replan", {"t": 2}))
    led = mod.CoordLedger(str(d))
    prop, commit = led.read_proposal(), led.read_commit()
    out["proposal"] = None if prop is None else prop[0].to_payload()
    out["commit"] = None if commit is None else commit.to_payload()
    out["acks"] = led.read_acks()
    out["applied"] = [h.applied for h in hs]
    out["events"] = events
    return out


SCENARIOS = ["happy", "death_at_propose", "death_at_ackwait",
             "death_at_commit", "stalled_fenced", "stale_replay"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_scripted_handshake_matches_jax(name, tmp_path, monkeypatch):
    port = _scenario(tco, name, str(tmp_path / "port"), monkeypatch)
    jax_ = _scenario(jco, name, str(tmp_path / "jax"), monkeypatch)
    assert port == jax_
    kinds = [k for _, k, _ in port["events"]]
    if name == "happy":
        assert port["epoch"] == 0 and port["follower_propose"] is None
        assert port["applied"] == [[0], [0], [0]]
        assert port["commit"]["apply_step"] == 5
    elif name == "death_at_propose":
        assert port["commit"]["epoch"] == 1 and port["commit"]["coordinator"] \
            == 1 and 0 not in port["commit"]["participants"]
        assert port["applied"][1:] == [[1], [1]]
        assert "coord_repropose" in kinds and "coord_failover" in kinds
        assert port["commit"]["fingerprint"] == \
            tco.decision_fingerprint("replan", {"topo": "3"})
    elif name == "death_at_ackwait":
        assert port["commit"]["epoch"] == 0 and port["applied"][1:] == \
            [[0], [0]]
        assert "coord_repropose" not in kinds
    elif name == "death_at_commit":
        assert port["applied"][1:] == [[0], [0]]
        assert kinds.count("coord_commit") == 1
    elif name == "stalled_fenced":
        assert port["commit"]["participants"] == [0, 1]
        assert port["applied"] == [[1], [1], []]
        assert (2, "coord_fence") in [(r, k) for r, k, _ in port["events"]]
    else:
        assert port["next"] == 6 and port["propose"] == [None, 6]
        assert port["applied"] == [[5]]


def test_abandoned_boundary_raises_typed(tmp_path, monkeypatch):
    """A rank that acked a boundary nobody resolves raises
    ``CoordinationAbandoned`` instead of hanging, as the JAX one does."""
    for mod, d in ((tco, tmp_path / "p"), (jco, tmp_path / "j")):
        now = {"t": 100.0}
        monkeypatch.setattr(mod, "_wall", lambda: now["t"])
        members = {0: "dead", 1: "healthy", 2: "dead"}
        h1 = mod.CoordinationHandle(
            str(d), 1, membership=lambda: dict(members),
            cfg=mod.CoordinationConfig(resolve_timeout_s=10.0,
                                       ack_timeout_s=5.0),
            _sleep=lambda s: now.__setitem__("t", now["t"] + 1.0))
        mod.CoordLedger(str(d)).publish_proposal(
            mod.ControlDecision(0, "replan", {"topo": "3"}, (0, 1, 2), 0,
                                apply_step=4), ack_deadline_wall=105.0)
        monkeypatch.setattr(type(h1), "_drive", lambda self, prop: None)
        assert h1.gate(step=0) is None
        assert h1.phase == "ack_wait"
        with pytest.raises(mod.CoordinationAbandoned):
            h1.gate(step=4)
        assert now["t"] >= 110.0


# ------------------------------------------- randomized interleavings


def _random_run(mod, d, seed, monkeypatch):
    rng = random.Random(seed)
    n = rng.choice([3, 4, 5])
    now = {"t": 1000.0}
    monkeypatch.setattr(mod, "_wall", lambda: now["t"])
    members = {r: "healthy" for r in range(n)}
    hs = _handles(mod, d, members, n, mod.CoordinationConfig(ack_timeout_s=5.0))
    payload = {"topo": "3", "seed": seed}
    hs[0].propose("replan", payload)
    kill_at = rng.choice([None, 0, 1, 2, 3, 5, 8])
    fenced: set = set()
    applied: dict = {r: [] for r in range(n)}
    for tick in range(40):
        if tick == kill_at:
            members[0] = "dead"
            ackf = os.path.join(d, "coord_ack_00000.json")
            if rng.random() < 0.5 and os.path.exists(ackf):
                os.unlink(ackf)
        order = [r for r in range(n) if members[r] == "healthy"]
        rng.shuffle(order)
        for r in order:
            if r in fenced:
                continue
            try:
                dec = hs[r].gate(step=tick)
            except mod.EpochFenced:
                fenced.add(r)
                continue
            if dec is not None:
                hs[r].mark_applied(dec)
                applied[r].append((dec.epoch, dec.fingerprint))
        now["t"] += 1.0
    survivors = [r for r in range(n)
                 if members[r] == "healthy" and r not in fenced]
    commit = hs[survivors[0]].ledger.read_commit()
    return n, survivors, commit, applied, payload


@pytest.mark.parametrize("seed", range(6))
def test_random_interleavings_hold_the_invariants(seed, tmp_path,
                                                  monkeypatch):
    n, survivors, commit, applied, payload = _random_run(
        tco, str(tmp_path / "port"), seed, monkeypatch)
    assert survivors, "every rank died or was fenced"
    assert commit is not None, "the decision never committed"
    assert commit.fingerprint == tco.decision_fingerprint("replan", payload)
    seqs = {tuple(applied[r]) for r in survivors}
    assert len(seqs) == 1, f"divergent apply sequences: {seqs}"
    (seq,) = seqs
    epochs = [e for e, _ in seq]
    assert epochs and epochs == sorted(set(epochs))
    assert epochs[-1] == commit.epoch
    # the JAX package's handles, under the same schedule, apply the same
    jn, jsurv, jcommit, japplied, _ = _random_run(
        jco, str(tmp_path / "jax"), seed, monkeypatch)
    assert (jn, jsurv, jcommit.to_payload(), japplied) == \
        (n, survivors, commit.to_payload(), applied)


def test_torn_control_files_mid_handshake(tmp_path):
    """A scribbler truncating the proposal and commit between ticks never
    wedges or corrupts the protocol: the CRC refuses the torn read."""
    rng = random.Random(42)
    members = {r: "healthy" for r in range(3)}
    d = str(tmp_path)
    hs = _handles(tco, d, members, 3)
    hs[0].propose("replan", {"topo": "3"})
    applied: dict = {r: [] for r in range(3)}
    for tick in range(30):
        for name in ("coord_proposal.json", "coord_commit.json"):
            path = os.path.join(d, name)
            if rng.random() < 0.4 and os.path.exists(path):
                with open(path, "rb") as f:
                    raw = f.read()
                with open(path + ".torn", "wb") as f:
                    f.write(raw[:rng.randrange(1, len(raw))])
                os.replace(path + ".torn", path)
                with open(path, "wb") as f:
                    f.write(raw)
        for r in range(3):
            dec = hs[r].gate(step=tick)
            if dec is not None:
                hs[r].mark_applied(dec)
                applied[r].append(dec.epoch)
    assert applied[0] == applied[1] == applied[2] == [0]


# ------------------------------------------------------ follower drift


def test_acks_ship_the_drift_provider_and_peer_drift_reads_them(tmp_path):
    members = {r: "healthy" for r in range(3)}
    hs = _handles(tco, str(tmp_path), members, 3)
    mine = {"k": {"median": 9.0, "count": 4}}
    theirs = {"k": {"median": 2.0, "count": 8}}
    hs[0].drift_provider = lambda: mine
    hs[2].drift_provider = lambda: theirs
    hs[1].drift_provider = lambda: (_ for _ in ()).throw(
        RuntimeError("detector broken"))
    hs[0].propose("replan", {"topo": "3"}, apply_step=9)
    for h in hs[1:]:
        assert h.gate(step=1) is None  # a raising provider still acks
    docs = hs[0].ledger.read_ack_docs()
    assert docs[2]["drift"] == theirs and "drift" not in docs[1]
    assert hs[0].ledger.read_acks() == {0: 0, 1: 0, 2: 0}
    assert hs[0].peer_drift() == {2: theirs}
    assert hs[0].peer_drift(min_epoch=0) == {2: theirs}
    assert hs[0].peer_drift(min_epoch=1) == {}
    # the JAX handle reads the same pooled view off the port's files
    jh = jco.CoordinationHandle(str(tmp_path), 0, membership=None)
    assert jh.peer_drift() == {2: theirs}


def test_coordination_events_render_on_their_lane(tmp_path):
    """The flight record of a handshake renders on the merged timeline's
    coordination lane."""
    from flextree_tpu_torch.obs import flight_recorder
    from flextree_tpu_torch.obs.timeline import merge_events, validate_trace

    members = {r: "healthy" for r in range(2)}
    with flight_recorder(str(tmp_path / "obs"), rank=0) as rec:
        hs = _handles(tco, str(tmp_path / "hb"), members, 2)
        hs[0].propose("replan", {"topo": "2"})
        hs[1].gate(step=0)
        hs[0].gate(step=0)
        for h in hs:
            h.mark_applied(h.gate(step=1))
    events = [dict(e, rank=e.get("coord_rank", e.get("rank", 0)))
              for e in rec.events]
    doc = merge_events(events)
    assert validate_trace(doc) == []
    lane = {ev["name"] for ev in doc["traceEvents"]
            if ev.get("ph") == "i" and ev.get("tid") == 3}
    assert {"coord_propose", "coord_ack", "coord_commit",
            "coord_apply"} <= lane
