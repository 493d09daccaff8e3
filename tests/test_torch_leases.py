"""The port's chip-lease protocol (``flextree_tpu_torch/runtime/leases.py``)
against the JAX package's (``flextree_tpu/runtime/leases.py``), on the
CPU: the ledger's mechanics, both lease clients under one scripted clock,
the coordinated client that proposes instead of directing, and the two
fences (the control epoch, serving's drain) — each run on both packages'
classes over the same script, with the same directives, acks and files.
"""

from __future__ import annotations

import importlib
from pathlib import Path

import pytest

from flextree_tpu_torch.runtime import coordination as tco
from flextree_tpu_torch.runtime import leases as tle

jle = importlib.import_module("flextree_tpu.runtime.leases")
jco = importlib.import_module("flextree_tpu.runtime.coordination")
SIDES = {"port": (tle, tco), "jax": (jle, jco)}


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(Path(d).iterdir())}


def _ledger_script(le, d, monkeypatch):
    monkeypatch.setattr(le, "_wall", lambda: 77.0)
    led = le.LeaseLedger(str(d))
    out = [led.read()]
    led.publish(0, {"train": (2, 0, 1), "serve": (3,)}, reason="initial")
    out.append(led.read())
    with pytest.raises(ValueError, match="epoch must increase"):
        led.publish(0, {"train": (0,)})
    with pytest.raises(ValueError, match="granted to both"):
        led.publish(1, {"train": (0, 1), "serve": (1,)})
    out += [led.acked_epoch("train"), led.acked_control_epoch("train")]
    led.ack("train", 0)
    led.ack("serve", 0, control_epoch=4)
    out += [led.acked_epoch("train"), led.acked_control_epoch("train"),
            led.acked_epoch("serve"), led.acked_control_epoch("serve"),
            led.read_ack("serve")]
    return out


def test_ledger_mechanics_and_files_match_jax(tmp_path, monkeypatch):
    port = _ledger_script(tle, tmp_path / "p", monkeypatch)
    jax_ = _ledger_script(jle, tmp_path / "j", monkeypatch)
    assert [repr(x) for x in port] == [repr(x) for x in jax_]
    assert port[1].chips("train") == (0, 1, 2) and port[1].epoch == 0
    assert port[-1] == {"holder": "serve", "epoch": 0, "wall": 77.0,
                        "control_epoch": 4}
    assert _files(tmp_path / "p") == _files(tmp_path / "j")
    # either package's reader takes the other's ledger
    assert jle.LeaseLedger(str(tmp_path / "p")).read().to_payload() == \
        tle.LeaseLedger(str(tmp_path / "j")).read().to_payload()
    (tmp_path / "p" / "lease_ledger.json").write_text("{torn")
    assert tle.LeaseLedger(str(tmp_path / "p")).read() is None


def _train_client_script(le, d):
    led = le.LeaseLedger(str(d))
    clock = {"now": 0.0}
    c = le.TrainLeaseClient(led, _mono=lambda: clock["now"],
                            poll_interval_s=1.0)
    out = []
    led.publish(0, {"train": (0, 1, 2)})
    out += [c.poll(0), c.chips, c.configured, led.acked_epoch("train")]
    led.publish(1, {"train": (0,), "arbiter": (1, 2)}, reason="breach")
    out.append(c.poll(1))  # inside the poll interval: no read
    clock["now"] = 1.0
    d1 = c.poll(5)
    out += [d1, led.acked_epoch("train")]
    c.ack(d1)
    out += [led.acked_epoch("train"), c.chips, c.configured]
    led.publish(2, {"train": (0,), "serve": (1, 2)})
    clock["now"] = 2.0
    out += [c.poll(6), led.acked_epoch("train")]  # unchanged: acked in place
    # a client that knows its build world turns a first-poll revocation
    # into a directive instead of acking it
    led2 = le.LeaseLedger(str(d) + "_2")
    led2.publish(1, {"train": (0,), "arbiter": (1, 2)}, reason="breach")
    c2 = le.TrainLeaseClient(led2, initial_chips=(0, 1, 2),
                             poll_interval_s=0.0)
    out += [c2.poll(0), led2.acked_epoch("train")]
    return out


def test_train_lease_client_matches_jax(tmp_path):
    port = _train_client_script(tle, tmp_path / "p")
    jax_ = _train_client_script(jle, tmp_path / "j")
    assert [repr(x) for x in port] == [repr(x) for x in jax_]
    assert port[4] is None
    assert port[5] == tle.ResizeDirective(epoch=1, chips=(0,),
                                          reason="breach")
    assert port[6] == 0 and port[7] == 1 and port[8] == (0,)
    assert port[9] == 3 and port[10:12] == [None, 2]
    assert port[12] == tle.ResizeDirective(epoch=1, chips=(0,),
                                           reason="breach")
    assert port[13] == -1


def _coordinated_script(le, co, d):
    ledger = le.LeaseLedger(str(d))
    ledger.publish(0, {"train": (0, 1, 2, 3)})
    handle = co.CoordinationHandle(str(d), 0, membership=None)
    client = le.TrainLeaseClient(ledger, initial_chips=(0, 1, 2, 3),
                                 coordination=handle, poll_interval_s=0.0,
                                 nbytes_hint=1 << 20)
    out = [client.poll(0)]
    ledger.publish(1, {"train": (0, 1), "arbiter": (2, 3)})
    out.append(client.poll(1))  # proposed, not directed
    prop, _ = handle.ledger.read_proposal()
    out.append((prop.kind, prop.payload, prop.participants))
    with pytest.raises(co.ProtocolViolation, match="control epoch"):
        client.ack(le.ResizeDirective(epoch=1, chips=(0, 1)))
    out.append(ledger.acked_epoch("train"))
    assert handle.gate(step=2) is None  # self-ack -> commit
    dec = handle.gate(step=2)
    directive = le.ResizeDirective(
        epoch=dec.payload["lease_epoch"], chips=tuple(dec.payload["chips"]),
        control_epoch=dec.epoch, topo=dec.payload["topo"])
    client.ack(directive)
    handle.mark_applied(dec)
    out += [dec.kind, dec.epoch, ledger.acked_epoch("train"),
            ledger.acked_control_epoch("train"), client.chips]
    return out


def test_coordinated_client_proposes_and_fences_like_jax(tmp_path):
    port = _coordinated_script(tle, tco, tmp_path / "p")
    jax_ = _coordinated_script(jle, jco, tmp_path / "j")
    assert [repr(x) for x in port] == [repr(x) for x in jax_]
    kind, payload, participants = port[2]
    assert kind == "resize" and payload["lease_epoch"] == 1
    assert payload["chips"] == [0, 1] and payload["topo"]
    assert port[4:] == ["resize", 0, 1, 0, (0, 1)]


def _serve_script(le, co, d):
    TRAIN, SERVE, ARBITER = le.TRAIN, le.SERVE, le.ARBITER
    led = le.LeaseLedger(str(d))
    led.publish(1, {TRAIN: ("c0",), SERVE: ("c1",), ARBITER: ()})
    inflight = {"n": 2}
    calls = []
    client = le.ServeLeaseClient(
        led, inflight=lambda: inflight["n"], initial_chips=("c1",),
        poll_interval_s=0.0,
        on_revoke=lambda chips: calls.append(("revoke", tuple(chips))),
        on_grant=lambda chips: calls.append(("grant", tuple(chips))))
    led.publish(2, {TRAIN: ("c0",), SERVE: (), ARBITER: ("c1",)})
    d2 = client.poll()
    out = [d2]
    with pytest.raises(co.ProtocolViolation, match="in flight"):
        client.ack(d2)
    out.append(led.acked_epoch(SERVE))  # the fence wrote no ack
    inflight["n"] = 0
    client.apply(d2)
    out += [led.acked_epoch(SERVE), client.chips]
    led.publish(3, {TRAIN: (), SERVE: ("c0", "c1"), ARBITER: ()})
    d3 = client.poll()
    client.apply(d3)
    out += [d3, calls, led.acked_epoch(SERVE), client.chips]
    coordinated = le.ServeLeaseClient(led, coordination=object(),
                                      initial_chips=())
    with pytest.raises(co.ProtocolViolation, match="control epoch"):
        coordinated.ack(le.ServeDirective(epoch=4, chips=("c0",)))
    return out


def test_serve_lease_client_drain_fence_matches_jax(tmp_path):
    port = _serve_script(tle, tco, tmp_path / "p")
    jax_ = _serve_script(jle, jco, tmp_path / "j")
    assert [repr(x) for x in port] == [repr(x) for x in jax_]
    assert port[0].revoked == ("c1",) and port[1] == -1
    assert port[2] == 2 and port[3] == ()
    assert port[4].added == ("c0", "c1")
    assert port[5] == [("revoke", ("c1",)), ("grant", ("c0", "c1"))]


def test_the_model_handoff_replays_on_the_real_ledger(tmp_path):
    """The lease model's nominal revoke → ack → grant trace, written
    through the port's ledger: every write accepted in order, one ack
    document carrying both the epoch and the control stamp."""
    TRAIN, SERVE, ARBITER = tle.TRAIN, tle.SERVE, tle.ARBITER
    led = tle.LeaseLedger(str(tmp_path))
    led.publish(1, {TRAIN: ("c0", "c1"), SERVE: (), ARBITER: ()})
    led.publish(2, {TRAIN: ("c0",), SERVE: (), ARBITER: ("c1",)})
    led.ack(TRAIN, epoch=2, control_epoch=7)
    doc = led.read_ack(TRAIN)
    assert (doc["epoch"], doc["control_epoch"]) == (2, 7)
    led.publish(3, {TRAIN: ("c0",), SERVE: ("c1",), ARBITER: ()})
    assert led.read().chips(SERVE) == ("c1",)
    # the model's holders are the implementation's
    from flextree_tpu_torch.runtime.lease_model import LeaseModel

    _, grants, _, _, _, _ = LeaseModel().initial()
    assert tuple(h for h, _ in grants) == (TRAIN, SERVE, ARBITER)
