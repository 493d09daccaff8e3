"""The port's runtime and telemetry copies against the JAX package's:

- CRC-trailered control files: each package reads what the other writes
  (the same bytes), and a torn or tampered file is refused by both;
- heartbeat membership: the port's ``MembershipView`` classifies the same
  beat directory as the JAX one under the same injected wall clock
  (healthy, straggler, dead, an EWMA outlier, a never-beaten rank, a
  clock that steps back);
- rank-tagged loggers, the flight recorder's dumps and metrics snapshot,
  and the Prometheus text exposition (equal to JAX's on the same
  snapshots).
"""

import json
import os
import signal
from pathlib import Path

import pytest

from flextree_tpu.obs import metrics as jmetrics
from flextree_tpu.runtime import ctrlfile as jctrl
from flextree_tpu.runtime import supervisor as jsup
from flextree_tpu.utils import logging as jlogging
from flextree_tpu_torch.obs import (
    MetricsRegistry,
    flight_recorder,
    install_signal_dump,
    prometheus_exposition,
    record_event,
)
from flextree_tpu_torch.obs import recorder as trecorder
from flextree_tpu_torch.runtime import ctrlfile as tctrl
from flextree_tpu_torch.runtime import supervisor as tsup
from flextree_tpu_torch.utils import logging as tlogging

DOC = {"rank": 3, "host": "127.0.0.1", "port": 4711, "role": "decode",
       "entries": [{"prefix": [1, 2, 3, 4], "hash": "0badf00d"}]}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_control_files_cross_read(tmp_path, writer):
    w, r = (tctrl, jctrl) if writer == "port" else (jctrl, tctrl)
    path = str(tmp_path / "rpc_00003.json")
    w.write_control_json(str(tmp_path), path, DOC)
    assert r.read_control_json(path) == DOC
    assert w.read_control_json(path) == DOC
    raw = Path(path).read_bytes()
    other = str(tmp_path / "other.json")
    r.write_control_json(str(tmp_path), other, DOC)
    assert Path(other).read_bytes() == raw
    assert tctrl.control_trailer(raw) == jctrl.control_trailer(raw)


def test_torn_and_tampered_files_refused(tmp_path):
    path = str(tmp_path / "hb_00000.json")
    tctrl.write_control_json(str(tmp_path), path, DOC)
    raw = Path(path).read_bytes()
    sleeps = []
    for cut in range(len(raw)):
        with open(path, "wb") as f:
            f.write(raw[:cut])
        assert tctrl.read_control_json(path, _sleep=sleeps.append) is None
    # a body byte changed under an intact trailer: the trailer disagrees
    tampered = bytearray(raw)
    tampered[raw.index(b"4711")] = ord("5")
    with open(path, "wb") as f:
        f.write(bytes(tampered))
    assert tctrl.read_control_json(path, _sleep=sleeps.append) is None
    assert jctrl.read_control_json(path, _sleep=sleeps.append) is None
    # a trailer-less (hand-written) file is refused too
    with open(path, "wb") as f:
        f.write(json.dumps(DOC).encode() + b"\n")
    assert tctrl.read_control_json(path, _sleep=sleeps.append) is None
    assert tctrl.read_control_json(str(tmp_path / "absent.json")) is None


def _beat(tmp_path, rank, wall, step=0, ewma=None):
    cfg = tsup.SupervisorConfig(rank=rank, dir=str(tmp_path))
    sup = tsup.Supervisor(cfg)
    if ewma is not None:
        sup.record_step(step, ewma / 1e3)
    else:
        sup.record_step(step)
    tsup._wall, prev = (lambda: wall), tsup._wall
    try:
        sup.beat_now()
    finally:
        tsup._wall = prev


def _classify(tmp_path, now, monkeypatch, **kw):
    monkeypatch.setattr(tsup, "_wall", lambda: now)
    monkeypatch.setattr(jsup, "_wall", lambda: now)
    t = tsup.MembershipView(str(tmp_path), **kw).poll()
    j = jsup.MembershipView(str(tmp_path), **kw).poll()
    return t, j


def test_membership_classification_equals_jax(tmp_path, monkeypatch):
    now = 1_000.0
    _beat(tmp_path, 0, now - 0.1, step=5, ewma=10.0)  # healthy
    _beat(tmp_path, 1, now - 2.0, step=5, ewma=10.0)  # stale: straggler
    _beat(tmp_path, 2, now - 9.0, step=5, ewma=10.0)  # lease gone: dead
    _beat(tmp_path, 3, now - 0.1, step=5, ewma=95.0)  # EWMA outlier
    _beat(tmp_path, 4, now - 0.1, step=5, ewma=11.0)  # healthy
    t, j = _classify(tmp_path, now, monkeypatch, straggler_s=1.0,
                     lease_s=3.0, configured=6)
    assert t == {r: tsup.PeerStatus(*jst.__dict__.values())
                 for r, jst in j.items()}
    assert {r: s.state for r, s in t.items()} == {
        0: "healthy", 1: "straggler", 2: "dead", 3: "straggler",
        4: "healthy", 5: "dead",
    }
    # the same directory, later: everyone's lease has run out
    t, j = _classify(tmp_path, now + 60.0, monkeypatch)
    assert [s.state for s in t.values()] == [s.state for s in j.values()]
    assert {s.state for s in t.values()} == {"dead"}


def test_clock_regression_holds_the_watermark(tmp_path, monkeypatch):
    now = 500.0
    monkeypatch.setattr(tsup, "_wall", lambda: now)
    view = tsup.MembershipView(str(tmp_path), lease_s=3.0)
    _beat(tmp_path, 0, now - 0.5)
    assert view.poll()[0].state == "healthy"
    _beat(tmp_path, 0, now - 10.0)  # the beat's clock stepped back
    status = view.poll()[0]
    assert status.state == "healthy" and status.age_s == pytest.approx(0.5)


def test_supervisor_thread_beats_and_stops(tmp_path):
    cfg = tsup.SupervisorConfig.from_env(7, str(tmp_path), interval_s=0.02)
    with tsup.Supervisor(cfg) as sup:
        sup.record_step(3, 0.004)
        beat = tctrl.read_control_json(sup.beat_path)
        assert beat["rank"] == 7 and beat["pid"] == os.getpid()
    assert sup._thread is None
    assert jctrl.read_control_json(sup.beat_path)["rank"] == 7


def test_logger_rank_matches_jax(monkeypatch):
    for raw in ("", "3", " 12 ", "x"):
        monkeypatch.setenv("FT_RANK", raw)
        assert tlogging.logger_rank() == jlogging.logger_rank()
    log = tlogging.get_logger("flextree.test_torch_runtime_ctrl", rank=4)
    assert "r4" in log.handlers[0].formatter._fmt
    assert tlogging.get_logger("flextree.test_torch_runtime_ctrl") is log


def test_recorder_dump_snapshot_and_signal_chain(tmp_path):
    reg = MetricsRegistry()
    reg.counter("serve.submitted").inc(2)
    hits = []
    prev = signal.signal(signal.SIGUSR1, lambda s, f: hits.append(s))
    try:
        with flight_recorder(tmp_path, rank=2, registry=reg) as rec:
            record_event("serve_admit", rid=1)
            install_signal_dump(rec, (signal.SIGUSR1,))
            os.kill(os.getpid(), signal.SIGUSR1)
            path = trecorder.dump_current("manual", why="test")
        assert hits == [signal.SIGUSR1]  # the earlier handler still ran
    finally:
        signal.signal(signal.SIGUSR1, prev)
    assert path == rec.dump_path
    dump = json.loads(Path(path).read_text())
    assert dump["reason"] == "manual" and dump["why"] == "test"
    kinds = [json.loads(line)["kind"]
             for line in Path(rec.event_path).read_text().splitlines()]
    assert kinds == ["serve_admit", "dump", "dump"]
    snap = json.loads((tmp_path / "metrics_00002.json").read_text())
    assert snap["counters"]["serve.submitted"] == 2
    assert trecorder.dump_current("none installed") is None


def _fill(registry_cls, wall):
    reg = registry_cls()
    reg.counter("serve.retries").inc(3)
    reg.gauge("serve.active-slots").set(2)
    h = reg.histogram("serve.round_ms")
    w = reg.windowed_histogram("serve.ttft_ms", interval_s=1.0,
                               intervals=10)
    for v in (0.3, 2.0, 7.5, 40.0, 900.0):
        h.observe(v)
        w.observe(v, now=wall)
    return reg.snapshot()


def test_prometheus_exposition_equals_jax(monkeypatch):
    from flextree_tpu_torch.obs import metrics as tmetrics

    monkeypatch.setattr(tmetrics, "_now", lambda: 50.0)
    monkeypatch.setattr(jmetrics, "_now", lambda: 50.0)
    snaps = {"frontdoor": _fill(tmetrics.MetricsRegistry, 50.0),
             "fd_00001": _fill(tmetrics.MetricsRegistry, 50.0)}
    text = prometheus_exposition(snaps)
    assert text == jmetrics.prometheus_exposition(snaps)
    assert 'flextree_serve_retries{rank="frontdoor"} 3' in text
    assert 'flextree_serve_ttft_ms_window_p99{rank="fd_00001"}' in text
    assert "# TYPE flextree_serve_active_slots gauge" in text
    assert prometheus_exposition({}) == ""
