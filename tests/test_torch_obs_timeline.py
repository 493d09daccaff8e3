"""The port's cross-rank timeline, window readers and ``obs`` CLI
(``flextree_tpu_torch/obs/timeline.py``, ``metrics.py``,
``__main__.py``) against the JAX package's on the same inputs: event
lists (a torn tail, duplicate lines, every lane and span kind), one obs
directory written through each package's recorder, windowed-histogram
payloads (fresh and stale), and the CLI's output; then the in-process
pool's replicas recording on tracks of their own, so a re-routed
request's flow spans both."""

from __future__ import annotations

import dataclasses
import importlib
import json
import os

import numpy as np
import pytest

from flextree_tpu_torch.obs import __main__ as tcli
from flextree_tpu_torch.obs import metrics as tmet
from flextree_tpu_torch.obs import recorder as trec
from flextree_tpu_torch.obs import timeline as ttl

jcli = importlib.import_module("flextree_tpu.obs.__main__")
jmet = importlib.import_module("flextree_tpu.obs.metrics")
jrec = importlib.import_module("flextree_tpu.obs.recorder")
jtl = importlib.import_module("flextree_tpu.obs.timeline")


def _ev(rank, seq, ts, kind, src="serve", **fields):
    return {"ts": ts, "rank": rank, "src": src, "seq": seq, "kind": kind,
            **fields}


def _prov(nbytes=4096, topo="8", world=8, codec="f32", sharded=False):
    pred = {"latency_us": 30.0, "bandwidth_us": 8.0, "reduce_us": 2.0,
            "control_us": 1.0, "codec_us": 0.5}
    return {"axes": ["dp"], "topo": {"dp": topo}, "world": {"dp": world},
            "nbytes": nbytes, "codec": codec, "sharded": sharded,
            "predicted": pred, "predicted_us": sum(pred.values())}


def _events():
    """Every kind of line the merger treats differently, on three ranks."""
    return [
        _ev(0, 0, 1.0, "fit_start", src="train", id="run"),
        _ev(0, 1, 1.1, "step_start", src="train", step=0),
        _ev(0, 2, 1.4, "step_end", src="train", step=0),
        _ev(0, 3, 1.5, "step_start", src="train", step=1),  # unfinished
        _ev(0, 4, 1.6, "bucket_planned", src="train", name="ft_bucket0",
            **_prov()),
        _ev(0, 5, 1.7, "bucket_measured", src="train", measured_us=55.0,
            fingerprint="cpu:8", step=1, **_prov()),
        _ev(0, 6, 1.75, "bucket_measured", src="train", measured_us=12.0,
            per_step=True, step=1, **_prov(nbytes=1024, topo="1", world=4,
                                           codec="int8")),
        _ev(0, 7, 1.76, "bucket_measured", src="train", measured_us=0,
            **_prov()),  # invalid measured
        _ev(0, 8, 1.77, "bucket_planned", src="train", predicted_error=True,
            **_prov(nbytes=2048)),
        _ev(0, 9, 1.78, "bucket_planned", src="train",
            **_prov(nbytes=8192, topo="4,2", sharded=True)),  # unmeasured
        _ev(0, 10, 1.79, "step_measured", src="train", step=1, step_us=900.0),
        _ev(0, 11, 1.8, "heartbeat", src="train", step=1),
        _ev(0, 12, 1.9, "slo_breach", src="train", p99_ms=120.0),
        _ev(0, 13, 1.95, "coord_commit", src="train", epoch=3),
        _ev(0, 14, 2.0, "fit_end", src="train", id="run", step=2),
        _ev(0, 15, 2.05, "dump", src="train", reason="test"),
        _ev(1, 0, 1.2, "serve_admit", rid=5, slot=0),
        _ev(1, 1, 1.3, "serve_prefill", rid=5, slot=0),
        _ev(1, 2, 1.35, "serve_round_measured", measured_us=4100.0,
            predicted_us=110.0),
        _ev(1, 3, 1.36, "serve_prefix_evict", block=3),
        _ev(1, 4, 1.37, "replica_suspect", replica=1, why="raise"),
        _ev(2, 0, 1.5, "serve_admit", rid=5, slot=1),  # re-routed
        _ev(2, 1, 1.8, "serve_retire", rid=5, n_tokens=4),
        _ev(2, 2, 1.85, "serve_retire", rid=9, n_tokens=1),  # never admitted
        _ev(2, 3, 1.9, "step_end", step=4),  # unmatched end
    ]


def _write_dir(path, events, *, torn=True, dup=True):
    os.makedirs(path, exist_ok=True)
    for rank in sorted({e["rank"] for e in events}):
        lines = [json.dumps(e) for e in events if e["rank"] == rank]
        if dup:
            lines += lines[:2]
        text = "\n".join(lines) + "\n"
        if torn:
            text += '{"ts": 9.9, "rank": %d, "ki' % rank
        with open(os.path.join(path, f"flight_{rank:05d}.jsonl"), "w") as f:
            f.write(text)
    with open(os.path.join(path, "flight_00001.dump.json"), "w") as f:
        json.dump({"rank": 1, "reason": "replica_strikes",
                   "events": events[:3]}, f)


def _same_doc(t, j):
    """The two documents, equal but for the tool that wrote them."""
    assert t["otherData"].pop("tool") == "flextree_tpu_torch.obs"
    assert j["otherData"].pop("tool") == "flextree_tpu.obs"
    assert json.dumps(t, sort_keys=True) == json.dumps(j, sort_keys=True)


def test_merge_validate_and_residuals_equal_jax(tmp_path):
    _write_dir(str(tmp_path), _events())
    tev, tdumps = ttl.read_dir(str(tmp_path))
    jev, jdumps = jtl.read_dir(str(tmp_path))
    assert tev == jev and tdumps == jdumps
    assert len(tev) == len(_events()) + 2 * 3  # duplicates read, tails torn
    tdoc, jdoc = ttl.merge_events(tev, tdumps), jtl.merge_events(jev, jdumps)
    assert ttl.validate_trace(tdoc) == jtl.validate_trace(jdoc) == []
    assert tdoc["otherData"]["events"] == len(_events())  # deduped
    _same_doc(tdoc, jdoc)
    tsamp, tskip = ttl.residual_pairs(tev)
    jsamp, jskip = jtl.residual_pairs(jev)
    assert tskip == jskip and sum(tskip.values()) > 0
    assert [dataclasses.asdict(s) for s in tsamp] == \
        [dataclasses.asdict(s) for s in jsamp]
    assert {s.source for s in tsamp} == {"paired", "step"}
    assert [s.rel_residual for s in tsamp] == [s.rel_residual for s in jsamp]
    assert [s.phases for s in tsamp] == [s.phases for s in jsamp]
    assert [ttl.residual_group_key(s) for s in tsamp] == \
        [jtl.residual_group_key(s) for s in jsamp]
    assert ttl.residual_table(tsamp, tskip) == jtl.residual_table(jsamp, jskip)
    assert ttl.residual_table([], tskip) == jtl.residual_table([], jskip)
    assert ttl.phase_components(None) is None
    assert ttl.phase_components(_prov()["predicted"]) == \
        jtl.phase_components(_prov()["predicted"])


@pytest.mark.parametrize("doc", [
    {"traceEvents": "nope"},
    {"traceEvents": [{"ph": "?"}]},
    {"traceEvents": [{"name": "x", "ph": "X", "ts": 0, "pid": 0, "tid": 0,
                      "dur": -1}]},
    {"traceEvents": [{"name": "r", "ph": "f", "ts": 0, "pid": 0, "tid": 0,
                      "id": 3}, {"name": "r", "ph": "s", "ts": 0, "pid": 0,
                                 "tid": 0}]},
    {"traceEvents": [{"name": "", "ph": "i", "ts": "a", "pid": 0,
                      "args": {1, 2}}]},
], ids=["not-a-list", "bad-ph", "bad-dur", "flows", "fields"])
def test_validate_trace_catches_what_jax_catches(doc):
    bad = ttl.validate_trace(doc)
    assert bad and bad == jtl.validate_trace(doc)


def _record(rec_mod, dir, now):
    """The same events through one package's recorder, on a fake clock."""
    for rank, src in ((0, "train"), (3, "serve")):
        with rec_mod.flight_recorder(dir, rank=rank, source=src,
                                     spill_every=2) as rec:
            reg = rec_mod.get_registry()
            reg.counter("serve.rounds").inc(3)
            for i in range(5):
                now[0] += 0.25
                rec.record("step_start" if i % 2 == 0 else "step_end",
                           step=i // 2)
            now[0] += 0.1
            rec.record("serve_admit", rid=7, slot=rank)
            now[0] += 0.1
            rec.record("serve_retire", rid=7, n_tokens=3)
            now[0] += 0.1
            rec.dump("test", rank_note=rank)


def test_port_recorder_and_jax_recorder_merge_to_the_same_trace(
        tmp_path, monkeypatch):
    for mod, name in ((trec, "torch"), (jrec, "jax")):
        now = [1000.0]
        monkeypatch.setattr(mod, "_wall", lambda now=now: now[0])
        _record(mod, str(tmp_path / name), now)
    tdoc = ttl.merge_dir(str(tmp_path / "torch"))
    jdoc = ttl.merge_dir(str(tmp_path / "jax"))
    assert ttl.validate_trace(tdoc) == []
    assert tdoc["otherData"]["dumps"] == jdoc["otherData"]["dumps"] != {}
    assert json.dumps(tdoc, sort_keys=True) == json.dumps(jdoc, sort_keys=True)
    # and each package's merger reads the other's files the same way
    cross = jtl.merge_dir(str(tmp_path / "torch"))
    _same_doc(ttl.merge_dir(str(tmp_path / "torch")), cross)


def _windowed(met, now, values, interval_s):
    h = met.WindowedHistogram(met.DEFAULT_MS_BUCKETS, interval_s=interval_s,
                              intervals=10)
    for t, v in zip(now, values):
        h.observe(v, now=t)
    return h


def test_frozen_windows_and_merged_percentiles_equal_jax():
    rng = np.random.default_rng(0)
    values = rng.lognormal(2.0, 1.2, 200).tolist()
    times = np.linspace(0.0, 20.0, 200).tolist()
    payloads = []
    for interval in (1.0, 0.5):
        h = _windowed(tmet, times, values, interval)
        hj = _windowed(jmet, times, values, interval)
        assert h.window_slots(now=20.0) == hj.window_slots(now=20.0)
        w = {"interval_s": interval, "intervals": 10,
             "edges": list(h.edges), "wall": 5000.0,
             "slots": h.window_slots(now=20.0)}
        payloads.append({"window": w})
    assert tmet.load_window({"count": 3}) is None is jmet.load_window(
        {"count": 3})
    assert tmet.load_window({"window": {"slots": [{"x": 1}]}}) is None
    for now in (5000.0, 5001.2, 5003.9, 5004.1, 5011.0):
        fr = [tmet.load_window(p) for p in payloads]
        jfr = [jmet.load_window(p) for p in payloads]
        for t, j in zip(fr, jfr):
            assert t.window_counts(now) == j.window_counts(now)
            assert t.window_count(now) == j.window_count(now)
            for q in (50, 90, 99):
                a, b = t.window_percentile(q, now), j.window_percentile(q, now)
                assert a == b or (np.isnan(a) and np.isnan(b))
        a = tmet.merged_window_percentile(fr + [None], 99, now)
        b = jmet.merged_window_percentile(jfr + [None], 99, now)
        assert a[1] == b[1] and (a[0] == b[0] or np.isnan(a[0]) and
                                 np.isnan(b[0]))
    assert tmet.merged_window_percentile([], 50) == (pytest.approx(np.nan,
                                                                   nan_ok=True),
                                                     0)
    with pytest.raises(ValueError, match="identical bucket edges"):
        other = tmet.load_window({"window": {**payloads[0]["window"],
                                             "edges": [1.0, 2.0]}})
        tmet.merged_window_percentile([tmet.load_window(payloads[0]), other],
                                      50)


def _registry_snapshot(met, stale):
    reg = met.MetricsRegistry()
    reg.counter("serve.rounds").inc(5)
    reg.gauge("pool.alive").set(2)
    reg.histogram("serve.round_ms").observe(3.0)
    h = reg.windowed_histogram("serve.ttft_ms", interval_s=100.0)
    for v in (1.0, 4.0, 40.0, 400.0):
        h.observe(v)
    snap = reg.snapshot()
    if stale:  # written long ago: every slot has aged out by now
        snap["histograms"]["serve.ttft_ms"]["window"]["wall"] -= 1e5
    return snap


@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
def test_prometheus_exposition_reages_the_window_as_jax(stale):
    snap = _registry_snapshot(tmet, stale)
    text = tmet.prometheus_exposition({"00000": snap, "00001": snap})
    assert text == jmet.prometheus_exposition({"00000": snap, "00001": snap})
    assert ("flextree_serve_ttft_ms_window_p99" in text) is not stale
    count = 0 if stale else 4
    assert f'flextree_serve_ttft_ms_window_count{{rank="00000"}} {count}' \
        in text


def _cli_dir(tmp_path):
    d = tmp_path / "obs"
    _write_dir(str(d), _events())
    for rank, stale in ((0, False), (1, True)):
        with open(d / f"metrics_{rank:05d}.json", "w") as f:
            json.dump(_registry_snapshot(tmet, stale), f)
    return str(d)


def _run_cli(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("cmd", [
    ["summary"], ["residuals"], ["residuals", "--json"],
    ["residuals", "--fingerprint", "cpu:8", "--json"], ["metrics"],
    ["metrics", "--prom"]], ids=lambda c: "-".join(c).replace("--", ""))
def test_cli_output_equals_jax(tmp_path, capsys, cmd):
    d = _cli_dir(tmp_path)
    argv = [cmd[0], d, *cmd[1:]]
    got = _run_cli(tcli.main, ["--device", "cpu", *argv], capsys)
    want = _run_cli(jcli.main, argv, capsys)
    if cmd == ["residuals"]:
        # the JAX table adds a drift column from the feedback fitter,
        # which the port has not yet (ROADMAP item 9): the port prints
        # JAX's table without it
        samples, skipped = jtl.residual_pairs(jtl.read_dir(d)[0])
        assert "drift" in want[1]
        want = (0, jtl.residual_table(samples, skipped) + "\n", "")
    assert got == want and got[0] == 0 and got[1]


def test_cli_merge_and_validate_equal_jax(tmp_path, capsys):
    d = _cli_dir(tmp_path)
    outs = {}
    for name, main, pre in (("torch", tcli.main, ["--device", "cpu"]),
                            ("jax", jcli.main, [])):
        path = str(tmp_path / f"{name}.json")
        rc, out, _ = _run_cli(main, [*pre, "merge", d, "--out", path], capsys)
        assert rc == 0
        with open(path) as f:
            outs[name] = (out.replace(path, "OUT"), json.load(f))
        rc, out, _ = _run_cli(main, [*pre, "validate", path], capsys)
        assert rc == 0 and out.replace(path, "OUT") == \
            f"OUT: ok ({len(outs[name][1]['traceEvents'])} trace events)\n"
    assert outs["torch"][0] == outs["jax"][0]
    _same_doc(outs["torch"][1], outs["jax"][1])
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    for main, pre in ((tcli.main, ["--device", "cpu"]), (jcli.main, [])):
        assert main([*pre, "merge", empty]) == 1
        assert main([*pre, "metrics", empty]) == 1
        assert main([*pre, "summary", empty]) == 1
    capsys.readouterr()


def test_cli_fleet_refuses_naming_the_item(tmp_path):
    with pytest.raises(NotImplementedError,
                       match="Checkpoint, supervision and feedback plumbing"):
        tcli.main(["--device", "cpu", "fleet", str(tmp_path)])


def test_cli_needs_a_card_unless_told_cpu(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["summary", str(tmp_path)])


# -------------------------------- the pool's replicas on tracks of their own


def test_rerouted_request_flow_spans_both_replica_tracks(tmp_path):
    """Each replica's rounds record under a recorder of its own rank
    (``use_recorder`` on the thread that steps it); a request admitted on
    replica 1 and re-routed to replica 0 after a crash draws one flow
    from track 1 to track 0, and the pool's own events stay on its
    recorder's track."""
    import torch

    from flextree_tpu_torch.models.transformer import (
        TransformerConfig,
        init_params,
    )
    from flextree_tpu_torch.serving import (
        BatcherConfig,
        PagedCacheConfig,
        PoolConfig,
        ReplicaPool,
        Request,
        ServingEngine,
    )

    cfg = TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=1,
                            d_ff=64)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    pcfg = PagedCacheConfig(num_blocks=16, block_size=8, blocks_per_seq=4)
    obs = str(tmp_path / "obs")
    engines = [ServingEngine(params, cfg, pcfg, BatcherConfig(slots=2),
                             device="cpu") for _ in range(2)]
    with trec.flight_recorder(obs, rank=2, source="pool"):
        recs = [trec.FlightRecorder(obs, rank, source="serve")
                for rank in range(2)]
        for eng, rec in zip(engines, recs):
            inner = eng.step

            def step(inner=inner, rec=rec):
                with trec.use_recorder(rec):
                    return inner()

            eng.step = step
        pool = ReplicaPool(engines, PoolConfig(
            heartbeat_dir=str(tmp_path / "hb"), step_timeout_s=60.0))
        for i in range(4):
            pool.submit(Request(rid=i, prompt=np.arange(3 + i,
                                                        dtype=np.int32),
                                max_new_tokens=4))
        pool.step()
        held = sorted(pool.replicas[1].assigned)
        pool.kill(1, mode="raise")
        rep = pool.run_until_idle()
        pool.shutdown()
        for rec in recs:
            rec.close()
    assert rep["completed"] == 4 and rep["reroutes"] == len(held) > 0
    doc = ttl.merge_dir(obs)
    assert ttl.validate_trace(doc) == []
    assert doc["otherData"]["ranks"] == [0, 1, 2]
    for rid in held:
        flow = [e for e in doc["traceEvents"]
                if e.get("cat") == "request" and e["id"] == rid]
        assert flow[0]["ph"] == "s" and flow[0]["pid"] == 1
        assert flow[-1]["ph"] == "f" and flow[-1]["pid"] == 0
    pool_kinds = {e["name"] for e in doc["traceEvents"] if e.get("pid") == 2}
    assert {"kill", "replica_suspect", "drain"} <= pool_kinds
    assert os.path.exists(os.path.join(obs, "flight_00002.dump.json"))
