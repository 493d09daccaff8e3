"""The port's real-process serving tier on the CPU: the frame protocol,
the replica server, the front door, and one two-process disaggregated run.

- **framing**: ``encode_frame`` gives the JAX package's bytes (one wire
  for both packages), the error codes are the JAX ones, torn, oversized
  and zero-length frames are refused, responses multiplex on one socket;
- **replica server** (a real port engine, in-process threads): ping and
  the endpoint file, dedup to a single execution, an expired deadline
  refused before execution, backlog shed, a drain that refuses in-flight
  work, role refusals, a KV handoff between two in-process servers;
- **front door** against scripted replicas: retries with backoff and
  breaker strike-out, hedging around a black hole, intake shed, drain
  re-route, role tiers, short prompts never migrated, ``prometheus()``;
- **one spawned pair** of ``replica_main --cpu`` processes, ``--role
  prefill`` and ``--role decode``, behind a front door: every request
  completes exactly once with an in-process engine's tokens.

Every socket call has a timeout and every thread is joined with one.
"""

import json
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from flextree_tpu.serving import rpc as jrpc
from flextree_tpu_torch.models.transformer import (
    TransformerConfig,
    init_params,
)
from flextree_tpu_torch.runtime.ctrlfile import (
    read_control_json,
    write_control_json,
)
from flextree_tpu_torch.serving import (
    BatcherConfig,
    FrontDoor,
    FrontDoorConfig,
    PagedCacheConfig,
    ReplicaClient,
    ReplicaConfig,
    ReplicaServer,
    Request,
    RpcConnection,
    RpcConnRefused,
    RpcError,
    RpcShed,
    RpcTimeout,
    RpcTornFrame,
    ServingEngine,
)
from flextree_tpu_torch.serving import frontdoor as frontdoor_mod
from flextree_tpu_torch.serving.replica_main import ENDPOINT_FMT
from flextree_tpu_torch.serving.rpc import (
    MAX_FRAME_BYTES,
    chunk_blob,
    decode_frame_payload,
    encode_frame,
    join_chunks,
    recv_frame,
    send_frame,
)

ROOT = Path(__file__).resolve().parent.parent
JOIN_S = 10.0

# ---------------------------------------------------------------- framing


@pytest.mark.parametrize("payload", [
    {"kind": "ping"},
    {"kind": "generate", "rid": 7, "prompt": [1, 2, 3],
     "max_new_tokens": 4, "deadline_in_s": 1.25, "corr": 3},
    {"kind": "kv_admit", "meta": {"codec": "int8", "tensors": [
        {"crc32": 123, "layer": 0, "part": "k"}]}, "chunk": "QUJD"},
])
def test_encode_frame_is_the_jax_wire(payload):
    raw = encode_frame(payload)
    assert raw == jrpc.encode_frame(payload)
    (length,) = struct.unpack(">I", raw[:4])
    assert length == len(raw) - 4
    assert decode_frame_payload(raw[4:]) == payload
    assert jrpc.decode_frame_payload(raw[4:]) == payload


def test_error_codes_are_the_jax_ones():
    for port_cls, jax_cls in ((RpcTimeout, jrpc.RpcTimeout),
                              (RpcConnRefused, jrpc.RpcConnRefused),
                              (RpcTornFrame, jrpc.RpcTornFrame),
                              (RpcShed, jrpc.RpcShed),
                              (RpcError, jrpc.RpcError)):
        assert port_cls.code == jax_cls.code
        assert issubclass(port_cls, RpcError)
    assert RpcTimeout.code == "FT_RPC_TIMEOUT"
    assert RpcConnRefused.code == "FT_RPC_CONN_REFUSED"
    assert RpcTornFrame.code == "FT_RPC_TORN_FRAME"
    assert RpcShed.code == "FT_RPC_SHED"
    assert str(RpcTimeout("late")).startswith("FT_RPC_TIMEOUT")
    assert str(RpcShed()) == "FT_RPC_SHED"
    assert (MAX_FRAME_BYTES, jrpc.MAX_KV_CHUNK_BYTES) == (
        jrpc.MAX_FRAME_BYTES, jrpc.MAX_KV_CHUNK_BYTES)


def _pair():
    a, b = socket.socketpair()
    a.settimeout(5.0)
    b.settimeout(5.0)
    return a, b


@pytest.mark.parametrize("case", ["half", "crc", "oversized", "zero",
                                  "wrong_len"])
def test_torn_frames_refused(case):
    a, b = _pair()
    try:
        raw = bytearray(encode_frame({"kind": "result", "tokens": [7, 8]}))
        if case == "half":
            a.sendall(bytes(raw[: len(raw) // 2]))
            a.close()
        elif case == "crc":
            raw[10] ^= 0xFF
            a.sendall(bytes(raw))
        elif case == "oversized":
            a.sendall(struct.pack(">I", MAX_FRAME_BYTES + 1))
        elif case == "zero":
            a.sendall(struct.pack(">I", 0))
        else:
            body = b'{"kind": "x"}\n'
            trailer = json.dumps({"len": 999, "crc32": "00000000"}).encode()
            frame = body + trailer + b"\n"
            a.sendall(struct.pack(">I", len(frame)) + frame)
        with pytest.raises(RpcTornFrame) as ei:
            recv_frame(b)
        assert "FT_RPC_TORN_FRAME" in str(ei.value)
    finally:
        a.close()
        b.close()


def test_eof_at_boundary_is_conn_refused_and_send_roundtrip():
    a, b = _pair()
    send_frame(a, {"kind": "ping", "x": [1, 2]})
    assert recv_frame(b) == {"kind": "ping", "x": [1, 2]}
    a.close()
    with pytest.raises(RpcConnRefused):
        recv_frame(b)
    b.close()


def test_kv_chunks_roundtrip_and_refuse_garbage():
    blob = np.random.default_rng(5).integers(0, 256, 3000,
                                             dtype=np.uint8).tobytes()
    chunks = chunk_blob(blob, chunk_bytes=1024)
    assert chunks == jrpc.chunk_blob(blob, chunk_bytes=1024)
    assert len(chunks) == 3 and join_chunks(chunks) == blob
    assert chunk_blob(b"") == [""] and join_chunks([""]) == b""
    with pytest.raises(RpcTornFrame):
        join_chunks(["not*base64!"])
    with pytest.raises(ValueError):
        chunk_blob(blob, chunk_bytes=0)


def test_connection_multiplexes_and_fails_all_on_a_tear():
    a, b = _pair()

    def server():
        try:
            first, second = recv_frame(b), recv_frame(b)
            send_frame(b, {"corr": second["corr"], "echo": second["v"]})
            send_frame(b, {"corr": first["corr"], "echo": first["v"]})
            third = recv_frame(b)
            torn = bytearray(encode_frame({"corr": third["corr"]}))
            torn[8] ^= 0xFF
            b.sendall(bytes(torn))
        except RpcError:
            pass

    t = threading.Thread(target=server, daemon=True)
    t.start()
    a.settimeout(None)
    conn = RpcConnection(a)
    results = {}

    def call(v):
        results[v] = conn.call({"v": v}, timeout_s=5.0)

    t1 = threading.Thread(target=call, args=("one",), daemon=True)
    t1.start()
    time.sleep(0.05)
    call("two")
    t1.join(JOIN_S)
    assert not t1.is_alive()
    assert results["one"]["echo"] == "one" and results["two"]["echo"] == "two"
    with pytest.raises(RpcTornFrame):
        conn.call({"v": "three"}, timeout_s=5.0)
    assert isinstance(conn.dead, RpcTornFrame)
    t.join(JOIN_S)
    assert not t.is_alive()
    conn.close()
    b.close()
    c, d = _pair()
    c.settimeout(None)
    quiet = RpcConnection(c)
    with pytest.raises(RpcTimeout):
        quiet.call({"kind": "ping"}, timeout_s=0.05)
    quiet.close()
    d.close()


# ----------------------------------------------------------- replica server

DIMS = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64)
CACHE = dict(num_blocks=17, block_size=8, blocks_per_seq=4)


@pytest.fixture(scope="module")
def model():
    cfg = TransformerConfig(**DIMS)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")


def _engine(model, slots=2):
    cfg, params = model
    return ServingEngine(params, cfg, PagedCacheConfig(**CACHE),
                         BatcherConfig(slots=slots), device="cpu")


class _Servers:
    """In-process replica servers, each stopped (and its engine thread
    joined) at the end of the test."""

    def __init__(self):
        self.servers = []

    def start(self, model, dir, rank=0, **rkw):
        srv = ReplicaServer(_engine(model), ReplicaConfig(rank, str(dir),
                                                          **rkw))
        self.servers.append(srv.start())
        return srv

    def stop(self):
        for srv in self.servers:
            srv.stop()
            for t in srv._threads:
                assert not t.is_alive(), t.name


@pytest.fixture
def servers():
    s = _Servers()
    yield s
    s.stop()


def _dial(srv) -> RpcConnection:
    return RpcConnection.connect("127.0.0.1", srv.port, timeout_s=2.0)


def _generate(rid, prompt, max_new=4, **kw):
    return dict({"kind": "generate", "rid": rid, "prompt": list(prompt),
                 "max_new_tokens": max_new}, **kw)


def test_ping_and_endpoint_file(model, tmp_path, servers):
    srv = servers.start(model, tmp_path, role="decode")
    ep = read_control_json(str(tmp_path / ENDPOINT_FMT.format(rank=0)))
    assert ep["port"] == srv.port and ep["role"] == "decode"
    assert ep["pid"] == os.getpid()
    conn = _dial(srv)
    reply = conn.call({"kind": "ping"}, timeout_s=5.0)
    assert reply["ok"] and reply["role"] == "decode"
    assert conn.call({"kind": "nope"}, timeout_s=5.0)["ok"] is False
    conn.close()


def test_dedup_to_a_single_execution(model, tmp_path, servers):
    srv = servers.start(model, tmp_path)
    conn = _dial(srv)
    payload = _generate(7, [1, 2, 3, 4])
    replies = {}

    def call(attempt):
        replies[attempt] = conn.call(dict(payload, attempt=attempt),
                                     timeout_s=30.0)

    ts = [threading.Thread(target=call, args=(i,), daemon=True)
          for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(JOIN_S * 3)
        assert not t.is_alive()
    assert replies[0]["ok"] and replies[1]["ok"]
    assert replies[0]["tokens"] == replies[1]["tokens"]
    eng = srv.engine
    assert eng.metrics.counter("serve.submitted").value == 1
    assert eng.metrics.counter("serve.dedup_hits").value >= 1
    again = conn.call(dict(payload, attempt=9), timeout_s=5.0)
    assert again["tokens"] == replies[0]["tokens"]
    assert len(again["intervals_s"]) == len(again["tokens"]) - 1
    # the tokens are the in-process engine's
    ref = _engine(model)
    ref.submit(Request(rid=7, prompt=np.array([1, 2, 3, 4], np.int32),
                       max_new_tokens=4))
    ref.run_until_idle()
    assert again["tokens"] == [int(t) for t in ref.completed[7].tokens]
    conn.close()


def test_expired_deadline_refused_before_execution(model, tmp_path, servers):
    srv = servers.start(model, tmp_path)
    conn = _dial(srv)
    reply = conn.call(_generate(1, [1, 2], deadline_in_s=-0.5),
                      timeout_s=5.0)
    assert reply["ok"] is False and reply["code"] == "FT_RPC_TIMEOUT"
    assert srv.engine.metrics.counter("serve.submitted").value == 0
    assert srv.engine.metrics.counter("serve.deadline_refused").value == 1
    conn.close()


def test_backlog_shed_and_role_refusals(model, tmp_path, servers):
    shed = servers.start(model, tmp_path / "a", max_pending=0)
    conn = _dial(shed)
    reply = conn.call(_generate(2, [1], 2), timeout_s=5.0)
    assert reply["ok"] is False and reply["code"] == "FT_RPC_SHED"
    assert shed.engine.metrics.counter("serve.shed").value == 1
    conn.close()
    pre = servers.start(model, tmp_path / "b", rank=1, role="prefill")
    conn = _dial(pre)
    # a prefill replica refuses plain generates
    reply = conn.call(_generate(3, [1, 2]), timeout_s=5.0)
    assert reply == {"ok": False, "code": "FT_RPC_SHED", "rid": 3,
                     "reason": "role", "corr": reply["corr"]}
    conn.close()
    dec = servers.start(model, tmp_path / "c", rank=2, role="decode")
    conn = _dial(dec)
    # a decode replica refuses the prefill half of a migration
    reply = conn.call(_generate(4, [1, 2], migrate_to={
        "host": "127.0.0.1", "port": 1, "rank": 9}), timeout_s=5.0)
    assert reply["ok"] is False and reply["reason"] == "role"
    conn.close()


def test_drain_refuses_inflight_work(model, tmp_path, monkeypatch, servers):
    monkeypatch.setenv("FT_RPC_DECODE_SLEEP", "0.05")
    srv = servers.start(model, tmp_path)
    conn = _dial(srv)
    reply = {}

    def call():
        reply["r"] = conn.call(_generate(3, [1, 2, 3], 24), timeout_s=30.0)

    t = threading.Thread(target=call, daemon=True)
    t.start()
    deadline = time.monotonic() + 10.0
    while (not srv.engine.metrics.counter("serve.submitted").value
           and time.monotonic() < deadline):
        time.sleep(0.01)
    srv.initiate_drain()
    t.join(JOIN_S)
    assert not t.is_alive()
    assert reply["r"].get("drain") is True
    assert srv.drained.wait(5.0)
    assert srv.engine.metrics.counter("serve.drain_refusals").value >= 1
    conn.close()


def test_torn_response_caught_by_the_client(model, tmp_path, monkeypatch,
                                            servers):
    monkeypatch.setenv("FT_RPC_TEAR_EVERY", "1")
    srv = servers.start(model, tmp_path)
    conn = _dial(srv)
    with pytest.raises(RpcTornFrame):
        conn.call({"kind": "ping"}, timeout_s=5.0)
    conn.close()


def test_kv_handoff_between_servers(model, tmp_path, servers):
    """The prefill server ships the KV to the decode server (kv_chunk
    frames and kv_admit), releases on the ack, and a collect generate on
    the decode server returns the colocated engine's tokens."""
    pre = servers.start(model, tmp_path, rank=0, role="prefill")
    dec = servers.start(model, tmp_path, rank=1, role="decode")
    prompt = [int(t) for t in np.arange(3, 14) % 64]
    conn = _dial(pre)
    reply = conn.call(_generate(11, prompt, 5, codec="int8", migrate_to={
        "host": "127.0.0.1", "port": dec.port, "rank": 1}), timeout_s=30.0)
    assert reply["ok"] and reply["handoff"] and reply["decode_rank"] == 1
    conn.close()
    assert pre.engine.metrics.counter("serve.migration_acked").value == 1
    assert pre.engine._exported == {}
    conn = _dial(dec)
    got = conn.call(_generate(11, prompt, 5), timeout_s=30.0)
    conn.close()
    assert dec.engine.metrics.counter("serve.migrations_in").value == 1
    assert dec.engine.metrics.counter("serve.submitted").value == 0
    ref = _engine(model)
    ref.submit(Request(rid=11, prompt=np.array(prompt, np.int32),
                       max_new_tokens=5))
    ref.run_until_idle()
    assert got["tokens"] == [int(t) for t in ref.completed[11].tokens]


def test_a_jax_client_speaks_to_a_port_replica(model, tmp_path, servers):
    """The JAX package's ``RpcConnection`` against the port's replica
    server: one wire, the same exactly-once answers."""
    srv = servers.start(model, tmp_path)
    conn = jrpc.RpcConnection.connect("127.0.0.1", srv.port, timeout_s=2.0)
    try:
        assert conn.call({"kind": "ping"}, timeout_s=5.0)["ok"]
        got = conn.call(_generate(5, [4, 5, 6], 3), timeout_s=30.0)
        again = conn.call(_generate(5, [4, 5, 6], 3, attempt=1),
                          timeout_s=5.0)
    finally:
        conn.close()
    assert got["ok"] and again["tokens"] == got["tokens"]
    assert srv.engine.metrics.counter("serve.submitted").value == 1
    ref = _engine(model)
    ref.submit(Request(rid=5, prompt=np.array([4, 5, 6], np.int32),
                       max_new_tokens=3))
    ref.run_until_idle()
    assert got["tokens"] == [int(t) for t in ref.completed[5].tokens]


# ------------------------------------------------------------- front door


class _FakeReplica:
    """A scripted replica (no engine): a real endpoint file and a
    listener answering ``behavior(payload) -> reply``; None black-holes
    the request."""

    def __init__(self, dir: str, rank: int, behavior, role="both"):
        self.behavior = behavior
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.bind(("127.0.0.1", 0))
        self._listener.listen(8)
        self._listener.settimeout(0.2)
        self.port = self._listener.getsockname()[1]
        self._stop = threading.Event()
        self._conns = []
        self._threads = []
        write_control_json(
            dir, os.path.join(dir, ENDPOINT_FMT.format(rank=rank)),
            {"rank": rank, "pid": 10_000 + rank, "host": "127.0.0.1",
             "port": self.port, "role": role, "wall": time.time()},
        )
        self._spawn(self._accept)

    def _spawn(self, fn, *args):
        t = threading.Thread(target=fn, args=args, daemon=True)
        t.start()
        self._threads.append(t)

    def _accept(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            self._conns.append(conn)
            self._spawn(self._serve, conn)

    def _serve(self, conn):
        while not self._stop.is_set():
            try:
                payload = recv_frame(conn)
            except RpcError:
                return
            reply = self.behavior(payload)
            if reply is None:
                continue
            try:
                send_frame(conn, dict(reply, corr=payload.get("corr")))
            except RpcError:
                return

    def stop(self):
        self._stop.set()
        self._listener.close()
        for c in self._conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            c.close()
        for t in self._threads:
            t.join(JOIN_S)


def _ok_reply(rank):
    def behavior(payload):
        return {"ok": True, "rid": payload["rid"], "rank": rank,
                "tokens": [1, 2, 3], "ttft_s": 0.001, "decode_s": 0.0}

    return behavior


@pytest.fixture
def fakes():
    made = []
    yield lambda *a, **k: made.append(_FakeReplica(*a, **k)) or made[-1]
    for f in made:
        f.stop()


def _door(tmp_path, **kw):
    return FrontDoor(str(tmp_path), FrontDoorConfig(**kw))


def test_arrival_stamped_once_and_ttft_includes_retries(tmp_path,
                                                        monkeypatch):
    clock = {"t": 100.0}
    monkeypatch.setattr(frontdoor_mod, "_now", lambda: clock["t"])
    fd = _door(tmp_path, dispatchers=0)
    try:
        fd.submit(5, [1, 2], 4)
        clock["t"] = 103.0
        with fd._lock:
            fd._inflight.discard(5)
        fd.submit(5, [1, 2], 4)  # a re-submit keeps the first stamp
        assert fd._arrival[5] == 100.0
        fd._deliver(5, {"rid": 5, "rank": 0, "tokens": [9], "ttft_s": 0.25},
                    ReplicaClient(0, fd.cfg), send_mono=104.0, hedged=False)
        assert fd.completed[5].ttft_s == pytest.approx(4.25)
    finally:
        fd.close()


def test_retry_backoff_then_breaker(tmp_path, monkeypatch):
    sleeps = []
    monkeypatch.setattr(frontdoor_mod, "_sleep", sleeps.append)
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    dead_port = probe.getsockname()[1]
    probe.close()
    write_control_json(
        str(tmp_path), str(tmp_path / ENDPOINT_FMT.format(rank=0)),
        {"rank": 0, "pid": 1, "host": "127.0.0.1", "port": dead_port,
         "wall": time.time()},
    )
    fd = _door(tmp_path, dispatchers=1, max_attempts=3, breaker_strikes=2,
               breaker_cooldown_s=30.0, request_timeout_s=5.0,
               backoff_base_s=0.05, backoff_cap_s=0.2, max_hedges=0).start()
    try:
        fd.submit(9, [1, 2], 4)
        deadline = time.monotonic() + 10.0
        while 9 not in fd.failed and time.monotonic() < deadline:
            time.sleep(0.01)
        assert fd.failed[9] in ("FT_RPC_RETRIES", "FT_RPC_TIMEOUT")
        assert fd.metrics.counter("serve.retries").value >= 2
        assert fd.metrics.counter("serve.breaker_opens").value >= 1
        assert fd.clients[0].breaker_open(frontdoor_mod._now())
        growing = [s for s in sleeps if s > 0]
        assert any(b > a for a, b in zip(growing, growing[1:]))
    finally:
        fd.close()


def test_hedge_around_a_black_hole(tmp_path, fakes):
    fakes(str(tmp_path), 0, lambda p: None)
    fakes(str(tmp_path), 1, _ok_reply(1))
    fd = _door(tmp_path, dispatchers=1, attempt_timeout_s=20.0,
               request_timeout_s=30.0, hedge_min_samples=4,
               hedge_floor_s=0.05, max_hedges=1).start()
    try:
        for _ in range(8):
            fd.metrics.histogram("serve.attempt_ms").observe(10.0)
        t0 = time.monotonic()
        fd.submit(1, [1, 2, 3], 3)
        assert fd.wait_idle(timeout_s=15.0)
        res = fd.completed[1]
        assert res.hedged and res.rank == 1 and list(res.tokens) == [1, 2, 3]
        assert fd.metrics.counter("serve.hedges").value == 1
        assert time.monotonic() - t0 < 10.0
    finally:
        fd.close()
    assert _door(tmp_path, dispatchers=0, max_hedges=0)._hedge_delay_s() \
        is None


def test_intake_shed_and_drain_reroute(tmp_path, fakes):
    fd = _door(tmp_path, dispatchers=0, shed_outstanding=0)
    try:
        assert fd.submit(42, [1], 2) is False
        assert fd.shed_rids == [42]
        assert fd.metrics.counter("serve.shed").value == 1
    finally:
        fd.close()
    fakes(str(tmp_path), 0,
          lambda p: {"ok": False, "drain": True, "rid": p["rid"]})
    fakes(str(tmp_path), 1, _ok_reply(1))
    fd = _door(tmp_path, dispatchers=1, max_hedges=0).start()
    try:
        fd.submit(4, [1], 3)
        assert fd.wait_idle(timeout_s=15.0)
        assert fd.completed[4].rank == 1
        assert fd.metrics.counter("serve.drains").value >= 1
    finally:
        fd.close()


def test_role_tiers_and_shed_split_by_role(tmp_path):
    fd = _door(tmp_path, dispatchers=0, migrate_min_prompt_len=5,
               affinity_span=0, shed_outstanding=1, shed_hit_headroom=0)
    try:
        for rank, role in ((0, "prefill"), (1, "prefill"), (2, "decode"),
                           (3, "both")):
            cl = ReplicaClient(rank, fd.cfg)
            cl.update_endpoint("h", 1000 + rank, 100 + rank, role)
            fd.clients[rank] = cl
        for _ in range(4):
            assert fd._routable(role="decode").rank in (2, 3)
        fd.clients[0].prefill_depth = 5
        assert fd._routable(role="prefill").rank == 1
        fd.clients[1].prefill_depth = 9
        assert fd._routable(role="prefill").rank == 0
        assert fd.submit(0, [1] * 6, 4)
        assert not fd.submit(1, [1] * 6, 4)  # the prefill tier is full
        assert fd.submit(2, [1] * 3, 4)  # decode capacity untouched
        c = fd.metrics.snapshot()["counters"]
        assert (c["serve.shed_prefill"], c.get("serve.shed_decode", 0)) == \
            (1, 0)
        fd.clients.pop(0), fd.clients.pop(1)
        assert fd._routable(role="prefill") is None
    finally:
        fd.close()


def test_short_prompts_never_migrate(tmp_path, fakes):
    """Below ``migrate_min_prompt_len`` a prompt goes to the decode tier
    as a plain generate; at or above it, to the prefill replica with a
    ``migrate_to`` naming a decode replica."""
    seen = {"prefill": [], "decode": []}

    def prefill(p):
        seen["prefill"].append(p)
        return {"ok": True, "rid": p["rid"], "handoff": True,
                "decode_rank": p["migrate_to"]["rank"], "ttft_s": 0.001}

    def decode(p):
        seen["decode"].append(p)
        return _ok_reply(1)(p)

    fakes(str(tmp_path), 0, prefill, role="prefill")
    fakes(str(tmp_path), 1, decode, role="decode")
    fd = _door(tmp_path, dispatchers=2, migrate_min_prompt_len=6,
               max_hedges=0, affinity_span=0).start()
    try:
        assert fd.submit(1, [1, 2, 3], 3) and fd.submit(2, [1] * 8, 3)
        assert fd.wait_idle(timeout_s=15.0)
        assert not fd.completed[1].migrated and fd.completed[2].migrated
        assert [p["rid"] for p in seen["prefill"]] == [2]
        assert seen["prefill"][0]["migrate_to"]["rank"] == 1
        assert all("migrate_to" not in p for p in seen["decode"])
        assert sorted(p["rid"] for p in seen["decode"]) == [1, 2]
        assert fd.metrics.counter("serve.migrations").value == 1
    finally:
        fd.close()


def test_prometheus_and_metric_files(tmp_path):
    fd = _door(tmp_path, dispatchers=0)
    try:
        client = ReplicaClient(0, fd.cfg)
        fd.clients[0] = client
        for v in (5.0, 7.0, 9.0):
            client.registry.histogram("serve.ttft_ms").observe(v)
            fd.metrics.histogram("serve.ttft_ms").observe(v)
        for name in ("serve.retries", "serve.hedges", "serve.shed",
                     "serve.drains"):
            fd.metrics.counter(name).inc()
        text = fd.prometheus()
        assert 'flextree_serve_ttft_ms_window_p99{rank="fd_00000"}' in text
        assert 'flextree_serve_ttft_ms_window_p99{rank="frontdoor"}' in text
        for name in ("serve_retries", "serve_hedges", "serve_shed",
                     "serve_drains"):
            assert f'flextree_{name}{{rank="frontdoor"}} 1' in text
        names = {Path(p).name for p in fd.write_metrics(str(tmp_path))}
        assert {"metrics_frontdoor.json", "metrics_fd_00000.json"} <= names
    finally:
        fd.close()


def test_replica_without_a_card_or_cpu_flag_refuses(tmp_path):
    """No ``--cpu`` and no card: the replica raises before it serves."""
    from flextree_tpu_torch.serving.replica_main import main

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the replica would start on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--rank", "0", "--dir", str(tmp_path), "--role", "decode"])
    assert not (tmp_path / ENDPOINT_FMT.format(rank=0)).exists()


# ------------------------------------------- two replica processes, one test

PROC_DIMS = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64)
PROC_CACHE = dict(num_blocks=40, block_size=4, blocks_per_seq=8)


def test_spawned_prefill_and_decode_replicas(tmp_path):
    """``replica_main --cpu --role prefill`` and ``--role decode`` as
    processes behind a front door: prompts of at least 6 tokens migrate,
    shorter ones run colocated on the decode replica; each request
    completes exactly once with an in-process engine's tokens; a SIGTERM
    drains both, retiring their endpoint files."""
    flags = ["--cpu", "--vocab", "64", "--d-model", "32", "--n-heads", "2",
             "--n-layers", "2", "--d-ff", "64", "--blocks", "40",
             "--block-size", "4", "--blocks-per-seq", "8", "--slots", "4",
             "--warmup-prompt-lens", "3,8"]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = []
    logs = [open(tmp_path / f"replica_{rank}.log", "w") for rank in (0, 1)]
    fd = None
    try:
        for rank, role in ((0, "prefill"), (1, "decode")):
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "flextree_tpu_torch.serving.replica_main", "--rank",
                 str(rank), "--dir", str(tmp_path), "--role", role, *flags],
                cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
                stderr=logs[rank],
            ))
        deadline = time.monotonic() + 60.0
        for rank in (0, 1):
            path = str(tmp_path / ENDPOINT_FMT.format(rank=rank))
            while read_control_json(path) is None:
                assert time.monotonic() < deadline, "replica did not start"
                assert all(p.poll() is None for p in procs)
                time.sleep(0.05)
        fd = _door(tmp_path, migrate_min_prompt_len=6, max_hedges=0,
                   affinity_span=0, request_timeout_s=60.0,
                   attempt_timeout_s=30.0).start()
        rng = np.random.default_rng(0)
        prompts = {rid: rng.integers(0, 64, (int(rng.integers(3, 14)),))
                   .astype(np.int32) for rid in range(8)}
        for rid, p in prompts.items():
            assert fd.submit(rid, p, 5)
        assert fd.wait_idle(timeout_s=60.0)
        assert fd.failed == {}
        assert sorted(fd.completed) == sorted(prompts)
        assert fd.metrics.counter("serve.duplicate_results").value == 0
        cfg = TransformerConfig(**PROC_DIMS)
        ref = ServingEngine(
            init_params(cfg, torch.Generator().manual_seed(0),
                        device="cpu"),
            cfg, PagedCacheConfig(**PROC_CACHE), BatcherConfig(slots=4),
            device="cpu")
        for rid, p in prompts.items():
            ref.submit(Request(rid=rid, prompt=p, max_new_tokens=5))
        ref.run_until_idle()
        migrated = 0
        for rid, p in prompts.items():
            res = fd.completed[rid]
            np.testing.assert_array_equal(res.tokens,
                                          ref.completed[rid].tokens)
            assert res.migrated == (len(p) >= 6) and res.rank == 1
            migrated += res.migrated
        assert 0 < migrated < len(prompts)
        assert fd.metrics.counter("serve.migrations").value == migrated
        fd.close()
        fd = None
        for p in procs:
            p.send_signal(signal.SIGTERM)
        for rank, p in enumerate(procs):
            assert p.wait(timeout=30) == 0, \
                (tmp_path / f"replica_{rank}.log").read_text()[-2000:]
        for rank in (0, 1):
            assert not (tmp_path / ENDPOINT_FMT.format(rank=rank)).exists()
        snap = json.loads((tmp_path / "metrics_00001.json").read_text())
        assert snap["counters"]["serve.migrations_in"] == migrated
        pre = json.loads((tmp_path / "metrics_00000.json").read_text())
        assert pre["counters"]["serve.migration_acked"] == migrated
    finally:
        if fd is not None:
            fd.close()
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
        for f in logs:
            f.close()
