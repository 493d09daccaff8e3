"""One serving replica as a real process: TCP front, engine loop, drain.

The port's copy of ``flextree_tpu/serving/replica_main.py``, on the card::

    python -m flextree_tpu_torch.serving.replica_main --rank R --dir CTRL \
        [--role prefill|decode|both] [model flags] [--cpu]

boots a :class:`~.engine.ServingEngine` behind the :mod:`.rpc` frame
protocol (the JAX package's wire) and registers it in a shared control
directory:

- an **endpoint file** ``rpc_{rank:05d}.json`` (host, port, pid, role)
  written with the CRC-trailer discipline, the front door's discovery
  source;
- a :class:`~..runtime.supervisor.Supervisor` **heartbeat**, so
  :class:`MembershipView` classifies this process HEALTHY / STRAGGLER /
  DEAD — a SIGKILL'd replica leaves a lease expiry, a SIGSTOP'd one a
  stale-but-leased beat;
- the **flight recorder** (``flight_{rank:05d}.jsonl`` + a
  ``metrics_{rank:05d}.json`` snapshot on exit, which carries the paged
  kernel's launch count over the serving life as the gauge
  ``serve.paged_attention_launches``, beside ``serve.decode_steps``).

The process runs on ``cuda`` unless given ``--cpu``; with no card and no
``--cpu`` it raises.  Its decode runs the engine's default, fused
attention on the CUDA paged-attention kernel (``--no-fused-decode``: the
gather path, which the JAX replica always takes); a kernel that fails to
build or launch fails the process, never falls back.  Weights come from
``init_params`` seeded with ``--seed``, so every replica (and an
in-process oracle) holds the same model.

Threading: sockets are owned by daemon threads (one acceptor, one reader
per connection) that do nothing but parse frames and push work onto an
intake queue — no socket thread creates or reads a tensor; the **engine
loop is the only thread that touches the engine** (and so the only one
that touches the card).  The loop alternates draining intake with
``engine.step()`` and answers each waiter on the connection its request
arrived on.

Exactly-once results: the engine's ``completed`` dict keyed by rid is
the idempotency store.  A retried or hedged attempt for a finished rid
is answered from the store without re-execution; an attempt for an
in-flight rid attaches as an extra waiter on the same execution.

Graceful drain (SIGTERM): stop accepting, answer every queued and
in-flight request with a ``drain`` refusal (the front door re-routes to
survivors), flush the flight record, retire the endpoint file, exit 0.

**Roles** (``--role {prefill,decode,both}``): a ``prefill`` replica only
accepts migrate-flagged generates — it runs the prompt's prefill, emits
the first token, and ships the KV blocks to the decode replica named in
the request (``kv_chunk`` stream + ``kv_admit`` handshake over the same
framed RPC, blocks held until the ack); a ``decode`` replica runs the
normal engine loop and additionally lands migrated sequences
(``engine.admit_migrated``, on the engine loop); ``both`` (the default)
is the colocated engine.

Fault-injection knobs (env, off by default): ``FT_RPC_TEAR_EVERY=k``
corrupts a byte inside every k-th response frame's payload (the client's
CRC check must catch it); ``FT_RPC_DECODE_SLEEP=s`` stretches every
decode round by ``s`` seconds; ``FT_RPC_PREFILL_SLEEP=s`` stretches every
prefill by ``s`` seconds per computed prompt token.
"""

from __future__ import annotations

import argparse
import os
import queue
import signal
import socket
import sys
import threading
import time

from ..obs import record_event
from ..runtime.ctrlfile import write_control_json
from ..runtime.supervisor import Supervisor, SupervisorConfig
from ..utils.logging import get_logger
from .migration import MigrationError
from .rpc import (
    RpcConnection,
    RpcError,
    chunk_blob,
    encode_frame,
    join_chunks,
    recv_frame,
)

__all__ = ["ENDPOINT_FMT", "ROLES", "ReplicaConfig", "ReplicaServer", "main"]

log = get_logger("flextree.serving")

ENDPOINT_FMT = "rpc_{rank:05d}.json"

#: replica roles; ``serve.role`` gauge encodes them in this tuple's order
ROLES = ("both", "prefill", "decode")

#: fault-injection env knobs (off unless set)
FT_RPC_TEAR_EVERY_ENV = "FT_RPC_TEAR_EVERY"
FT_RPC_DECODE_SLEEP_ENV = "FT_RPC_DECODE_SLEEP"
FT_RPC_PREFILL_SLEEP_ENV = "FT_RPC_PREFILL_SLEEP"


class ReplicaConfig:
    """Plumbing for one replica process (model config rides separately)."""

    def __init__(
        self,
        rank: int,
        dir: str,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        max_pending: int = 64,
        idle_poll_s: float = 0.02,
        role: str = "both",
    ):
        if role not in ROLES:
            raise ValueError(f"unknown role {role!r}; one of {ROLES}")
        self.rank = int(rank)
        self.dir = dir
        self.host = host
        self.port = int(port)
        self.max_pending = int(max_pending)
        self.idle_poll_s = float(idle_poll_s)
        self.role = role


class ReplicaServer:
    """The accept/parse/execute/respond machine around one engine.

    Usable in-process for tests (``start()`` / ``stop()``) and as the
    body of the real process entrypoint (:func:`main`).
    """

    def __init__(self, engine, cfg: ReplicaConfig):
        self.engine = engine
        self.cfg = cfg
        self._intake: queue.Queue = queue.Queue()
        # rid -> [(sock, corr, attempt, recv_mono), ...]: every attempt
        # waiting on that rid's single execution
        self._waiters: dict[int, list] = {}
        # rid -> recv stamp of the attempt that started the execution
        # (TTFT is measured from first receipt, not from a later retry)
        self._recv_stamp: dict[int, float] = {}
        self._listener: socket.socket | None = None
        self._threads: list[threading.Thread] = []
        self._conns: list[socket.socket] = []
        self._stop = threading.Event()
        self.draining = threading.Event()
        self.drained = threading.Event()
        # optional drain hook (e.g. the prefix handoff export), invoked
        # on the ENGINE thread after refusals, before ``drained`` is set
        # — whatever it writes is durably on disk before any drain ack
        self.on_drain = None
        self.port: int | None = None
        self._sent_frames = 0
        tear = os.environ.get(FT_RPC_TEAR_EVERY_ENV)
        self._tear_every = int(tear) if tear else 0
        sleep = os.environ.get(FT_RPC_DECODE_SLEEP_ENV)
        self._decode_sleep = float(sleep) if sleep else 0.0
        psleep = os.environ.get(FT_RPC_PREFILL_SLEEP_ENV)
        if psleep:
            # applied to EVERY role (colocated included): the knob scales
            # the prefill:decode ratio, it must not bias the comparison
            engine.chaos_prefill_sleep_s = float(psleep)
        # migration state — engine-thread only (like the engine itself):
        # rid -> buffered inbound KV chunks, and cached client
        # connections to decode replicas for outbound shipping
        self._kv_buf: dict[int, list] = {}
        self._mig_conns: dict[tuple, RpcConnection] = {}
        engine.metrics.gauge("serve.role").set(ROLES.index(cfg.role))

    # ---- lifecycle ---------------------------------------------------------

    def start(self, *, engine_thread: bool = True) -> "ReplicaServer":
        """Bind, publish the endpoint file, start the socket threads (and
        the engine loop as a thread unless the caller runs
        :meth:`run_engine_loop` itself — the process entrypoint keeps it
        on the main thread so SIGTERM lands between bytecodes there)."""
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((self.cfg.host, self.cfg.port))
        self._listener.listen(32)
        self._listener.settimeout(0.2)
        self.port = self._listener.getsockname()[1]
        os.makedirs(self.cfg.dir, exist_ok=True)
        path = os.path.join(
            self.cfg.dir, ENDPOINT_FMT.format(rank=self.cfg.rank)
        )
        write_control_json(
            self.cfg.dir, path,
            {
                "rank": self.cfg.rank,
                "pid": os.getpid(),
                "host": self.cfg.host,
                "port": self.port,
                "role": self.cfg.role,
                "wall": time.time(),
            },
        )
        t = threading.Thread(
            target=self._accept_loop, daemon=True, name="ft-rpc-accept"
        )
        t.start()
        self._threads.append(t)
        if engine_thread:
            t = threading.Thread(
                target=self.run_engine_loop, daemon=True,
                name="ft-rpc-engine",
            )
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:
                pass
        self._close_conns()
        for c in self._mig_conns.values():
            c.close()
        self._mig_conns.clear()
        for t in self._threads:
            t.join(timeout=2.0)
        # a connection the acceptor admitted DURING the close sweep above
        # would otherwise survive with a client blocked on it until its
        # attempt timeout — sweep again now that the acceptor has joined
        self._close_conns()

    def _close_conns(self) -> None:
        for conn in list(self._conns):
            # shutdown first: close() alone does not wake a reader
            # thread blocked in recv on another thread's stack
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass

    def initiate_drain(self) -> None:
        """Signal-handler entry: flip the flag, let the engine loop do
        the actual refusals on its own thread/iteration."""
        self.draining.set()

    # ---- socket side (daemon threads; never touch the engine) --------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            conn.settimeout(None)
            self._conns.append(conn)
            t = threading.Thread(
                target=self._read_loop, args=(conn,), daemon=True,
                name="ft-rpc-conn",
            )
            t.start()
            self._threads.append(t)

    def _read_loop(self, conn: socket.socket) -> None:
        while not self._stop.is_set():
            try:
                payload = recv_frame(conn)
            except RpcError:
                # client went away or sent a torn frame: this connection
                # is unrecoverable (byte stream can't resync) — drop it;
                # the engine loop skips dead-socket waiters on respond
                try:
                    conn.close()
                except OSError:
                    pass
                return
            self._intake.put((conn, payload, time.monotonic()))

    # ---- engine side (ONE thread owns the engine) --------------------------

    def run_engine_loop(self) -> None:
        """Drain intake, step the engine, answer completions — until
        stopped or drained.  The only frame-sending thread, so responses
        on a shared connection never interleave."""
        while not self._stop.is_set():
            if self.draining.is_set():
                self._drain()
                return
            busy = not self.engine.idle
            self._pump_intake(block=not busy)
            if not self.engine.idle:
                if self._decode_sleep:
                    time.sleep(self._decode_sleep)
                self.engine.step()
            self._flush_completions()

    def _pump_intake(self, *, block: bool) -> None:
        timeout = self.cfg.idle_poll_s if block else 0.0
        while True:
            try:
                conn, payload, recv_mono = self._intake.get(timeout=timeout)
            except queue.Empty:
                return
            timeout = 0.0  # only the first get() blocks
            self._handle(conn, payload, recv_mono)

    def _prefill_depth(self) -> int:
        """Prefill backlog right now: migrate work still parked in intake
        (handling is synchronous on the engine thread, so intake IS the
        queue).  Exported as a gauge and piggybacked on every reply a
        prefill replica sends — the front door's dispatch weight."""
        depth = self._intake.qsize()
        self.engine.metrics.gauge("serve.prefill_queue_depth").set(depth)
        return depth

    def _handle(self, conn, payload: dict, recv_mono: float) -> None:
        corr = payload.get("corr")
        kind = payload.get("kind")
        if kind == "ping":
            self._respond(
                conn, corr,
                {"ok": True, "rank": self.cfg.rank, "role": self.cfg.role,
                 "prefill_depth": self._prefill_depth()},
            )
            return
        if kind in ("kv_chunk", "kv_admit"):
            self._handle_kv(conn, corr, kind, payload, recv_mono)
            return
        if kind != "generate":
            self._respond(
                conn, corr,
                {"ok": False, "code": "FT_RPC_ERROR",
                 "error": f"unknown kind {kind!r}"},
            )
            return
        rid = int(payload["rid"])
        attempt = int(payload.get("attempt", 0))
        if self.draining.is_set():
            self._respond(
                conn, corr, {"ok": False, "drain": True, "rid": rid}
            )
            return
        if payload.get("migrate_to") is not None:
            if self.cfg.role == "decode":
                # mis-routed: decode replicas never run the prefill half
                self._respond(
                    conn, corr,
                    {"ok": False, "code": "FT_RPC_SHED", "rid": rid,
                     "reason": "role"},
                )
                return
            self._handle_migrate(conn, corr, payload, recv_mono)
            return
        if self.cfg.role == "prefill":
            # a prefill replica holds no decode slots for the fleet: a
            # plain generate here would silently recreate the colocated
            # stall disaggregation exists to remove
            self._respond(
                conn, corr,
                {"ok": False, "code": "FT_RPC_SHED", "rid": rid,
                 "reason": "role"},
            )
            return
        # deadline propagation: the front door sends the REMAINING budget
        # (monotonic clocks have no cross-process epoch, so the wire
        # carries a duration, stamped against our clock at receipt)
        deadline = payload.get("deadline_in_s")
        if deadline is not None and float(deadline) <= 0.0:
            self.engine.metrics.counter("serve.deadline_refused").inc()
            record_event(
                "serve_deadline_refused", rid=rid, attempt=attempt,
            )
            self._respond(
                conn, corr,
                {"ok": False, "code": "FT_RPC_TIMEOUT", "rid": rid},
            )
            return
        # ---- the idempotency store: engine.completed keyed by rid ----
        done = self.engine.completed.get(rid)
        if done is not None:
            self.engine.metrics.counter("serve.dedup_hits").inc()
            record_event("serve_dedup", rid=rid, attempt=attempt,
                         stage="completed")
            self._respond(conn, corr, self._result_payload(rid, attempt))
            return
        if rid in self._waiters:
            # in-flight: attach this attempt to the single execution
            self.engine.metrics.counter("serve.dedup_hits").inc()
            record_event("serve_dedup", rid=rid, attempt=attempt,
                         stage="inflight")
            self._waiters[rid].append((conn, corr, attempt))
            return
        # ---- replica-side admission: bounded backlog -----------------
        backlog = len(self._waiters)
        if backlog >= self.cfg.max_pending:
            self.engine.metrics.counter("serve.shed").inc()
            record_event(
                "serve_shed", rid=rid, attempt=attempt, where="replica",
                backlog=backlog,
            )
            self._respond(
                conn, corr, {"ok": False, "code": "FT_RPC_SHED", "rid": rid}
            )
            return
        import numpy as np

        from .batcher import Request

        req = Request(
            rid=rid,
            prompt=np.asarray(payload["prompt"], np.int32),
            max_new_tokens=int(payload["max_new_tokens"]),
            arrival_s=recv_mono,  # replica-clock stamp; the front door
            # composes total TTFT from its own arrival stamp
        )
        if not self.engine.submit(req):
            self.engine.metrics.counter("serve.shed").inc()
            record_event(
                "serve_shed", rid=rid, attempt=attempt, where="replica",
                reason="rejected",
            )
            self._respond(
                conn, corr, {"ok": False, "code": "FT_RPC_SHED", "rid": rid}
            )
            return
        self._waiters[rid] = [(conn, corr, attempt)]
        self._recv_stamp[rid] = recv_mono

    # ---- migration: the prefill half (runs on the engine thread) -----------

    def _handle_migrate(self, conn, corr, payload: dict,
                        recv_mono: float) -> None:
        """Prefill + ship + reply: the whole export→ship→admit-or-refuse→
        release handshake, synchronous on the engine thread (a prefill
        replica's engine has no resident decodes to starve; the intake
        backlog is the queue depth the front door weighs)."""
        import numpy as np

        from .batcher import Request

        rid = int(payload["rid"])
        attempt = int(payload.get("attempt", 0))
        to = payload["migrate_to"]
        codec = str(payload.get("codec", "f32"))
        deadline = payload.get("deadline_in_s")
        if deadline is not None and float(deadline) <= 0.0:
            self.engine.metrics.counter("serve.deadline_refused").inc()
            self._respond(
                conn, corr,
                {"ok": False, "code": "FT_RPC_TIMEOUT", "rid": rid},
            )
            return
        req = Request(
            rid=rid,
            prompt=np.asarray(payload["prompt"], np.int32),
            max_new_tokens=int(payload["max_new_tokens"]),
            arrival_s=recv_mono,
        )
        t0 = time.monotonic()
        try:
            out = self.engine.prefill_for_migration(req, codec=codec)
        except MigrationError as e:
            self._respond(
                conn, corr,
                {"ok": False, "code": MigrationError.code, "rid": rid,
                 "error": str(e), "migrate_failed": True},
            )
            return
        if out is None:  # pool cannot hold the prompt right now
            self.engine.metrics.counter("serve.shed_prefill").inc()
            record_event("serve_shed", rid=rid, attempt=attempt,
                         where="replica", role="prefill",
                         reason="export_blocked")
            self._respond(
                conn, corr,
                {"ok": False, "code": "FT_RPC_SHED", "rid": rid,
                 "reason": "export_blocked",
                 "prefill_depth": self._prefill_depth()},
            )
            return
        remaining = None
        if deadline is not None:
            remaining = float(deadline) - (time.monotonic() - recv_mono)
        ship_timeout = max(min(10.0 if remaining is None else remaining,
                               10.0), 0.5)
        try:
            reply = self._ship_kv(to, rid, attempt, payload, out,
                                  timeout_s=ship_timeout)
        except (RpcError, OSError, KeyError, TypeError, ValueError) as e:
            # receiver unreachable, died mid-stream, or spoke garbage:
            # ABORT — release our export, let the front door retry
            self.engine.release_exported(rid, acked=False)
            self.engine.metrics.counter("serve.migration_ship_failed").inc()
            record_event("serve_migration_ship_failed", rid=rid,
                         error=str(e)[:120])
            self._respond(
                conn, corr,
                {"ok": False, "code": "FT_RPC_CONN_REFUSED", "rid": rid,
                 "migrate_failed": True, "error": str(e)[:120]},
            )
            return
        if not reply.get("ok") or not reply.get("admitted"):
            # clean refusal from the decode side (capacity or poisoned):
            # same abort discipline, different loudness
            self.engine.release_exported(rid, acked=False)
            self.engine.metrics.counter("serve.migration_ship_refused").inc()
            record_event("serve_migration_ship_refused", rid=rid,
                         code=reply.get("code"))
            self._respond(
                conn, corr,
                {"ok": False,
                 "code": str(reply.get("code", MigrationError.code)),
                 "rid": rid, "migrate_failed": True},
            )
            return
        # ACK: the decode side owns a verified copy — NOW the blocks go
        self.engine.release_exported(rid, acked=True)
        ship_ms = (time.monotonic() - t0) * 1e3
        self.engine.metrics.histogram("serve.migration_ms").observe(ship_ms)
        record_event(
            "serve_migration_send", rid=rid,
            to_rank=int(to.get("rank", -1)), codec=codec,
            bytes=len(out["blob"]), ms=round(ship_ms, 3),
        )
        self._respond(
            conn, corr,
            {"ok": True, "rid": rid, "attempt": attempt,
             "rank": self.cfg.rank, "handoff": True,
             "decode_rank": int(to.get("rank", -1)),
             "ttft_s": round(out["ttft_s"], 6),
             "prefill_depth": self._prefill_depth()},
        )

    def _ship_kv(self, to: dict, rid: int, attempt: int, payload: dict,
                 out: dict, *, timeout_s: float) -> dict:
        """Stream the packed KV to the decode replica: bounded
        ``kv_chunk`` frames, then the ``kv_admit`` frame carrying the
        meta, the first token, and the request — the receiver's
        admit-or-refuse comes back as this call's reply."""
        key = (str(to["host"]), int(to["port"]))
        conn = self._mig_conns.get(key)
        if conn is None or conn.dead is not None:
            conn = RpcConnection.connect(
                key[0], key[1], timeout_s=min(timeout_s, 2.0)
            )
            self._mig_conns[key] = conn
        chunks = chunk_blob(out["blob"])
        try:
            for i, c in enumerate(chunks[:-1]):
                ack = conn.call(
                    {"kind": "kv_chunk", "rid": rid, "seq": i, "chunk": c},
                    timeout_s=timeout_s,
                )
                if not ack.get("ok"):
                    return ack
            return conn.call(
                {
                    "kind": "kv_admit",
                    "rid": rid,
                    "attempt": attempt,
                    "seq": len(chunks) - 1,
                    "total": len(chunks),
                    "chunk": chunks[-1],
                    "meta": out["meta"],
                    "first_token": out["first_token"],
                    "prompt": [int(t) for t in payload["prompt"]],
                    "max_new_tokens": int(payload["max_new_tokens"]),
                },
                timeout_s=timeout_s,
            )
        except RpcError:
            stale = self._mig_conns.pop(key, None)
            if stale is not None:
                stale.close()
            raise

    # ---- migration: the decode half (runs on the engine thread) ------------

    def _handle_kv(self, conn, corr, kind: str, payload: dict,
                   recv_mono: float) -> None:
        """Receive a KV transfer: buffer ``kv_chunk`` frames, then on
        ``kv_admit`` reassemble, verify, and land the sequence
        (admit-or-refuse — never a queue: the prefill side is holding
        blocks against our answer)."""
        import numpy as np

        from .batcher import Request

        rid = int(payload["rid"])
        if self.draining.is_set() or self.cfg.role == "prefill":
            self._kv_buf.pop(rid, None)
            self._respond(
                conn, corr,
                {"ok": False, "drain": self.draining.is_set(), "rid": rid,
                 "code": "FT_RPC_SHED", "reason": "role"
                 if self.cfg.role == "prefill" else "drain"},
            )
            return
        if kind == "kv_chunk":
            buf = self._kv_buf.setdefault(rid, [])
            # a runaway stream must not buffer unbounded bytes: cap at
            # what MAX_FRAME_BYTES-bounded chunks can legitimately need
            # for one pool's worth of blocks
            if len(buf) >= 64:
                self._kv_buf.pop(rid, None)
                self._respond(
                    conn, corr,
                    {"ok": False, "code": MigrationError.code, "rid": rid,
                     "error": "chunk stream exceeds buffer cap"},
                )
                return
            buf.append((int(payload["seq"]), str(payload["chunk"])))
            self._respond(conn, corr, {"ok": True, "rid": rid,
                                       "seq": int(payload["seq"])})
            return
        # ---- kv_admit: reassemble + verify + admit -------------------
        parts = self._kv_buf.pop(rid, [])
        parts.append((int(payload["seq"]), str(payload["chunk"])))
        total = int(payload.get("total", len(parts)))
        seqs = [s for s, _ in parts]
        if sorted(seqs) != list(range(total)):
            self._respond(
                conn, corr,
                {"ok": False, "code": MigrationError.code, "rid": rid,
                 "error": f"chunk sequence {sorted(seqs)} != 0..{total - 1}"},
            )
            return
        # idempotent re-send (the prefill side retried after a lost ack):
        # the sequence is already ours — ack again, never double-admit
        inflight = {r.rid for r in self.engine.batcher.inflight_requests()}
        if rid in self.engine.completed or rid in inflight:
            self.engine.metrics.counter("serve.dedup_hits").inc()
            record_event("serve_dedup", rid=rid, stage="migrated")
            self._respond(conn, corr,
                          {"ok": True, "admitted": True, "rid": rid,
                           "dup": True})
            return
        try:
            blob = join_chunks(c for _, c in sorted(parts))
            req = Request(
                rid=rid,
                prompt=np.asarray(payload["prompt"], np.int32),
                max_new_tokens=int(payload["max_new_tokens"]),
                arrival_s=recv_mono,
            )
            slot = self.engine.admit_migrated(
                req, int(payload["first_token"]), payload["meta"], blob
            )
        except (RpcError, MigrationError, KeyError, TypeError,
                ValueError) as e:
            self.engine.metrics.counter("serve.migration_poisoned").inc()
            record_event("serve_migration_refuse", rid=rid,
                         reason="poisoned", error=str(e)[:120])
            self._respond(
                conn, corr,
                {"ok": False, "code": MigrationError.code, "rid": rid,
                 "error": str(e)[:200]},
            )
            return
        if slot is None:  # capacity refusal (counted by the engine)
            self._respond(
                conn, corr,
                {"ok": False, "code": "FT_RPC_SHED", "rid": rid,
                 "reason": "capacity"},
            )
            return
        # a placeholder waiter entry makes the rid IN-FLIGHT to the
        # dedup path: the front door's collect-generate attaches here
        # instead of re-submitting a resident sequence
        self._waiters.setdefault(rid, [])
        self._recv_stamp[rid] = recv_mono
        self._respond(conn, corr,
                      {"ok": True, "admitted": True, "rid": rid})

    def _flush_completions(self) -> None:
        if not self._waiters:
            return
        finished = [
            rid for rid in self._waiters if rid in self.engine.completed
        ]
        for rid in finished:
            waiters = self._waiters.pop(rid)
            for conn, corr, attempt in waiters:
                self._respond(conn, corr, self._result_payload(rid, attempt))
            self._recv_stamp.pop(rid, None)

    def _result_payload(self, rid: int, attempt: int) -> dict:
        done = self.engine.completed[rid]
        return {
            "ok": True,
            "rid": rid,
            "attempt": attempt,
            "rank": self.cfg.rank,
            "tokens": [int(t) for t in done.tokens],
            # durations on THIS process's monotonic clock; the front
            # door adds its own queue/retry time on its clock
            "ttft_s": round(done.ttft_s, 6),
            "decode_s": round(done.done_s - done.first_token_s, 6),
            # per-decode-token gaps on this clock: the inter-token
            # latency samples
            "intervals_s": [round(d, 6) for d in done.intervals_s],
        }

    def _drain(self) -> None:
        """Refuse everything outstanding so the front door re-routes it,
        then stop.  In-flight executions are abandoned mid-decode — the
        survivors' recompute is bit-identical, so dropping partial work
        is correct (and cheaper than a token-handoff protocol)."""
        self._pump_intake(block=False)  # late arrivals get refusals too
        n = 0
        for rid, waiters in sorted(self._waiters.items()):
            for conn, corr, _attempt in waiters:
                self._respond(
                    conn, corr, {"ok": False, "drain": True, "rid": rid}
                )
                n += 1
        self._waiters.clear()
        self._recv_stamp.clear()
        self.engine.metrics.counter("serve.drain_refusals").inc(n)
        record_event("drain", rank=self.cfg.rank, refused=n,
                     reason="sigterm")
        if self.on_drain is not None:
            try:
                self.on_drain()
            except Exception as e:  # a failed export must not wedge drain
                log.warning("replica %d drain hook failed: %s",
                            self.cfg.rank, e)
                record_event("serve_drain_hook_failed", rank=self.cfg.rank,
                             error=str(e))
        log.info("replica %d drained: %d refusals", self.cfg.rank, n)
        self.drained.set()

    def _respond(self, conn, corr, payload: dict) -> None:
        raw = encode_frame(dict(payload, corr=corr))
        self._sent_frames += 1
        if (
            self._tear_every
            and self._sent_frames % self._tear_every == 0
            and len(raw) > 12
        ):
            # fault injection: flip one byte mid-body.  The length header stays
            # correct so the client reads a full, aligned frame — the
            # CRC trailer is the ONLY thing standing between this and a
            # silently corrupted token stream
            torn = bytearray(raw)
            torn[8] ^= 0xFF
            raw = bytes(torn)
            record_event("rpc_tear_injected", frame=self._sent_frames)
        try:
            conn.sendall(raw)
        except OSError:
            # client hung up (timed out, hedged elsewhere, died): its
            # result stays in the idempotency store for the retry
            pass


# --------------------------------------------------------------------------
# the process entrypoint
# --------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m flextree_tpu_torch.serving.replica_main")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--dir", required=True,
                    help="shared control dir (endpoints + heartbeats + obs)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--max-pending", type=int, default=64)
    ap.add_argument("--role", choices=ROLES, default="both",
                    help="prefill: migrate-flagged generates only; "
                         "decode: engine loop + migrated admissions; "
                         "both: the colocated engine (default)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--blocks", type=int, default=65)
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--blocks-per-seq", type=int, default=10)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--n-heads", type=int, default=8)
    ap.add_argument("--n-layers", type=int, default=4)
    ap.add_argument("--d-ff", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card; with "
                         "no card and no --cpu the replica refuses)")
    ap.add_argument("--fused-decode", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="fused paged attention (the CUDA kernel on the "
                         "card, its plain stream on the CPU); "
                         "--no-fused-decode: the gather path")
    ap.add_argument("--warmup-prompt-lens", default="",
                    help="CSV of prompt lengths to run once before serving")
    ap.add_argument("--warmup-max-new", type=int, default=0,
                    help="warm the block-reservation write for prompt+this")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="enable the cross-request prefix cache")
    ap.add_argument("--warmup-suffix-lens", default="",
                    help="CSV of cached:suffix pairs (e.g. 32:4,32:12) to "
                         "run the suffix prefill for before serving")
    ap.add_argument("--handoff-out", default="",
                    help="on drain, export the prefix index (token "
                         "prefixes + block content hashes) to this file")
    ap.add_argument("--handoff-in", default="",
                    help="at boot, pre-warm the prefix cache from a "
                         "predecessor's handoff export (checksum-refused "
                         "or missing file degrades to a cold start)")
    args = ap.parse_args(argv)

    import torch

    from ..device import resolve_device
    from ..models.transformer import TransformerConfig, init_params
    from ..obs import flight_recorder, install_signal_dump
    from ..ops import paged_attention as pa
    from . import BatcherConfig, PagedCacheConfig, ServingEngine

    dev = resolve_device("cpu" if args.cpu else None)
    cfg = TransformerConfig(
        vocab_size=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, d_ff=args.d_ff,
    )
    # deterministic params: every replica (and an in-process oracle)
    # draws the same weights from the seed on the CPU generator
    params = init_params(cfg, torch.Generator().manual_seed(args.seed),
                         device=dev)
    pcfg = PagedCacheConfig(
        num_blocks=args.blocks, block_size=args.block_size,
        blocks_per_seq=args.blocks_per_seq,
    )
    engine = ServingEngine(
        params, cfg, pcfg,
        BatcherConfig(slots=args.slots, prefix_cache=args.prefix_cache),
        fused=args.fused_decode, device=dev,
    )
    lens = sorted({int(t) for t in args.warmup_prompt_lens.split(",") if t})
    blocks = (
        {pcfg.blocks_for(t + args.warmup_max_new) for t in lens}
        if args.warmup_max_new else ()
    )
    buckets = [
        tuple(int(x) for x in pair.split(":"))
        for pair in args.warmup_suffix_lens.split(",") if pair
    ]
    # a decode-capable replica may receive migrated KV for any of these
    # prompt lengths: warm the import write for each block count
    imports = (
        {pcfg.blocks_for(t) for t in lens} if args.role != "prefill" else ()
    )
    engine.warmup(lens, blocks, suffix_buckets=buckets,
                  import_counts=imports)
    pa.paged_attention.launches = 0

    rcfg = ReplicaConfig(
        args.rank, args.dir, host=args.host, port=args.port,
        max_pending=args.max_pending, role=args.role,
    )
    server = ReplicaServer(engine, rcfg)
    if args.handoff_out:

        def _export_handoff() -> None:
            doc = engine.export_prefix_handoff()
            if doc is not None:
                write_control_json(args.dir, args.handoff_out, doc)

        server.on_drain = _export_handoff
    with flight_recorder(
        args.dir, args.rank, source="serve", registry=engine.metrics
    ) as rec:
        # inside the recorder, so a cold start is loud in the flight
        # record, not just in the exit counters
        if args.handoff_in:
            from ..runtime.ctrlfile import read_control_json

            doc = read_control_json(args.handoff_in)
            if doc is None:
                # missing or checksum-refused: cold start, never guessing
                # at corrupt bytes
                engine.metrics.counter("serve.handoff_cold_start").inc()
                record_event("serve_handoff_cold_start", rank=args.rank,
                             path=args.handoff_in)
                log.warning("replica %d: handoff %s absent/refused — "
                            "cold start", args.rank, args.handoff_in)
            else:
                stats = engine.prewarm_prefix_from_handoff(doc)
                record_event("serve_handoff_prewarm", rank=args.rank,
                             **stats)
                log.info("replica %d pre-warmed from %s: %s", args.rank,
                         args.handoff_in, stats)
        signal.signal(signal.SIGTERM, lambda s, f: server.initiate_drain())
        install_signal_dump(rec, (signal.SIGTERM,))
        with Supervisor(SupervisorConfig.from_env(args.rank, args.dir)) as sup:
            server.start(engine_thread=False)
            log.info(
                "replica %d (%s on %s) serving on %s:%d (pid %d)",
                args.rank, args.role, dev, rcfg.host, server.port,
                os.getpid(),
            )
            # the engine loop runs here, on the main thread, so SIGTERM's
            # drain flag is observed within one loop iteration
            try:
                server.run_engine_loop()
            finally:
                sup.record_step(engine.steps)
                # the kernel's launches over this process's serving life,
                # into the metrics snapshot the recorder writes on exit
                launches = int(pa.paged_attention.launches)
                engine.metrics.gauge("serve.paged_attention_launches").set(
                    launches)
                engine.metrics.gauge("serve.decode_steps").set(
                    engine.decode_steps)
                log.info("replica %d: paged_attention launches %d over %d "
                         "decode rounds", args.rank, launches,
                         engine.decode_steps)
            server.stop()
    if server.drained.is_set():
        # a clean drain retires the endpoint so discovery stops routing
        # here (a crash leaves it — the front door's strike/avoid logic
        # and the heartbeat DEAD classification cover that path)
        try:
            os.unlink(os.path.join(
                args.dir, ENDPOINT_FMT.format(rank=args.rank)
            ))
        except OSError:
            pass
    # a drain exit is a success (rc 0): the front door re-routed our work
    return 0


if __name__ == "__main__":
    sys.exit(main())
