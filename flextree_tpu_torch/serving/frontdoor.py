"""The fault-tolerant front door: route, retry, hedge, shed, account.

The port's copy of ``flextree_tpu/serving/frontdoor.py``: host-side
threads and sockets only, no tensors, speaking the JAX package's frames.
The client side of the real-process serving stack (:mod:`.replica_main`
is the server side, :mod:`.rpc` the wire).  One :class:`FrontDoor` owns
the request lifecycle from intake to exactly-once result:

- **discovery** — replicas are found through the shared control dir:
  ``rpc_{rank:05d}.json`` endpoint files (CRC-trailered) say where to
  connect, the Supervisor heartbeats say who is HEALTHY / STRAGGLER /
  DEAD (:class:`~..runtime.supervisor.MembershipView`);
- **routing** — healthy replicas first, least-outstanding among them
  (the JAX replica pool's ``_route`` rule, over processes), circuit-breaker
  strike-out per replica (``breaker_strikes`` consecutive transport
  failures open it for ``breaker_cooldown_s``);
- **deadlines** — every request has one total budget from its arrival
  stamp; the wire carries the *remaining* budget (monotonic clocks have
  no cross-process epoch), and a replica refuses an already-expired
  request instead of executing it;
- **retries** — bounded exponential backoff on the typed transport
  failures (``FT_RPC_TIMEOUT`` / ``FT_RPC_CONN_REFUSED`` /
  ``FT_RPC_TORN_FRAME``) and on replica-side sheds; a ``drain`` refusal
  re-routes immediately (the replica is leaving, not failing);
- **hedging** — when an attempt is still outstanding after the windowed
  p99 of recent attempt latencies (times ``hedge_factor``), a duplicate
  attempt goes to a *different* replica and the first result wins.  Safe
  by construction: the replica-side idempotency store computes each rid
  once, so the loser is a wasted RPC, never a forked sequence;
- **shedding** — over ``shed_outstanding`` requests in flight, intake
  refuses loudly (``serve.shed`` + a ``serve_shed`` flight event) rather
  than queueing into a latency cliff;
- **exactly-once results** — ``completed`` is first-writer-wins under a
  lock; a hedge race's second result increments
  ``serve.duplicate_results`` and is dropped.

TTFT is stamped ONCE at intake (:meth:`FrontDoor.submit`): however many
retries, hedges, and re-routes a request suffers, its reported TTFT is
``(winning attempt's send - arrival) + the replica's queue-to-first-
token time`` — queue and retry time included.  Per-replica windowed TTFT
histograms (and the retry/hedge/shed/drain counters) export as
Prometheus text (:meth:`FrontDoor.prometheus`) and as
``metrics_*.json`` files (:meth:`FrontDoor.write_metrics`).

Disaggregation: with ``migrate_min_prompt_len`` set, a prompt at least
that long goes to a ``prefill`` replica with a ``migrate_to`` naming a
decode replica; the prefill replica ships the KV there and answers with
a handoff, and a collect generate on the decode replica returns the
tokens.  Shorter prompts run colocated on the decode tier.

Clocks (``_now``) and backoff sleeps (``_sleep``) are module-level
injectables, same pattern as ``engine._now`` / ``supervisor._wall``.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
import zlib

import numpy as np

from ..obs import MetricsRegistry, record_event
from ..runtime.ctrlfile import read_control_json
from ..runtime.supervisor import DEAD, HEALTHY, MembershipView
from ..utils.logging import get_logger
from .rpc import (
    RpcConnection,
    RpcConnRefused,
    RpcError,
    RpcShed,
    RpcTimeout,
)

__all__ = ["FrontDoorConfig", "FrontDoorResult", "ReplicaClient", "FrontDoor"]

log = get_logger("flextree.serving")

# injection points for tests (patch these, not time.*)
_now = time.monotonic
_sleep = time.sleep


@dataclasses.dataclass(frozen=True)
class FrontDoorConfig:
    """Knobs, grouped by mechanism (defaults sized for localhost;
    a real DCN wants every timeout an order of magnitude up)."""

    # deadlines
    request_timeout_s: float = 30.0  # total budget per request
    attempt_timeout_s: float = 4.0  # one RPC's budget (capped by request)
    connect_timeout_s: float = 1.0
    # retries
    max_attempts: int = 8  # total launches per rid, hedges included
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 1.0
    # hedging
    hedge_factor: float = 2.0  # delay = factor x windowed-p99 attempt
    hedge_min_samples: int = 8  # no p99, no hedging (cold start)
    hedge_floor_s: float = 0.05  # never hedge tighter than this
    max_hedges: int = 1  # per attempt round; 0 disables (the twin)
    # breaker
    breaker_strikes: int = 3
    breaker_cooldown_s: float = 2.0
    # shedding: over ``shed_outstanding`` in flight, intake refuses —
    # but PREDICTED PREFIX HITS (first block hashed in the affinity
    # table) ride a further ``shed_hit_headroom`` of slack.  A hit costs
    # a fraction of a miss's prefill, so when something must be shed,
    # shedding the miss first buys more admitted tokens per unit of
    # capacity; 0 restores hit-blind shedding.
    shed_outstanding: int = 64
    shed_hit_headroom: int = 16
    # prefix affinity: requests whose first ``affinity_span`` prompt
    # tokens hash alike PREFER the replica that last completed one (its
    # prefix index is warm there) — a preference only, never overriding
    # health, breaker, or drain avoidance; 0 disables.  Matches the
    # replica default block size so the span is exactly one cacheable
    # block.
    affinity_span: int = 8
    # disaggregation: prompts of at least ``migrate_min_prompt_len``
    # tokens route to a dedicated prefill replica, which ships the
    # finished KV (coded per ``migrate_codec``) to a decode replica and
    # hands the request off there; ``None`` disables migration and every
    # request runs colocated.  Set the threshold from
    # ``costs.migration_crossover_tokens`` so the per-request
    # migrate-vs-recompute decision is one integer compare against the
    # planner's crossover — short prompts never pay the hop.
    migrate_min_prompt_len: int | None = None
    migrate_codec: str = "f32"
    # workers + membership thresholds (match SupervisorConfig defaults)
    dispatchers: int = 4
    straggler_s: float = 1.0
    lease_s: float = 3.0
    slo_window_s: float = 10.0


@dataclasses.dataclass(frozen=True)
class FrontDoorResult:
    """One exactly-once result as the client sees it."""

    rid: int
    tokens: np.ndarray
    ttft_s: float  # arrival -> first token, queue + retries included
    rank: int  # the replica whose attempt won
    attempts: int  # launches it took (1 = clean first try)
    hedged: bool
    migrated: bool = False  # prefill ran on a prefill replica, KV shipped
    # replica-measured gaps between consecutive emitted tokens (len =
    # n_tokens - 1): the decode inter-token latency, free of front-door
    # queueing
    intervals_s: tuple = ()


class ReplicaClient:
    """Front-door state for one replica process: endpoint, connection,
    outstanding count, breaker, and its own windowed-TTFT registry."""

    def __init__(self, rank: int, cfg: FrontDoorConfig):
        self.rank = rank
        self.cfg = cfg
        self.host: str | None = None  # guarded-by: _lock
        self.port: int | None = None  # guarded-by: _lock
        self.pid: int | None = None  # guarded-by: _lock
        self.role = "both"  # guarded-by: _lock (from the endpoint file)
        self.prefill_depth = 0  # guarded-by: _lock (replica-reported)
        self.conn: RpcConnection | None = None  # guarded-by: _lock
        self.outstanding = 0  # guarded-by: _lock
        self.strikes = 0  # guarded-by: _lock
        self.open_until = 0.0  # guarded-by: _lock (breaker horizon, _now)
        self.registry = MetricsRegistry()
        self.registry.windowed_histogram(
            "serve.ttft_ms", interval_s=cfg.slo_window_s / 10.0, intervals=10
        )
        self._lock = threading.Lock()

    def update_endpoint(
        self, host: str, port: int, pid: int, role: str = "both"
    ) -> None:
        # called from whichever dispatcher thread refreshes first, racing
        # connection() on other dispatchers — same lock, or a half-updated
        # endpoint can be dialed
        with self._lock:
            if (host, port, pid, role) == (
                self.host, self.port, self.pid, self.role
            ):
                return
            # a replaced process (same rank, new pid/port): drop the old
            # connection, the next attempt dials the new endpoint
            old, self.conn = self.conn, None
            self.host, self.port, self.pid = host, port, pid
            self.role = role
        if old is not None:
            old.close()

    def connection(self) -> RpcConnection:
        """The rank's live connection, dialing if needed.  The dial
        happens OUTSIDE the lock — a slow/unreachable endpoint must cost
        only the dialing thread, not every thread touching this client's
        breaker or outstanding count for connect_timeout_s."""
        with self._lock:
            if self.conn is not None and self.conn.dead is None:
                return self.conn
            host, port = self.host, self.port
        if host is None or port is None:
            raise RpcConnRefused(f"rank {self.rank}: no endpoint")
        conn = RpcConnection.connect(
            host, port, timeout_s=self.cfg.connect_timeout_s
        )
        with self._lock:
            if self.conn is not None and self.conn.dead is None:
                # lost a dial race: keep the winner, close ours
                loser = conn
            elif (host, port) != (self.host, self.port):
                # endpoint replaced mid-dial: the process we reached is
                # the stale one — fail this attempt, next one redials
                loser = conn
                conn = None
            else:
                self.conn = conn
                loser = None
            winner = self.conn
        if loser is not None:
            loser.close()
        if conn is None:
            raise RpcConnRefused(
                f"rank {self.rank}: endpoint replaced mid-dial"
            )
        return winner

    # breaker ----------------------------------------------------------------

    def breaker_open(self, now: float) -> bool:
        return now < self.open_until

    def strike(self, now: float, registry: MetricsRegistry) -> None:
        # dispatcher threads strike concurrently; unlocked, two strikes
        # can lose an increment and a breaker that should open stays shut
        with self._lock:
            self.strikes += 1
            opened = self.strikes >= self.cfg.breaker_strikes
            if opened:
                self.open_until = now + self.cfg.breaker_cooldown_s
                self.strikes = 0
        if opened:
            registry.counter("serve.breaker_opens").inc()
            record_event(
                "breaker_open", peer=self.rank,
                cooldown_s=self.cfg.breaker_cooldown_s,
            )

    def clear_strikes(self) -> None:
        with self._lock:
            self.strikes = 0

    def close(self) -> None:
        with self._lock:
            conn, self.conn = self.conn, None
        if conn is not None:
            conn.close()


class FrontDoor:
    """Route requests to replica processes; deliver exactly-once results.

    Usage::

        fd = FrontDoor(ctrl_dir, FrontDoorConfig()).start()
        for r in requests:
            fd.submit(r.rid, r.prompt, r.max_new_tokens)
        fd.wait_idle(timeout_s=60)
        fd.completed[rid].tokens  # np.int32, bitwise vs generate
        fd.close()
    """

    def __init__(self, dir: str, cfg: FrontDoorConfig | None = None):
        self.dir = dir
        self.cfg = cfg or FrontDoorConfig()
        self.metrics = MetricsRegistry()
        self.metrics.windowed_histogram(
            "serve.ttft_ms",
            interval_s=self.cfg.slo_window_s / 10.0, intervals=10,
        )
        # attempt latency drives the hedge trigger: a WINDOWED p99 so a
        # quiet hour ago can't mask a straggler now
        self.metrics.windowed_histogram(
            "serve.attempt_ms",
            interval_s=self.cfg.slo_window_s / 10.0, intervals=10,
        )
        self.membership = MembershipView(
            dir, straggler_s=self.cfg.straggler_s, lease_s=self.cfg.lease_s
        )
        self.clients: dict[int, ReplicaClient] = {}  # guarded-by: _lock
        self.completed: dict[int, FrontDoorResult] = {}  # guarded-by: _lock
        self.failed: dict[int, str] = {}  # guarded-by: _lock (FT_RPC_* code)
        self.shed_rids: list[int] = []  # guarded-by: _lock
        self._arrival: dict[int, float] = {}  # guarded-by: _lock
        self._attempt_seq: dict[int, int] = {}  # guarded-by: _lock
        # prefix affinity: first-block hash -> rank that last completed a
        # request carrying it (that replica's prefix index is warm)
        self._affinity: dict[int, int] = {}  # guarded-by: _lock
        self._rid_phash: dict[int, int] = {}  # guarded-by: _lock
        self._inflight: set[int] = set()  # guarded-by: _lock
        # destined role per inflight rid: shed accounting is per role so
        # a flood of long prompts filling the prefill tier can't shed
        # decode-bound traffic (and vice versa)
        self._inflight_role: dict[int, str] = {}  # guarded-by: _lock
        # arrival->first-token of a completed handoff, stamped when the
        # prefill replica reports the migration done; the collect
        # attempt's own ttft would otherwise overwrite the real one
        self._migration_ttft: dict[int, float] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self._work: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    # ---- lifecycle ---------------------------------------------------------

    def start(self) -> "FrontDoor":
        for i in range(self.cfg.dispatchers):
            t = threading.Thread(
                target=self._dispatch_loop, daemon=True,
                name=f"ft-frontdoor-{i}",
            )
            t.start()
            self._threads.append(t)
        return self

    def close(self) -> None:
        self._stop.set()
        for _ in self._threads:
            self._work.put(None)
        for t in self._threads:
            t.join(timeout=2.0)
        with self._lock:
            clients = list(self.clients.values())  # a join timeout above
            # can leave a dispatcher alive and refreshing; don't iterate
            # the live dict under it
        for client in clients:
            client.close()

    # ---- discovery ---------------------------------------------------------

    def refresh(self) -> None:
        """Re-read the endpoint files; a torn or missing file simply
        leaves that rank unroutable until its writer finishes."""
        try:
            names = os.listdir(self.dir)
        except OSError:
            return
        for name in sorted(names):
            if not (name.startswith("rpc_") and name.endswith(".json")):
                continue
            ep = read_control_json(os.path.join(self.dir, name))
            if ep is None:
                continue
            try:
                rank = int(ep["rank"])
                host, port, pid = ep["host"], int(ep["port"]), int(ep["pid"])
                role = str(ep.get("role", "both"))
            except (KeyError, ValueError, TypeError):
                continue
            # the insert races other dispatchers' refresh() calls AND
            # _routable's iteration — both under the same lock; the
            # endpoint update itself locks per client, outside ours
            with self._lock:
                client = self.clients.get(rank)
                if client is None:
                    client = self.clients[rank] = ReplicaClient(
                        rank, self.cfg
                    )
            client.update_endpoint(host, port, pid, role)

    def _routable(
        self, exclude=(), prefer=None, role="decode"
    ) -> "ReplicaClient | None":
        """Healthy first, then stragglers; least-outstanding within the
        tier; DEAD and breaker-open replicas never.  ``prefer`` names a
        rank to pick over the load balance IF it survives every health /
        breaker / exclusion filter into the healthy tier — affinity is a
        tiebreak inside the safe set, never a way back into it.

        ``role`` selects the routing tier: ``"decode"`` (plain and
        collect generates — decode and colocated replicas,
        least-outstanding) or ``"prefill"`` (migrate-flagged prefills —
        dedicated prefill replicas only, weighted by their reported
        intake queue depth plus our outstanding count, so a replica
        digesting a deep prefill backlog stops attracting more)."""
        self.refresh()
        states = {r: s.state for r, s in self.membership.poll().items()}
        now = _now()
        with self._lock:
            clients = list(self.clients.items())  # snapshot vs refresh()
        tiers: dict[str, list[ReplicaClient]] = {"healthy": [], "other": []}
        for rank, client in clients:
            if rank in exclude or client.breaker_open(now):
                continue
            if role == "prefill":
                if client.role != "prefill":
                    continue
            elif client.role == "prefill":
                # dedicated prefill replicas shed plain generates with a
                # "role" refusal — never route one there
                continue
            state = states.get(rank)
            if state == DEAD:
                continue
            key = "healthy" if state in (None, HEALTHY) else "other"
            tiers[key].append(client)
        if prefer is not None:
            for client in tiers["healthy"]:
                if client.rank == prefer:
                    self.metrics.counter("serve.affinity_routed").inc()
                    return client
            self.metrics.counter("serve.affinity_miss").inc()
        if role == "prefill":
            load = lambda c: (c.prefill_depth + c.outstanding, c.rank)
        else:
            load = lambda c: (c.outstanding, c.rank)
        for tier in (tiers["healthy"], tiers["other"]):
            if tier:
                return min(tier, key=load)
        return None

    # ---- intake ------------------------------------------------------------

    def submit(self, rid: int, prompt, max_new_tokens: int) -> bool:
        """Queue one request.  The arrival stamp is written exactly once
        here — a retried / hedged / re-routed request keeps it, so TTFT
        includes every queue and recovery second.  Returns False on an
        intake shed (accounted, never silently dropped)."""
        p = np.asarray(prompt, np.int32)
        span = self.cfg.affinity_span
        phash = None
        if span > 0 and len(p) > span:
            # hash exactly the first cacheable block span; prompts no
            # longer than it can't share a FULL cached block, so routing
            # them by affinity would buy nothing.  Computed BEFORE the
            # shed decision: whether this is a predicted hit decides how
            # much headroom it gets
            phash = zlib.crc32(p[:span].tobytes())
        # the destined role decides whose capacity this request consumes:
        # a long prompt heads for the prefill tier, so admitting or
        # shedding it is a PREFILL capacity decision — counting it
        # against decode capacity would let a heavy-prefill tail shed
        # decode-bound traffic it never competes with (and vice versa)
        role = "prefill" if (
            self.cfg.migrate_min_prompt_len is not None
            and len(p) >= self.cfg.migrate_min_prompt_len
        ) else "decode"
        with self._lock:
            inflight = sum(
                1 for r in self._inflight
                if self._inflight_role.get(r, "decode") == role
            )
            headroom = self.cfg.shed_hit_headroom
            hit = phash is not None and phash in self._affinity
            limit = self.cfg.shed_outstanding + (headroom if hit else 0)
            if inflight >= limit:
                self.metrics.counter("serve.shed").inc()
                self.metrics.counter(f"serve.shed_{role}").inc()
                if not hit and inflight < (
                    self.cfg.shed_outstanding + headroom
                ):
                    # a predicted hit at this load would have been
                    # admitted: this shed is the miss-first policy acting
                    self.metrics.counter("serve.shed_miss_first").inc()
                self.shed_rids.append(rid)
                record_event(
                    "serve_shed", rid=rid, where="frontdoor",
                    inflight=inflight, reason="FT_RPC_SHED",
                    predicted_hit=hit, role=role,
                )
                return False
            self._arrival.setdefault(rid, _now())
            self._inflight.add(rid)
            self._inflight_role[rid] = role
            if phash is not None:
                self._rid_phash[rid] = phash
        self._work.put((rid, p, int(max_new_tokens)))
        return True

    @property
    def idle(self) -> bool:
        with self._lock:
            return not self._inflight

    def wait_idle(self, timeout_s: float = 60.0) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.idle:
                return True
            time.sleep(0.01)
        return self.idle

    # ---- the dispatch machinery --------------------------------------------

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            item = self._work.get()
            if item is None:
                return
            rid, prompt, max_new = item
            try:
                self._execute(rid, prompt, max_new)
            finally:
                with self._lock:
                    self._inflight.discard(rid)
                    self._inflight_role.pop(rid, None)

    def _next_attempt(self, rid: int) -> int:
        with self._lock:
            n = self._attempt_seq.get(rid, 0)
            self._attempt_seq[rid] = n + 1
            return n

    def _attempts_used(self, rid: int) -> int:
        with self._lock:
            return self._attempt_seq.get(rid, 0)

    def _hedge_delay_s(self) -> float | None:
        """``hedge_factor`` x the windowed p99 of attempt latency, once
        enough samples exist; None disables hedging this round."""
        if self.cfg.max_hedges <= 0:
            return None
        hist = self.metrics.windowed_histogram("serve.attempt_ms")
        if hist.window_count() < self.cfg.hedge_min_samples:
            return None
        p99_s = hist.window_percentile(0.99) / 1e3
        return max(self.cfg.hedge_floor_s, self.cfg.hedge_factor * p99_s)

    def _launch_attempt(
        self, client: ReplicaClient, payload: dict, timeout_s: float,
        resq: queue.Queue,
    ) -> None:
        """Fire one RPC on its own thread; the outcome (ok / typed error)
        lands on ``resq``.  Outstanding accounting is per replica and
        released whatever happens — under the client's lock, because
        concurrent attempt threads' unlocked `+=`/`-=` lose updates and
        a client that looks forever-busy (or forever-idle) skews the
        least-outstanding routing for the rest of the run."""
        with client._lock:
            client.outstanding += 1

        def _run():
            send_mono = _now()
            try:
                conn = client.connection()
                reply = conn.call(payload, timeout_s=timeout_s)
            except RpcError as e:
                resq.put(("err", e, client, send_mono))
            else:
                resq.put(("ok", reply, client, send_mono))
            finally:
                with client._lock:
                    client.outstanding -= 1

        threading.Thread(
            target=_run, daemon=True, name="ft-frontdoor-attempt"
        ).start()

    def _execute(self, rid: int, prompt: np.ndarray, max_new: int) -> None:
        cfg = self.cfg
        arrival = self._arrival[rid]
        deadline = arrival + cfg.request_timeout_s
        backoff = cfg.backoff_base_s
        avoid: set = set()  # ranks that drain-refused this rid
        # the planner decision, folded to one compare: prompts past the
        # calibrated crossover ship their KV, shorter ones never pay the
        # hop.  Flips off for the rest of THIS rid on any handoff (the
        # sequence now lives on the decode side — collect, don't re-ship)
        # or migrate failure (fall back to the colocated path).
        migrate = (
            cfg.migrate_min_prompt_len is not None
            and len(prompt) >= cfg.migrate_min_prompt_len
        )
        prefer_pin = None  # decode rank a completed handoff pinned us to
        while True:
            now = _now()
            if now >= deadline:
                self._fail(rid, RpcTimeout.code)
                return
            if self._attempts_used(rid) >= cfg.max_attempts:
                self._fail(rid, "FT_RPC_RETRIES")
                return
            with self._lock:
                phash = self._rid_phash.get(rid)
                prefer = self._affinity.get(phash) if phash is not None \
                    else None
            if prefer_pin is not None:
                prefer = prefer_pin
            client = None
            extra = None
            if migrate:
                pre = self._routable(exclude=avoid, role="prefill")
                tgt = self._routable(prefer=prefer, role="decode")
                if pre is not None and tgt is not None:
                    with tgt._lock:
                        host, port = tgt.host, tgt.port
                    if host is not None:
                        client = pre
                        extra = {
                            "migrate_to": {
                                "host": host, "port": int(port),
                                "rank": tgt.rank,
                            },
                            "codec": cfg.migrate_codec,
                        }
                if client is None:
                    # no dedicated prefill tier (or no decode target)
                    # routable right now: the colocated path still
                    # works — don't strand the request on a preference
                    migrate = False
            if client is None:
                client = self._routable(exclude=avoid, prefer=prefer)
            if client is None and avoid:
                # everyone left has drain-refused us: better a draining
                # replica (it may still be up) than nobody
                avoid.clear()
                client = self._routable()
            if client is None:
                # nobody routable right now (all dead / breaker-open):
                # back off inside the budget and look again
                _sleep(min(backoff, max(0.0, deadline - _now())))
                backoff = min(backoff * 2.0, cfg.backoff_cap_s)
                continue
            verdict = self._attempt_round(
                rid, prompt, max_new, client, deadline, extra=extra
            )
            kind = verdict[0]
            if kind == "done":
                return
            if kind == "handoff":
                # the prefill replica already emitted the first token and
                # the decode replica holds the sequence: the remaining
                # work is a collect generate there, which attaches to the
                # in-flight sequence through the replica's dedup path
                migrate = False
                prefer_pin = verdict[1]
                avoid.discard(verdict[1])
                self.metrics.counter("serve.migrations").inc()
                continue
            if kind == "migrate_failed":
                # the prefill replica aborted the handoff (ship failed or
                # the decode side refused) and released its export: fall
                # back to a plain colocated generate for this rid
                migrate = False
                self.metrics.counter("serve.migration_fallback").inc()
                record_event("serve_migration_fallback", rid=rid,
                             code=verdict[1])
                continue
            if kind == "drain":
                # the replica is leaving, not failing: re-route at once,
                # and not back to the drainer
                avoid.add(verdict[1])
                self.metrics.counter("serve.drains").inc()
                record_event("serve_drain_reroute", rid=rid,
                             peer=verdict[1])
                continue
            # transport failure or replica shed: count a retry, back off
            self.metrics.counter("serve.retries").inc()
            record_event(
                "serve_retry", rid=rid, code=verdict[1],
                attempts=self._attempts_used(rid),
            )
            _sleep(min(backoff, max(0.0, deadline - _now())))
            backoff = min(backoff * 2.0, cfg.backoff_cap_s)

    def _attempt_round(
        self, rid, prompt, max_new, client: ReplicaClient, deadline: float,
        extra: dict | None = None,
    ):
        """One primary attempt plus up to ``max_hedges`` hedges; first
        usable outcome wins.  Returns ``("done",)``, ``("drain", rank)``,
        ``("retry", code)``, or — for a migrate-flagged attempt
        (``extra`` carries ``migrate_to`` + ``codec``) —
        ``("handoff", decode_rank)`` / ``("migrate_failed", code)``.
        Migrate attempts never hedge: a twin would ship a second KV copy
        for the dedup path to discard."""
        cfg = self.cfg
        resq: queue.Queue = queue.Queue()
        hedged = False
        outstanding = 0
        tried = []

        def _fire(target: ReplicaClient):
            nonlocal outstanding
            attempt = self._next_attempt(rid)
            remaining = deadline - _now()
            payload = {
                "kind": "generate",
                "rid": rid,
                "attempt": attempt,
                "prompt": [int(t) for t in prompt],
                "max_new_tokens": max_new,
                "deadline_in_s": round(remaining, 6),
            }
            if extra:
                payload.update(extra)
            timeout = min(cfg.attempt_timeout_s, max(remaining, 1e-3))
            self._launch_attempt(target, payload, timeout, resq)
            tried.append(target.rank)
            outstanding += 1

        _fire(client)
        hedge_delay = None if extra else self._hedge_delay_s()
        hedges = 0
        last_code = RpcTimeout.code
        while outstanding:
            remaining = deadline - _now()
            if remaining <= 0:
                return ("retry", RpcTimeout.code)
            wait = remaining
            if hedge_delay is not None and hedges < cfg.max_hedges:
                wait = min(wait, hedge_delay)
            try:
                kind, payload, rep, send_mono = resq.get(timeout=wait)
            except queue.Empty:
                if hedge_delay is not None and hedges < cfg.max_hedges:
                    twin = self._routable(exclude=tried)
                    if twin is not None and (
                        self._attempts_used(rid) < cfg.max_attempts
                    ):
                        hedges += 1
                        hedged = True
                        self.metrics.counter("serve.hedges").inc()
                        record_event(
                            "serve_hedge", rid=rid, primary=client.rank,
                            hedge=twin.rank,
                            delay_ms=round(hedge_delay * 1e3, 3),
                        )
                        _fire(twin)
                        continue
                    # nobody to hedge to: wait out the primary
                    hedge_delay = None
                continue
            outstanding -= 1
            if kind == "err":
                err: RpcError = payload
                last_code = err.code
                rep.strike(_now(), self.metrics)
                continue  # a hedge twin may still deliver
            self.metrics.histogram("serve.attempt_ms").observe(
                (_now() - send_mono) * 1e3
            )
            reply = payload
            if reply.get("prefill_depth") is not None:
                # piggybacked intake depth: the signal the prefill tier's
                # queue-depth-weighted routing balances on
                with rep._lock:
                    rep.prefill_depth = int(reply["prefill_depth"])
            if reply.get("drain"):
                return ("drain", rep.rank)
            if reply.get("handoff"):
                # migration done: first token is out, the sequence lives
                # on the decode replica.  Stamp the REAL ttft now — the
                # collect attempt's ttft_s would measure the attach, not
                # the prefill
                ttft_s = (send_mono - self._arrival[rid]) + float(
                    reply["ttft_s"]
                )
                with self._lock:
                    self._migration_ttft.setdefault(rid, ttft_s)
                rep.clear_strikes()
                record_event(
                    "serve_migration_handoff", rid=rid,
                    prefill=rep.rank, decode=int(reply["decode_rank"]),
                    ttft_ms=round(ttft_s * 1e3, 3),
                )
                return ("handoff", int(reply["decode_rank"]))
            if not reply.get("ok"):
                code = reply.get("code", "FT_RPC_ERROR")
                if reply.get("migrate_failed"):
                    return ("migrate_failed", code)
                last_code = code
                if code == RpcShed.code:
                    record_event("serve_shed_upstream", rid=rid,
                                 peer=rep.rank)
                continue
            rep.clear_strikes()
            self._deliver(rid, reply, rep, send_mono, hedged)
            return ("done",)
        return ("retry", last_code)

    # ---- elasticity (scale events from the lease driver) -------------------

    def reassign_affinity(self, old_rank: int, new_rank: int) -> int:
        """Point every prefix-affinity entry at ``old_rank`` to
        ``new_rank`` — the routing half of a prefix-warm drain handoff:
        the successor pre-warmed its index from the drainer's export, so
        the requests that used to hit the drainer should hit it.  Returns
        how many entries moved."""
        with self._lock:
            moved = [
                ph for ph, r in self._affinity.items() if r == old_rank
            ]
            for ph in moved:
                self._affinity[ph] = new_rank
        if moved:
            self.metrics.counter("serve.affinity_handoff").inc(len(moved))
            record_event(
                "serve_affinity_handoff", old=int(old_rank),
                new=int(new_rank), entries=len(moved),
            )
        return len(moved)

    def forget_replica(self, rank: int) -> None:
        """Drop a cleanly-departed replica: close its connection, remove
        its client, and clear any affinity entries still naming it (a
        stale preference is harmless — ``_routable`` falls back — but a
        clean exit should not leave one).  A crashed replica needs no
        call: membership marks it DEAD and routing skips it."""
        with self._lock:
            client = self.clients.pop(rank, None)
            stale = [
                ph for ph, r in self._affinity.items() if r == rank
            ]
            for ph in stale:
                del self._affinity[ph]
        if client is not None:
            client.close()
        record_event("serve_forget_replica", rank=int(rank),
                     stale_affinity=len(stale))

    # ---- results -----------------------------------------------------------

    def _deliver(
        self, rid: int, reply: dict, client: ReplicaClient,
        send_mono: float, hedged: bool,
    ) -> None:
        """First writer wins; a hedge race's loser is counted, dropped."""
        arrival = self._arrival[rid]
        ttft_s = (send_mono - arrival) + float(reply["ttft_s"])
        with self._lock:
            mig_ttft = self._migration_ttft.pop(rid, None)
        if mig_ttft is not None:
            # the first token came out of the prefill replica during the
            # handoff round; this reply's ttft_s timed the decode-side
            # attach, which is not what the client experienced
            ttft_s = mig_ttft
        result = FrontDoorResult(
            rid=rid,
            tokens=np.asarray(reply["tokens"], np.int32),
            ttft_s=ttft_s,
            rank=int(reply["rank"]),
            attempts=self._attempts_used(rid),
            hedged=hedged,
            migrated=mig_ttft is not None,
            intervals_s=tuple(
                float(d) for d in reply.get("intervals_s", ())
            ),
        )
        with self._lock:
            if rid in self.completed:
                self.metrics.counter("serve.duplicate_results").inc()
                record_event("serve_duplicate_result", rid=rid,
                             peer=client.rank)
                return
            self.completed[rid] = result
            phash = self._rid_phash.pop(rid, None)
            if phash is not None:
                # the winner's prefix index now holds this first block —
                # send the next request sharing it back there
                self._affinity[phash] = result.rank
        self.metrics.counter("serve.completed").inc()
        self.metrics.histogram("serve.ttft_ms").observe(ttft_s * 1e3)
        client.registry.histogram("serve.ttft_ms").observe(ttft_s * 1e3)
        record_event(
            "serve_result", rid=rid, peer=result.rank,
            attempts=result.attempts, hedged=hedged,
            ttft_ms=round(ttft_s * 1e3, 3), n_tokens=len(result.tokens),
        )

    def _fail(self, rid: int, code: str) -> None:
        with self._lock:
            if rid in self.completed:
                return
            self.failed[rid] = code
            self._rid_phash.pop(rid, None)
            self._migration_ttft.pop(rid, None)
        self.metrics.counter("serve.failed").inc()
        record_event("serve_failed", rid=rid, code=code)

    # ---- export ------------------------------------------------------------

    def snapshots(self) -> dict:
        """Label -> registry snapshot: the front door's aggregate plus
        one per replica (front-door-observed TTFT — queue and retries
        included, the SLO the client actually experiences)."""
        out = {"frontdoor": self.metrics.snapshot()}
        with self._lock:
            clients = sorted(self.clients.items())
        for rank, client in clients:
            out[f"fd_{rank:05d}"] = client.registry.snapshot()
        return out

    def prometheus(self) -> str:
        from ..obs import prometheus_exposition

        return prometheus_exposition(self.snapshots())

    def write_metrics(self, dir: str | None = None) -> list:
        """Drop ``metrics_frontdoor.json`` + ``metrics_fd_{rank}.json``
        into the control dir, next to the replica processes' own
        snapshots: the per-replica windowed TTFT histograms and the
        retry / hedge / shed / drain counters."""
        import json

        dir = dir or self.dir
        paths = []
        for label, snap in self.snapshots().items():
            path = os.path.join(dir, f"metrics_{label}.json")
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(snap, f, indent=2, sort_keys=True)
            os.replace(tmp, path)
            paths.append(path)
        return paths
