"""Elastic replica pool: serving replicas under runtime supervision.

The port's copy of ``flextree_tpu/serving/pool.py``, built on the port's
:class:`~flextree_tpu_torch.runtime.Supervisor`,
:class:`~flextree_tpu_torch.runtime.MembershipView` and
:class:`~flextree_tpu_torch.runtime.StepWatchdog` over
:class:`~flextree_tpu_torch.serving.engine.ServingEngine` replicas, with
the same events, counters and report keys:

- every replica runs a :class:`~flextree_tpu_torch.runtime.Supervisor`
  heartbeat (rank = replica index, step = scheduling rounds, EWMA = round
  duration) into a shared directory; a
  :class:`~flextree_tpu_torch.runtime.MembershipView` classifies replicas
  healthy / straggler / dead from lease age;
- each replica's scheduling round runs under a
  :class:`~flextree_tpu_torch.runtime.StepWatchdog` deadline, so a hung
  decode becomes a typed ``StepTimeout`` instead of stalling the whole
  pool;
- a **dead replica drains**: every request it had in flight (queued or
  resident) goes back to the pool queue and is re-routed to a survivor —
  the pool *degrades* (fewer replicas, longer queues) instead of failing.
  Generated-but-undelivered tokens die with the replica; the re-routed
  request recomputes from its prompt on the survivor (at-least-once
  execution, exactly-once results — the pool records a completion only
  once per request id, and greedy decoding recomputes the same tokens).

Death is declared conservatively but drains decisively: a watchdog
timeout marks the replica *suspect*, and a suspect engine is never
stepped again (the abandoned watchdog worker may still be executing
inside it — re-entering would race two threads through one engine).  The
drain fires when the lease expires or after ``max_suspect_strikes``
grace rounds, whichever comes first; a transient stall therefore costs
the replica (capacity lost, requests recomputed) but never corrupts it.

On the card each replica's rounds run on its watchdog's worker thread,
one thread an engine; PyTorch's current stream is per thread and each
worker uses the device's default stream, and a round reads its logits
back (the round's one sync) before it returns.  The worker's first round
pays its thread's cuBLAS set-up: warm each engine on its replica's
worker (``watchdog.run(engine.warmup, timeout_s=...)``) before holding
rounds to a tight ``step_timeout_s``.

Replicas here are in-process objects; :mod:`.replica_main` runs one
engine per OS process behind the :mod:`.rpc` frame protocol, and
:mod:`.frontdoor` re-implements this pool's route/drain/exactly-once
rules over TCP.  This in-process pool is the reference semantics that
tier is held to.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque

from . import engine as _engine_mod

from ..obs import MetricsRegistry, dump_current, record_event
from ..runtime import (
    DEAD,
    MembershipView,
    StepTimeout,
    StepWatchdog,
    Supervisor,
    SupervisorConfig,
)
from ..utils.logging import get_logger
from .batcher import Request
from .engine import ServingEngine

__all__ = ["ReplicaFailed", "PoolConfig", "ReplicaPool"]

log = get_logger("flextree.serving")


class ReplicaFailed(RuntimeError):
    """A replica's engine raised mid-round — the crash signature (vs the
    hang signature, which is ``StepTimeout``)."""

    code = "FT_REPLICA_FAILED"


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    """``heartbeat_dir`` is the shared beat directory; lease/straggler
    budgets mirror :class:`~flextree_tpu.runtime.SupervisorConfig`.
    ``step_timeout_s=None`` disables the watchdog (steps run inline).
    ``parallel_rounds`` steps the live replicas on concurrent threads
    instead of sequentially: each engine is still entered by exactly one
    thread per round (the single-thread-per-engine contract holds), but
    rounds overlap where the framework releases the GIL (eager PyTorch
    holds it for most of a round's launches, so one card gains little).
    Routing, harvest, and the reap stay on the caller's thread either
    way."""

    heartbeat_dir: str
    step_timeout_s: float | None = None
    interval_s: float = 0.05
    straggler_s: float = 1.0
    lease_s: float = 3.0
    max_suspect_strikes: int = 3
    parallel_rounds: bool = False


class _Replica:
    def __init__(self, rank: int, engine: ServingEngine, cfg: PoolConfig):
        self.rank = rank
        self.engine = engine
        self.supervisor = Supervisor(
            SupervisorConfig(
                rank=rank,
                dir=cfg.heartbeat_dir,
                interval_s=cfg.interval_s,
                straggler_s=cfg.straggler_s,
                lease_s=cfg.lease_s,
            )
        ).start()
        self.watchdog = StepWatchdog()
        self.alive = True
        self.released = False  # arbiter-controlled graceful removal
        self.strikes = 0
        self.rounds = 0
        self.assigned: dict = {}  # rid -> Request (the re-route copy)
        self.fail_mode: str | None = None  # test/chaos hook

    def step_once(self, timeout_s: float | None) -> None:
        self.watchdog.run(self._round, timeout_s=timeout_s, step=self.rounds)

    def _round(self):
        if self.fail_mode == "hang":
            # the in-process stand-in for a wedged decode: block until the
            # watchdog abandons this worker thread (which never enters the
            # engine: the sleep comes first)
            time.sleep(3600.0)
        if self.fail_mode == "raise":
            raise ReplicaFailed(
                f"{ReplicaFailed.code}: replica {self.rank} killed"
            )
        t0 = time.monotonic()
        self.engine.step()
        self.rounds += 1
        self.supervisor.record_step(self.rounds, time.monotonic() - t0)

    def shutdown(self) -> None:
        self.supervisor.stop()
        self.watchdog.close()


class ReplicaPool:
    """Route requests over supervised replicas; degrade on death.

    ``engines`` are pre-built replicas (their pool/slot configs may
    differ); the pool owns routing, supervision, drain, and the
    once-per-rid completion record.  Membership is elastic:
    :meth:`add_replica` joins a warmed engine mid-flight (burst spin-up)
    and :meth:`release_replica` gracefully drains one back out.
    """

    def __init__(self, engines, cfg: PoolConfig):
        if not engines:
            raise ValueError("a replica pool needs at least one engine")
        self.cfg = cfg
        self.replicas = [
            _Replica(r, eng, cfg) for r, eng in enumerate(engines)
        ]
        self.membership = MembershipView(
            cfg.heartbeat_dir,
            straggler_s=cfg.straggler_s,
            lease_s=cfg.lease_s,
            configured=len(self.replicas),
        )
        self.queue: deque = deque()
        self.completed: dict = {}
        self.rejected: list = []  # (rid, reason) refused by a replica
        self.kills: list = []
        # pool-level accounting lives in a registry; report() is a view
        # over its snapshot, and the legacy attributes below are
        # properties reading the same counters (one bookkeeping path)
        self.metrics = MetricsRegistry()

    @property
    def submitted(self) -> int:
        return int(self.metrics.counter("pool.submitted").value)

    @property
    def reroutes(self) -> int:
        return int(self.metrics.counter("pool.reroutes").value)

    # ---- intake ------------------------------------------------------------

    def submit(self, request: Request) -> None:
        # stamp arrival at POOL intake (same injectable clock the engines
        # use): a re-routed request keeps its original arrival, so TTFT
        # includes the time it sat on the dead replica
        if request.arrival_s == 0.0:
            request = dataclasses.replace(
                request, arrival_s=_engine_mod._now()
            )
        self.queue.append(request)
        self.metrics.counter("pool.submitted").inc()
        self.metrics.gauge("pool.queue_depth").set(len(self.queue))

    @property
    def alive_replicas(self) -> list:
        return [r for r in self.replicas if r.alive]

    @property
    def degraded(self) -> bool:
        # a RELEASED replica is capacity the arbiter took back on purpose,
        # not a degradation — only deaths count
        return any(not r.alive and not r.released for r in self.replicas)

    @property
    def idle(self) -> bool:
        return not self.queue and all(
            r.engine.idle for r in self.alive_replicas
        )

    def warmup(self, *args, timeout_s: float = 600.0, **kwargs) -> None:
        """Run each live replica's ``engine.warmup(*args, **kwargs)`` on
        that replica's watchdog worker — the thread its rounds run on —
        under a generous deadline, so the worker's first-call set-up
        (its cuBLAS handle, the kernels' first launches) lands outside
        the rounds held to ``step_timeout_s``.  With the watchdog off the
        rounds run on the caller's thread, and so does this.  (A port
        addition: the JAX pool's replicas compile once, per process.)"""
        step_timeout = self.cfg.step_timeout_s
        for r in self.alive_replicas:
            r.watchdog.run(
                r.engine.warmup, *args,
                timeout_s=None if step_timeout is None else timeout_s,
                **kwargs,
            )

    # ---- elastic membership (arbiter control) ------------------------------

    def add_replica(self, engine: ServingEngine) -> int:
        """Join a (warmed) engine to the pool as a new replica — the
        arbiter's burst spin-up.  The replica starts heartbeating
        immediately and is routable from the next ``step()``; warm the
        engine BEFORE adding it, or the first routed requests eat its
        first-call set-up."""
        rank = len(self.replicas)
        self.replicas.append(_Replica(rank, engine, self.cfg))
        self.metrics.counter("pool.replica_adds").inc()
        self.metrics.gauge("pool.alive").set(len(self.alive_replicas))
        record_event("replica_add", replica=rank)
        log.info("replica %d joined the pool (%d alive)",
                 rank, len(self.alive_replicas))
        return rank

    def release_replica(self, rank: int) -> list:
        """Gracefully remove a replica — the arbiter's drain-on-return.

        Unlike :meth:`_drain` (the DEATH path) this is planned: the same
        harvest + exactly-once re-route of in-flight requests, but no
        forensic dump and no degradation mark — released capacity is the
        arbiter taking chips back, not a failure.  The engine is never
        stepped again.  Returns the re-routed request ids."""
        r = self.replicas[rank]
        if not r.alive:
            return []
        lost = self._remove(r, released=True)
        self.metrics.counter("pool.releases").inc()
        record_event(
            "replica_release", replica=rank,
            rerouted=[q.rid for q in lost],
            survivors=len(self.alive_replicas),
        )
        log.info(
            "replica %d released: %d in-flight requests re-routed to %d "
            "survivors", rank, len(lost), len(self.alive_replicas),
        )
        return [q.rid for q in lost]

    def _remove(self, r: _Replica, *, released: bool) -> list:
        """The shared removal body for BOTH exits (death drain / planned
        release): stop the heartbeat, harvest completions that raced in
        (dict reads are GIL-atomic; the engine itself is never
        re-entered), and re-queue the rest for exactly-once re-routing
        (greedy recompute gives the same tokens).  Returns the lost requests."""
        r.alive = False
        r.released = released
        r.supervisor.stop()
        self._harvest(r)
        lost = [
            req for rid, req in r.assigned.items()
            if rid not in self.completed
        ]
        for req in lost:
            self.queue.append(req)
        self.metrics.counter("pool.reroutes").inc(len(lost))
        self.metrics.gauge("pool.alive").set(len(self.alive_replicas))
        return lost

    # ---- chaos hook --------------------------------------------------------

    def kill(self, rank: int, mode: str = "hang") -> None:
        """Simulate replica death: its heartbeat stops (a real process
        death's signature) and its rounds hang, raise, or — ``mode=
        "silent"`` — keep stepping until the lease verdict (the zombie
        whose heartbeat died first)."""
        if mode not in ("hang", "raise", "silent"):
            raise ValueError(f"unknown kill mode {mode!r}")
        r = self.replicas[rank]
        r.supervisor.stop()
        if mode != "silent":
            r.fail_mode = mode
        self.kills.append({"rank": rank, "mode": mode})
        record_event("kill", replica=rank, mode=mode)

    # ---- the pool round ----------------------------------------------------

    def _route(self) -> None:
        """Hand queued requests to the least-loaded alive replica —
        fewest outstanding requests, free cache blocks as the tiebreak
        (free blocks ALONE lag reality: a routed request reserves nothing
        until its replica's next admission pass); keep a copy for drain."""
        while self.queue:
            live = [r for r in self.alive_replicas if r.strikes == 0]
            if not live:
                return
            req = self.queue.popleft()
            if req.rid in self.completed:
                continue  # re-routed twin already finished elsewhere
            best = min(
                live,
                key=lambda r: (
                    len(r.assigned),
                    -r.engine.batcher.allocator.num_free,
                ),
            )
            if not best.engine.submit(req):
                # refused (oversized for that replica's pool, bad sampling
                # config): record at POOL level — a silently vanished
                # request is the one outcome a serving layer may never have
                reason = (
                    best.engine.batcher.rejected[-1][1]
                    if best.engine.batcher.rejected else "rejected"
                )
                self.rejected.append((req.rid, reason))
                self.metrics.counter("pool.rejected").inc()
                log.warning("request %d rejected by replica %d: %s",
                            req.rid, best.rank, reason)
                continue
            best.assigned[req.rid] = req
        self.metrics.gauge("pool.queue_depth").set(len(self.queue))

    def step(self) -> None:
        """One pool round: route, step every live replica under its
        watchdog (sequentially, or concurrently with
        ``parallel_rounds``), harvest completions, reap the dead."""
        self._route()
        stepping = []
        for r in self.alive_replicas:
            if r.strikes > 0:
                # suspect: the abandoned watchdog worker may still be
                # inside engine.step — never re-enter the engine; each
                # skipped round is a strike toward the grace limit
                r.strikes += 1
                continue
            stepping.append(r)
        if self.cfg.parallel_rounds and len(stepping) > 1:
            outcomes = {}

            def _run(rep):
                try:
                    rep.step_once(self.cfg.step_timeout_s)
                except Exception as e:  # settled on the caller's thread
                    outcomes[rep.rank] = e

            threads = [
                threading.Thread(
                    target=_run, args=(r,), name=f"ft-pool-round-{r.rank}"
                )
                for r in stepping
            ]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            # an exception the suspect machinery doesn't model must
            # PROPAGATE exactly as it would from the sequential loop —
            # swallowing it would harvest a broken replica as healthy
            unexpected = [
                e for e in outcomes.values()
                if not isinstance(e, (StepTimeout, ReplicaFailed))
            ]
            if unexpected:
                raise unexpected[0]
            for r in stepping:
                self._settle(r, outcomes.get(r.rank))
        else:
            for r in stepping:
                try:
                    r.step_once(self.cfg.step_timeout_s)
                except (StepTimeout, ReplicaFailed) as e:
                    self._settle(r, e)
                else:
                    self._settle(r, None)
        self._reap()

    def _settle(self, r: _Replica, exc) -> None:
        """Classify one replica's round outcome (caller's thread — the
        completed/strike bookkeeping is never touched concurrently)."""
        if exc is None:
            self._harvest(r)
        elif isinstance(exc, StepTimeout):
            r.strikes = 1
            record_event("replica_suspect", replica=r.rank, why="timeout")
            log.warning("replica %d round timed out; suspect", r.rank)
        else:
            r.strikes = self.cfg.max_suspect_strikes
            record_event("replica_suspect", replica=r.rank, why="raise")
            log.warning("replica %d raised; awaiting verdict", r.rank)

    def _harvest(self, r: _Replica) -> None:
        for rid, done in list(r.engine.completed.items()):
            if rid not in self.completed:
                self.completed[rid] = done
            r.engine.completed.pop(rid)
            r.assigned.pop(rid, None)

    def _reap(self) -> None:
        """Drain the dead: lease expiry is authoritative for EVERY
        replica (a silently-dead heartbeat means the process is gone even
        if the in-process stand-in still steps); strike-out only for
        suspects."""
        status = self.membership.poll()
        for r in self.replicas:
            if not r.alive:
                continue
            peer = status.get(r.rank)
            lease_dead = peer is not None and peer.state == DEAD
            struck_out = r.strikes >= self.cfg.max_suspect_strikes
            if lease_dead or struck_out:
                self._drain(r, "lease" if lease_dead else "strikes")

    def _drain(self, r: _Replica, why: str) -> None:
        lost = self._remove(r, released=False)
        self.metrics.counter("pool.drains").inc()
        record_event(
            "drain", replica=r.rank, why=why, rerouted=[q.rid for q in lost],
            survivors=len(self.alive_replicas),
        )
        # engine strike-out / lease death is a failure path: guarantee the
        # forensic dump (ring context incl. the suspect/kill events)
        dump_current(f"replica_{why}", replica=r.rank, rerouted=len(lost))
        log.warning(
            "replica %d dead (%s): re-routing %d in-flight requests to "
            "%d survivors",
            r.rank, why, len(lost), len(self.alive_replicas),
        )

    def run_until_idle(self, max_rounds: int = 100_000) -> dict:
        for _ in range(max_rounds):
            if self.idle:
                break
            if not self.alive_replicas and self.queue:
                raise RuntimeError(
                    "no replicas left alive with requests still queued"
                )
            self.step()
        else:
            raise RuntimeError(f"pool not idle after {max_rounds} rounds")
        return self.report()

    def report(self) -> dict:
        """The pool's accounting — a view over its metrics registry (the
        legacy keys read the same counters) plus each replica engine's
        own registry snapshot."""
        self.metrics.gauge("pool.alive").set(len(self.alive_replicas))
        return {
            "replicas": len(self.replicas),
            "alive": len(self.alive_replicas),
            "released": sum(1 for r in self.replicas if r.released),
            "degraded": self.degraded,
            "submitted": self.submitted,
            "completed": len(self.completed),
            "rejected": list(self.rejected),
            "reroutes": self.reroutes,
            "kills": list(self.kills),
            "metrics": self.metrics.snapshot(),
            "replica_metrics": {
                r.rank: r.engine.report() for r in self.replicas
            },
        }

    def shutdown(self) -> None:
        for r in self.replicas:
            r.shutdown()

    def __enter__(self) -> "ReplicaPool":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
