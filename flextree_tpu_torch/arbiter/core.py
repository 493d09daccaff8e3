"""The pool arbiter: lease chips to training, preempt them to serving.

The port's copy of ``flextree_tpu/arbiter/core.py``: the same decisions
under the same readings and clock, the same flight-record events.

One host, one chip inventory, two tenants with opposite economics:
training wants every chip all the time and tolerates interruptions
(checkpoint → shrink → resume is SIGKILL-proven); serving wants chips
*exactly when traffic bursts* and its failure mode — TTFT blowing
through the SLO — is visible in the metrics registry within one rolling
window.  The :class:`PoolArbiter` closes that loop:

- **default**: training holds the leasable chips; serving runs its
  baseline replicas.
- **breach**: when the pool's windowed TTFT p99 (the
  :class:`~flextree_tpu_torch.obs.metrics.WindowedHistogram` view — cumulative
  percentiles dilute a fresh breach after a quiet hour) exceeds
  ``slo_p99_ms`` for ``breach_ticks`` consecutive evaluations, the
  arbiter revokes ``burst_chips`` chips from training through the lease
  ledger (``runtime.leases``).  Training checkpoints NOW and shrinks —
  the arbiter-triggered twin of the SIGTERM-preemption path — then acks;
  only then are the chips granted to serving and the warmed burst
  replicas activated (``on_serve_grant``).
- **drain**: when the windowed p99 stays under ``release_frac *
  slo_p99_ms`` (the hysteresis low-water) for ``clear_ticks``
  evaluations AND ``cooldown_s`` has passed since the last action, the
  burst replicas drain (``on_serve_return`` — in-flight requests
  re-route exactly-once to survivors) and the chips return to training,
  which re-expands through the same re-shard machinery.

The hysteresis band (breach high-water vs ``release_frac`` low-water,
each with its own consecutive-tick debounce) plus the cooldown means a
single latency spike cannot thrash chips back and forth: moving a chip
costs a training checkpoint/restore cycle and a replica drain, so the
arbiter demands *sustained* evidence in both directions.

Every decision lands in the flight record — ``slo_breach`` on the breach
edge, ``lease_preempt`` / ``lease_grant`` / ``lease_return`` on the
moves, each carrying the SLO reading that drove it — and renders as the
arbiter lane of the merged Chrome trace (``obs/timeline.py``), beside
the train/serve spans it caused.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import math
import os
import time
from collections import deque

from ..obs import record_event
from ..obs.metrics import load_window, merged_window_percentile
from ..runtime.ctrlfile import read_control_json, write_control_json
from ..runtime.leases import ARBITER, SERVE, TRAIN, LeaseLedger
from ..utils.logging import get_logger
from .inventory import DeviceInventory

__all__ = [
    "ArbiterConfig",
    "SloReading",
    "PoolArbiter",
    "STATE_FILE",
    "file_slo_reader",
    "pool_slo_reader",
]

log = get_logger("flextree.arbiter")

#: the arbiter's own durable state beside the ledger: which chips are on
#: loan and which handoff is mid-flight — what a restarted arbiter needs
#: beyond the ledger (the ledger says WHERE chips are, not where a parked
#: set was HEADED)
STATE_FILE = "arbiter_state.json"

# injection point for tests (patch this, not time.time): cooldowns and
# ledger stamps are wall time, the heartbeat-dir convention
_wall = time.time


@dataclasses.dataclass(frozen=True)
class SloReading:
    """One evaluation of the serving pool's SLO state: the windowed TTFT
    percentile, how many samples the window holds (few samples = no
    evidence, not a breach), and the pool's cumulative admission-blocked
    count (the secondary pressure signal: requests waiting on cache
    blocks never got a TTFT stamp yet, so a saturated pool can breach on
    admit-pressure before the percentile moves)."""

    p99_ms: float
    samples: int
    admit_blocked: float = 0.0

    def to_payload(self) -> dict:
        return {
            "p99_ms": None if math.isnan(self.p99_ms) else round(self.p99_ms, 3),
            "samples": self.samples,
            "admit_blocked": self.admit_blocked,
        }


@dataclasses.dataclass(frozen=True)
class ArbiterConfig:
    """``slo_p99_ms``: the TTFT p99 target.  ``window_s`` is the lease
    window — the rolling-percentile horizon the breach check reads and
    the budget the spike tool holds recovery to.  The horizon
    physically lives in the serving engines' ``WindowedHistogram``\\ s
    (``ServingEngine(slo_window_s=...)``, same 10 s default); pass
    ``window_s`` to :func:`pool_slo_reader` to ENFORCE the match instead
    of trusting it.  ``release_frac`` sets
    the hysteresis low-water (return chips only once p99 is *well*
    inside the SLO, not hovering at it).  ``breach_ticks`` /
    ``clear_ticks`` debounce each edge in consecutive :meth:`~PoolArbiter.tick`
    evaluations; ``cooldown_s`` is the minimum wall time between chip
    moves.  ``min_train_chips`` floors training's world (a 0-chip
    trainer has no devices to checkpoint from); ``burst_chips`` is the
    handoff granularity.  ``min_samples``: windows thinner than this are
    "no evidence" — never a breach.  ``admit_blocked_delta`` (optional):
    additionally breach when the pool's admit-blocked count grew by at
    least this much since the previous tick.

    ``min_serve_prefill_chips`` / ``min_serve_decode_chips`` floor the
    DISAGGREGATED serving fleet per role: a scale-down never reclaims a
    chip whose departure would strand one role at (or below) its floor —
    a fleet with prefill replicas but zero decode replicas serves
    nothing, and the SLO reader cannot see that until the next breach.
    They only bind when the arbiter is built with ``serve_role_of`` (the
    chip → role map); 0 restores role-blind reclaim."""

    slo_p99_ms: float
    window_s: float = 10.0  # = ServingEngine's slo_window_s default
    release_frac: float = 0.5
    breach_ticks: int = 2
    clear_ticks: int = 3
    cooldown_s: float = 4.0
    min_train_chips: int = 1
    burst_chips: int = 2
    min_samples: int = 5
    admit_blocked_delta: float | None = None
    min_serve_prefill_chips: int = 0
    min_serve_decode_chips: int = 0

    def __post_init__(self):
        if self.slo_p99_ms <= 0:
            raise ValueError(f"slo_p99_ms must be > 0, got {self.slo_p99_ms}")
        if not 0.0 < self.release_frac < 1.0:
            raise ValueError(
                f"release_frac must sit strictly inside (0, 1) — it IS the "
                f"hysteresis band — got {self.release_frac}"
            )
        if self.min_train_chips < 1:
            raise ValueError("min_train_chips must be >= 1")
        if self.burst_chips < 1:
            raise ValueError("burst_chips must be >= 1")
        if self.min_serve_prefill_chips < 0:
            raise ValueError("min_serve_prefill_chips must be >= 0")
        if self.min_serve_decode_chips < 0:
            raise ValueError("min_serve_decode_chips must be >= 0")


def pool_slo_reader(pool, q: float = 99.0, *, window_s: float | None = None):
    """An :class:`SloReading` source over a serving
    :class:`~flextree_tpu_torch.serving.pool.ReplicaPool`: merge the alive
    replicas' windowed ``serve.ttft_ms`` histograms (the SLO is a
    property of the POOL, not any one replica) and sum their
    ``serve.admit_blocked`` counters.  Pass ``window_s`` (=
    ``ArbiterConfig.window_s``) to enforce that every replica's TTFT
    window actually spans the horizon the breach check claims to read —
    a mismatched engine is a loud error, not a silently-wrong lease
    window."""

    def read() -> SloReading:
        hists = []
        blocked = 0.0
        for r in pool.replicas:
            if not r.alive:
                continue
            m = r.engine.metrics
            if "serve.ttft_ms" in m:
                h = m.windowed_histogram("serve.ttft_ms")
                if window_s is not None and abs(h.window_s - window_s) > 1e-9:
                    raise ValueError(
                        f"replica {r.rank}'s TTFT window spans "
                        f"{h.window_s:g}s but the arbiter evaluates a "
                        f"{window_s:g}s lease window — build the engine "
                        f"with slo_window_s={window_s:g}"
                    )
                hists.append(h)
            if "serve.admit_blocked" in m:
                blocked += m.counter("serve.admit_blocked").value
        p99, n = merged_window_percentile(hists, q)
        return SloReading(p99_ms=p99, samples=n, admit_blocked=blocked)

    return read


def file_slo_reader(
    dir: str,
    q: float = 99.0,
    *,
    metric: str = "serve.ttft_ms",
    window_s: float | None = None,
    prefix: str = "metrics_fd_",
):
    """An :class:`SloReading` source over METRICS FILES — the
    cross-process twin of :func:`pool_slo_reader`, for an arbiter whose
    serving tenant is a fleet of real replica processes it cannot reach
    into.

    Reads every ``{prefix}*.json`` snapshot in ``dir`` (the front door's
    :meth:`~flextree_tpu_torch.serving.frontdoor.FrontDoor.write_metrics`
    per-replica files by default), reconstructs each one's windowed
    ``metric`` series (:func:`~flextree_tpu_torch.obs.metrics.load_window` —
    the rolling window survives the file round-trip now; a pre-series
    payload or torn file contributes NO evidence, never a frozen p99),
    and merges them into one pool-level reading, aged against the wall
    clock so a replica that stopped writing decays to empty instead of
    asserting its last breach forever.  ``window_s`` enforcement matches
    :func:`pool_slo_reader`: a snapshot whose window spans a different
    horizon than the breach check claims to read is a loud error."""

    def read() -> SloReading:
        wins = []
        for path in sorted(glob.glob(os.path.join(dir, prefix + "*.json"))):
            try:
                with open(path, encoding="utf-8") as f:
                    snap = json.load(f)
            except (OSError, ValueError):
                continue  # mid-replace / vanished: no evidence this tick
            payload = (snap.get("histograms") or {}).get(metric)
            if payload is None:
                continue
            fw = load_window(payload)
            if fw is None:
                continue  # summary-only payload: absent ≠ clean, skip
            if window_s is not None and abs(fw.window_s - window_s) > 1e-9:
                raise ValueError(
                    f"{os.path.basename(path)}'s {metric} window spans "
                    f"{fw.window_s:g}s but the arbiter evaluates a "
                    f"{window_s:g}s lease window — build the writer with "
                    f"slo_window_s={window_s:g}"
                )
            wins.append(fw)
        p99, n = merged_window_percentile(wins, q, now=time.time())
        return SloReading(p99_ms=p99, samples=n)

    return read


class PoolArbiter:
    """One elastic device pool over a :class:`DeviceInventory` and a
    :class:`~flextree_tpu_torch.runtime.LeaseLedger`.

    The arbiter is a pure decision engine driven by :meth:`tick` (the
    host loop's cadence — the spike tool calls it between pool rounds;
    a daemon-thread wrapper is trivial but the explicit tick keeps tests
    deterministic).  It never touches engines or meshes itself:
    ``on_serve_grant(chips)`` / ``on_serve_return(chips)`` are the
    serving-side hooks (activate warmed replicas / drain them), and
    training reacts through its own :class:`~flextree_tpu_torch.runtime.TrainLeaseClient`
    poll — the arbiter only ever writes the ledger.

    The revoke → ack → grant handoff is two-phase across ticks: chips
    taken from training park on the ``"arbiter"`` holder until training's
    ack lands in the ledger, and only then move to serving.  A chip is
    therefore never promised to two tenants, no matter how slow the
    trainer's checkpoint/rebuild is — the handoff stretches, it never
    races.
    """

    def __init__(
        self,
        inventory: DeviceInventory,
        ledger: LeaseLedger,
        cfg: ArbiterConfig,
        *,
        slo_reader,
        on_serve_grant=None,
        on_serve_return=None,
        serve_is_tenant: bool = False,
        serve_role_of=None,
    ):
        self.inventory = inventory
        self.ledger = ledger
        self.cfg = cfg
        self.slo_reader = slo_reader
        self.on_serve_grant = on_serve_grant
        self.on_serve_return = on_serve_return
        # chip -> serving role ("prefill" / "decode" / "both"): the map
        # the per-role tenancy floors consult on scale-down.  None means
        # a colocated fleet — the floors never bind.
        self.serve_role_of = serve_role_of
        # serving as a LEDGER TENANT: scale-down is a revoke → drain →
        # ack → grant-back handshake through the ledger (the serving
        # fleet's ServeLeaseClient drains real replica processes and acks
        # only after), not a synchronous on_serve_return call — chips
        # leave serving only once serving provably stopped using them,
        # exactly the guarantee training already had.
        self.serve_is_tenant = bool(serve_is_tenant)
        self._pending: dict | None = None  # parked, awaiting src's ack
        self._loaned: list = []  # chips currently on loan to serving
        self._breach_streak = 0
        self._clear_streak = 0
        self._last_action_wall = -math.inf
        self._last_reading: SloReading | None = None  # admit-blocked delta
        # bounded audit tail (the flight recorder carries the durable
        # record; this is the in-memory window drivers/tests read)
        self.decisions: deque = deque(maxlen=4096)
        # the starting assignment goes on the record before any tenant
        # polls (TrainLeaseClient adopts it as its baseline).  A restart
        # against a heartbeat dir that already carries a ledger SUPERSEDES
        # it — the new arbiter's inventory is the fresh truth, and epochs
        # keep increasing so no tenant can mistake the old grant for news.
        prior = self.ledger.read()
        self._epoch = 0 if prior is None else prior.epoch + 1
        self._resume_state(prior)
        self.ledger.publish(self._epoch, inventory.grants(), reason="initial")
        self._save_state()
        record_event(
            "lease_grant",
            holder=TRAIN,
            chips=list(inventory.held_by(TRAIN)),
            epoch=self._epoch,
            reason="initial",
        )

    # ---- durable state (the restart-mid-handoff story) ---------------------

    @property
    def _state_path(self) -> str:
        return os.path.join(self.ledger.dir, STATE_FILE)

    def _save_state(self) -> None:
        write_control_json(
            self.ledger.dir, self._state_path,
            {
                "loaned": list(self._loaned),
                "pending": None if self._pending is None else {
                    "chips": list(self._pending["chips"]),
                    "epoch": self._pending["epoch"],
                    "src": self._pending["src"],
                    "dst": self._pending["dst"],
                },
            },
        )

    def _resume_state(self, prior) -> None:
        """Adopt a predecessor's loan/pending bookkeeping, validated
        against the inventory the caller rebuilt from the ledger — a
        restart mid-handoff must finish the handoff (the parked chips'
        destination is state the ledger alone cannot carry), not strand
        chips on the arbiter holder forever."""
        if prior is None:
            return
        doc = read_control_json(self._state_path)
        if doc is None:
            return  # no predecessor state (or torn): start conservative
        parked = set(self.inventory.held_by(ARBITER))
        serve = set(self.inventory.held_by(SERVE))
        loaned = [c for c in doc.get("loaned") or () if c in serve]
        self._loaned = loaned
        p = doc.get("pending")
        if (
            isinstance(p, dict)
            and p.get("src") in (TRAIN, SERVE)
            and p.get("dst") in (TRAIN, SERVE)
            and p.get("chips")
            and set(p["chips"]) <= parked
        ):
            # the revoke epoch predates our restart; our "initial"
            # publish below re-announces the same shrunken grant at a
            # NEWER epoch, and the source tenant's ack of either epoch
            # proves it applied the revocation — gate on the older one
            self._pending = {
                "chips": tuple(p["chips"]),
                "epoch": int(p["epoch"]),
                "src": p["src"],
                "dst": p["dst"],
            }
            log.warning(
                "arbiter restart: resuming handoff of chips %s "
                "(%s -> %s, revoke epoch %d)",
                list(self._pending["chips"]), self._pending["src"],
                self._pending["dst"], self._pending["epoch"],
            )

    # ---- bookkeeping -------------------------------------------------------

    @property
    def loaned(self) -> tuple:
        """Chips currently preempted from training to serving."""
        return tuple(self._loaned)

    @property
    def pending_handoff(self) -> tuple:
        """Chips revoked from training but not yet granted to serving
        (awaiting training's ack) — empty when no handoff is in flight."""
        return tuple(self._pending["chips"]) if self._pending else ()

    def _publish(self, reason: str) -> int:
        self._epoch += 1
        self.ledger.publish(self._epoch, self.inventory.grants(), reason=reason)
        return self._epoch

    # ---- the decision loop -------------------------------------------------

    def tick(self) -> dict:
        """One SLO evaluation + at most one protocol action.  Returns the
        decision record (also appended to ``self.decisions``)."""
        now = _wall()
        reading = self.slo_reader()
        cfg = self.cfg
        grew = None
        if cfg.admit_blocked_delta is not None and self._last_reading is not None:
            grew = reading.admit_blocked - self._last_reading.admit_blocked
        self._last_reading = reading
        has_evidence = reading.samples >= cfg.min_samples
        over = has_evidence and reading.p99_ms > cfg.slo_p99_ms
        pressured = (
            grew is not None and grew >= cfg.admit_blocked_delta
        )
        breached = over or pressured
        # "clear" needs the window to be POSITIVELY quiet: either no
        # traffic at all, or a well-inside-SLO percentile.  A thin window
        # (few samples) is neither breach nor clear.
        cleared = reading.samples == 0 or (
            has_evidence
            and not math.isnan(reading.p99_ms)
            and reading.p99_ms <= cfg.release_frac * cfg.slo_p99_ms
        )
        if breached:
            if self._breach_streak == 0:
                record_event(
                    "slo_breach",
                    slo_p99_ms=cfg.slo_p99_ms,
                    window_s=cfg.window_s,
                    over=over,
                    admit_pressure=pressured,
                    **reading.to_payload(),
                )
            self._breach_streak += 1
            self._clear_streak = 0
        elif cleared:
            self._clear_streak += 1
            self._breach_streak = 0
        else:  # inside the hysteresis band: hold the current allocation
            self._breach_streak = 0
            self._clear_streak = 0

        cooled = now - self._last_action_wall >= cfg.cooldown_s
        action = None
        if self._pending is not None:
            action = self._maybe_complete_handoff(reading)
        elif (
            breached
            and self._breach_streak >= cfg.breach_ticks
            and cooled
        ):
            action = self._preempt(reading, now)
        elif (
            self._loaned
            and self._clear_streak >= cfg.clear_ticks
            and cooled
        ):
            action = self._return(reading, now)

        decision = {
            "wall": now,
            "reading": reading.to_payload(),
            "breached": breached,
            "cleared": cleared,
            "breach_streak": self._breach_streak,
            "clear_streak": self._clear_streak,
            "action": action,
            "epoch": self._epoch,
            "train_chips": list(self.inventory.held_by(TRAIN)),
            "serve_chips": list(self.inventory.held_by(SERVE)),
            "loaned": list(self._loaned),
            "pending": None if self._pending is None
            else list(self._pending["chips"]),
        }
        self.decisions.append(decision)
        return decision

    # ---- actions -----------------------------------------------------------

    def _preempt(self, reading: SloReading, now: float):
        """Phase 1 of the scale-up handoff: revoke chips from training
        (park on the arbiter holder) and wait for training's ack."""
        chips = self.inventory.take(
            TRAIN, self.cfg.burst_chips, keep=self.cfg.min_train_chips
        )
        if not chips:
            return None  # training already at its floor: nothing to move
        epoch = self._publish(
            f"slo breach: p99 {reading.p99_ms:.1f}ms > "
            f"{self.cfg.slo_p99_ms:.1f}ms"
        )
        self._pending = {
            "chips": chips, "epoch": epoch, "src": TRAIN, "dst": SERVE,
        }
        self._last_action_wall = now
        self._save_state()
        record_event(
            "lease_preempt",
            chips=list(chips),
            holder_from=TRAIN,
            epoch=epoch,
            **reading.to_payload(),
        )
        log.warning(
            "arbiter: SLO breach (p99 %.1fms > %.1fms, %d samples) — "
            "revoking chips %s from training (epoch %d)",
            reading.p99_ms, self.cfg.slo_p99_ms, reading.samples,
            list(chips), epoch,
        )
        return "preempt"

    def _maybe_complete_handoff(self, reading: SloReading):
        """Phase 2 of either handoff direction: once the SOURCE tenant
        acked the revocation epoch (training: checkpointed + shrunk;
        serving: replicas drained — its client refuses to ack sooner),
        hand the parked chips to the destination."""
        pending = self._pending
        # ONE ack read serves both fields — two reads could pair the
        # epoch from one ack version with the control stamp of another
        ack = self.ledger.read_ack(pending["src"]) or {}
        try:
            acked = int(ack["epoch"])
        except (KeyError, ValueError, TypeError):
            acked = -1
        if acked < pending["epoch"]:
            return None  # source still checkpointing/draining: wait
        # a coordinated (multi-process) tenant stamps the control epoch it
        # group-applied the revocation under (runtime.coordination's
        # fencing: the ack provably post-dates the apply); single-process
        # tenants leave it None — record whichever the ack carries
        control_epoch = ack.get("control_epoch")
        dst = pending["dst"]
        chips = self.inventory.move(pending["chips"], ARBITER, dst)
        epoch = self._publish(f"granting {list(chips)} to {dst}")
        if dst == SERVE:
            self._loaned.extend(chips)
        else:
            self._loaned = [c for c in self._loaned if c not in chips]
        self._pending = None
        # the grant IS a chip move: the cooldown restarts here, so a
        # burst that ends while the trainer was still checkpointing
        # cannot bounce the chips straight back on the next tick
        self._last_action_wall = _wall()
        self._save_state()
        record_event(
            "lease_grant" if dst == SERVE else "lease_return",
            chips=list(chips),
            holder=dst,
            epoch=epoch,
            control_epoch=control_epoch,
            **reading.to_payload(),
        )
        if dst == SERVE and self.on_serve_grant is not None:
            self.on_serve_grant(chips)
        if dst == TRAIN and self.on_serve_return is not None:
            # tenant mode: the fleet already drained before serving's ack
            # — this hook is notification, not the drain itself
            self.on_serve_return(chips)
        log.warning(
            "arbiter: chips %s granted to %s (epoch %d)",
            list(chips), dst, epoch,
        )
        return "grant" if dst == SERVE else "return"

    def _reclaimable(self) -> tuple:
        """Split the loaned chips into (take, withheld) under the
        per-role tenancy floors: a chip stays with serving when
        reclaiming it would drop its role's serve-chip count below
        ``min_serve_{prefill,decode}_chips``.  Chips mapping to
        ``"both"`` (or any role without a floor) reclaim freely; with no
        ``serve_role_of`` map or all-zero floors the split is the old
        role-blind take-everything."""
        chips = tuple(self._loaned)
        floors = {
            "prefill": self.cfg.min_serve_prefill_chips,
            "decode": self.cfg.min_serve_decode_chips,
        }
        if self.serve_role_of is None or not any(floors.values()):
            return chips, ()
        counts: dict = {}
        for c in self.inventory.held_by(SERVE):
            role = self.serve_role_of(c)
            counts[role] = counts.get(role, 0) + 1
        take, withheld = [], []
        for c in chips:
            role = self.serve_role_of(c)
            if counts.get(role, 0) - 1 < floors.get(role, 0):
                withheld.append(c)
                continue
            counts[role] = counts.get(role, 0) - 1
            take.append(c)
        return tuple(take), tuple(withheld)

    def _return(self, reading: SloReading, now: float):
        """Scale-down.  Tenant mode: phase 1 of the reverse handoff —
        revoke the loaned chips from serving (park them), publish, and
        wait for serving's ack (its lease client SIGTERM-drains the
        replica processes and refuses to ack while requests are in
        flight).  Legacy in-process mode: drain synchronously via
        ``on_serve_return`` and move the chips in one tick.  Either way
        the per-role tenancy floors filter the reclaim first: a chip
        whose departure would strand prefill or decode below its floor
        stays loaned (loudly — ``lease_withheld``), so a burst that
        scaled up one role can never drain the other to zero."""
        chips, withheld = self._reclaimable()
        if withheld:
            record_event(
                "lease_withheld",
                chips=list(withheld),
                reason="role_floor",
                **reading.to_payload(),
            )
            log.warning(
                "arbiter: scale-down withholds chips %s — reclaiming "
                "them would strand a serving role below its tenancy "
                "floor", list(withheld),
            )
        if not chips:
            return None  # everything loaned is floor-pinned: hold
        p99_txt = (
            "-" if math.isnan(reading.p99_ms) else round(reading.p99_ms, 1)
        )
        if self.serve_is_tenant:
            self.inventory.move(chips, SERVE, ARBITER)
            epoch = self._publish(
                f"burst drained: reclaiming {list(chips)} from serving "
                f"(p99 {p99_txt}ms inside "
                f"{self.cfg.release_frac:.0%} of SLO)"
            )
            self._pending = {
                "chips": chips, "epoch": epoch, "src": SERVE, "dst": TRAIN,
            }
            self._last_action_wall = now
            self._save_state()
            record_event(
                "lease_preempt",
                chips=list(chips),
                holder_from=SERVE,
                epoch=epoch,
                **reading.to_payload(),
            )
            log.warning(
                "arbiter: burst drained — revoking chips %s from serving "
                "(epoch %d), awaiting drain ack", list(chips), epoch,
            )
            return "preempt"
        if self.on_serve_return is not None:
            self.on_serve_return(chips)
        self.inventory.move(chips, SERVE, TRAIN)
        self._loaned = [c for c in self._loaned if c not in chips]
        epoch = self._publish(
            f"burst drained: p99 {p99_txt}"
            f"ms inside {self.cfg.release_frac:.0%} of SLO"
        )
        self._last_action_wall = now
        self._save_state()
        record_event(
            "lease_return",
            chips=list(chips),
            holder=TRAIN,
            epoch=epoch,
            **reading.to_payload(),
        )
        log.warning(
            "arbiter: burst drained — chips %s returned to training "
            "(epoch %d)", list(chips), epoch,
        )
        return "return"
