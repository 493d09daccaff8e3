"""Coordinated elastic control plane: epoch consensus for group decisions.

The port's copy of ``flextree_tpu/runtime/coordination.py``; its control
files are that module's format byte for byte (``runtime/ctrlfile.py``), so
a handle of either package reads the other's proposal, acks and commit.

Every elastic decision this stack makes — a drift-triggered replan
(``planner.feedback``), a shrink-to-survivors (``parallel.loop.fit``), an
arbiter lease resize (``runtime.leases``) — was decided and applied by
each rank independently.  That is sound on an in-process mesh, where
"each rank" is one process; on a real multi-process group it is a split
brain waiting to happen: two ranks observing slightly different residuals
replan to different topologies and the next collective deadlocks, or one
rank misses a death and keeps waiting on a world the others already
shrank away from.

This module turns every elastic event into a **two-phase group decision**
over the heartbeat/lease directory (the same atomic tmp+replace,
single-writer-per-file idiom ``runtime.leases`` uses, hardened by
``runtime.ctrlfile``'s CRC trailers):

1. **propose** — the *coordinator* (rank 0, or the failover successor:
   the lowest-rank healthy member) observes drift / death / SLO pressure
   and publishes ``coord_proposal.json`` carrying a strictly-increasing
   **control epoch**, the decision kind + payload, the participant set,
   an ack deadline bounded by the lease budget, and the step boundary the
   group will apply at;
2. **ack** — every participant that reads the proposal writes
   ``coord_ack_{rank}.json`` naming the epoch.  An ack is a promise: the
   rank will pause at the apply boundary until the decision resolves;
3. **commit** — only once every participant's ack is in does the
   coordinator publish ``coord_commit.json`` (same epoch, same payload —
   the commit IS the proposal, sealed), and all ranks apply at the
   agreed step boundary.  A participant that misses the ack deadline is
   excluded: the coordinator **re-proposes** the decision at the next
   epoch for the ranks that did ack, and the excluded rank — resumed
   from its SIGSTOP, say — finds the epoch moved past it and is
   **fenced** (:class:`EpochFenced`): it exits loudly rather than
   training on a stale plan.

Failure cases the protocol survives (executed by
``python -m flextree_tpu_torch.tools.coord_chaos``):

- **coordinator death at any phase**: the successor (lowest-rank healthy
  member) re-reads the directory and either *completes* the in-flight
  commit (every ack present → publish the commit at the SAME epoch:
  idempotent, because a commit for epoch E is uniquely the proposal for
  epoch E — two writers racing write byte-identical decisions) or
  *re-proposes* at the next epoch for the survivors.  No rank can
  double-apply: applied epochs strictly increase per rank, and an epoch
  commits at most one decision;
- **stalled/partitioned ranks**: SIGSTOP past the ack deadline → excluded
  and fenced on resume (above);
- **torn/duplicate control files**: every file carries a CRC trailer;
  a torn file parse-refuses and re-reads (``runtime.ctrlfile``), and a
  duplicate/replayed proposal or commit is rejected by epoch
  monotonicity.

The protocol is deliberately tick-driven and thread-free: ``fit`` calls
:meth:`CoordinationHandle.gate` once per loop iteration, the same way it
polls membership and the lease client.  All clocks are injectable for the
property suite (``tests/test_torch_coordination.py``), which drives randomized
interleavings of propose/ack/commit/failover against the invariants:
epochs strictly increase, at most one commit per epoch, no rank applies
uncommitted state.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Any, Callable

from ..utils.logging import get_logger
from .ctrlfile import read_control_json, write_control_json

__all__ = [
    "PROPOSAL_FILE",
    "COMMIT_FILE",
    "EpochFenced",
    "CoordinationAbandoned",
    "ProtocolViolation",
    "ControlDecision",
    "decision_fingerprint",
    "CoordLedger",
    "CoordinationConfig",
    "CoordinationHandle",
    "committed_shrink_plan",
]

log = get_logger("flextree.runtime")

PROPOSAL_FILE = "coord_proposal.json"
COMMIT_FILE = "coord_commit.json"
_ACK_FMT = "coord_ack_{rank:05d}.json"

# injection point for tests (patch this, not time.time): control files are
# read across processes, so stamps are wall time like heartbeat beats
_wall = time.time


class EpochFenced(RuntimeError):
    """This rank was excluded from a committed control epoch (it missed
    the ack window — stalled, partitioned, or resumed from a SIGSTOP
    after the group moved on).  Training on the stale plan would wedge or
    silently diverge the group's next collective: exit loudly instead."""


class CoordinationAbandoned(RuntimeError):
    """An acked proposal never resolved (no commit, no re-proposal, no
    successor) within the resolve budget — every healthy peer is gone.
    The rank refuses to guess and exits loudly."""


class ProtocolViolation(RuntimeError):
    """The control directory contradicts the protocol invariants (two
    different decisions at one epoch, an epoch moving backwards) — a bug
    or an adversarial writer, never smoothed over."""


@dataclasses.dataclass(frozen=True)
class ControlDecision:
    """One group decision: what to apply, who applies it, at which epoch
    and step boundary.

    ``kind``: ``"replan"`` (drift-triggered refit+replan, payload carries
    the refitted constants + topo spec), ``"shrink"`` (dead peers,
    payload carries the survivor set + replanned topo) or ``"resize"``
    (arbiter lease change, payload carries the lease epoch + chip set).
    ``participants`` is the rank set whose acks gate the commit and which
    the commit fences everyone else out of.  ``apply_step`` is the step
    boundary every participant applies at (``None``: apply at the next
    boundary after the commit is observed)."""

    epoch: int
    kind: str
    payload: dict
    participants: tuple
    coordinator: int
    apply_step: int | None = None
    wall: float = 0.0

    def to_payload(self) -> dict:
        return {
            "epoch": self.epoch,
            "kind": self.kind,
            "payload": self.payload,
            "participants": sorted(self.participants),
            "coordinator": self.coordinator,
            "apply_step": self.apply_step,
            "wall": self.wall,
            "fingerprint": self.fingerprint,
        }

    @classmethod
    def from_payload(cls, doc: dict) -> "ControlDecision":
        return cls(
            epoch=int(doc["epoch"]),
            kind=str(doc["kind"]),
            payload=dict(doc["payload"]),
            participants=tuple(int(r) for r in doc["participants"]),
            coordinator=int(doc["coordinator"]),
            apply_step=(
                int(doc["apply_step"]) if doc.get("apply_step") is not None
                else None
            ),
            wall=float(doc.get("wall", 0.0)),
        )

    @property
    def fingerprint(self) -> str:
        return decision_fingerprint(self.kind, self.payload)


# The closed set of decision kinds the control plane carries.  Shared
# with the extracted transition model (`runtime/coord_model.py`) so the
# protocol checker and the implementation cannot silently diverge on
# what a decision IS; `tests/test_torch_protocol_check.py` pins both
# sides to this tuple.
DECISION_KINDS = ("replan", "shrink", "resize")


def decision_fingerprint(kind: str, payload: dict) -> str:
    """Stable content hash of a decision — the quantity the chaos floors
    compare across survivors ("same plan fingerprint") and the idempotency
    token for commit-at-same-epoch writes."""
    blob = json.dumps({"kind": kind, "payload": payload}, sort_keys=True)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


class CoordLedger:
    """The control-file layer: one proposal slot, one commit slot, one
    ack file per rank — all CRC-trailered, all atomically replaced.

    Mechanics only; the state machine lives in
    :class:`CoordinationHandle`.  Epoch rules enforced here:

    - a proposal's epoch must exceed both the published proposal's and
      the published commit's (strictly-increasing control epochs);
    - a commit must match an epoch's proposal content exactly
      (fingerprint); publishing the SAME commit twice is a no-op (the
      failover successor completing an in-flight commit races the dying
      coordinator's own write — both write byte-identical decisions);
      publishing a DIFFERENT decision at a committed epoch is a
      :class:`ProtocolViolation`.
    """

    def __init__(self, dir: str):
        self.dir = dir
        os.makedirs(dir, exist_ok=True)
        # stat-guarded read cache for the two slot files: the gate runs
        # every training step and the slots are idle >99% of the time —
        # an unchanged (mtime_ns, size, inode) answers from memory, so
        # the idle path costs two stat calls, not two read+CRC passes
        # (tmp+replace always changes the inode, so the key can't alias)
        self._slot_cache: dict = {}

    def _cached_slot(self, path: str):
        try:
            st = os.stat(path)
        except OSError:
            self._slot_cache.pop(path, None)
            return None
        key = (st.st_mtime_ns, st.st_size, st.st_ino)
        hit = self._slot_cache.get(path)
        if hit is not None and hit[0] == key:
            return hit[1]
        doc = read_control_json(path)
        if doc is None:
            # torn/absent: never cache a refusal — the replace that heals
            # it must be seen immediately
            self._slot_cache.pop(path, None)
            return None
        self._slot_cache[path] = (key, doc)
        return doc

    @property
    def proposal_path(self) -> str:
        return os.path.join(self.dir, PROPOSAL_FILE)

    @property
    def commit_path(self) -> str:
        return os.path.join(self.dir, COMMIT_FILE)

    def _ack_path(self, rank: int) -> str:
        return os.path.join(self.dir, _ACK_FMT.format(rank=rank))

    # ---- proposal slot ----------------------------------------------------

    def publish_proposal(
        self, decision: ControlDecision, ack_deadline_wall: float
    ) -> None:
        cur = self.read_proposal()
        committed = self.read_commit()
        floor = max(
            cur[0].epoch if cur is not None else -1,
            committed.epoch if committed is not None else -1,
        )
        if decision.epoch <= floor:
            raise ProtocolViolation(
                f"control epoch must increase: proposed {decision.epoch} <= "
                f"published {floor}"
            )
        write_control_json(
            self.dir,
            self.proposal_path,
            {**decision.to_payload(), "ack_deadline_wall": ack_deadline_wall},
        )

    def read_proposal(self) -> tuple[ControlDecision, float] | None:
        doc = self._cached_slot(self.proposal_path)
        if doc is None:
            return None
        try:
            return (
                ControlDecision.from_payload(doc),
                float(doc.get("ack_deadline_wall", 0.0)),
            )
        except (ValueError, KeyError, TypeError):
            return None

    def next_epoch(self) -> int:
        cur = self.read_proposal()
        committed = self.read_commit()
        return 1 + max(
            cur[0].epoch if cur is not None else -1,
            committed.epoch if committed is not None else -1,
        )

    # ---- acks -------------------------------------------------------------

    def ack(self, rank: int, epoch: int, extra: dict | None = None) -> None:
        """Write ``rank``'s ack for ``epoch``.  ``extra`` rides along in
        the same file — the follower-drift channel: a rank's local
        drift-window summary (``planner.feedback.DriftDetector.summary``)
        ships under ``extra["drift"]`` so the coordinator's next propose
        decision sees pooled cross-rank skew, not just its own wire."""
        write_control_json(
            self.dir,
            self._ack_path(rank),
            {
                **(extra or {}),
                "rank": int(rank),
                "epoch": int(epoch),
                "wall": _wall(),
            },
        )

    def read_ack_docs(self) -> dict[int, dict]:
        """{rank: full ack payload} over every ack file in the dir."""
        out: dict[int, dict] = {}
        try:
            names = os.listdir(self.dir)
        except OSError:
            return out
        for name in names:
            if not (name.startswith("coord_ack_") and name.endswith(".json")):
                continue
            doc = read_control_json(os.path.join(self.dir, name))
            if doc is None:
                continue
            try:
                out[int(doc["rank"])] = doc
            except (ValueError, KeyError, TypeError):
                continue
        return out

    def read_acks(self) -> dict[int, int]:
        """{rank: newest acked epoch} over every ack file in the dir."""
        out: dict[int, int] = {}
        for rank, doc in self.read_ack_docs().items():
            try:
                out[rank] = int(doc["epoch"])
            except (ValueError, KeyError, TypeError):
                continue
        return out

    # ---- commit slot ------------------------------------------------------

    def publish_commit(self, decision: ControlDecision) -> bool:
        """Seal ``decision``.  True when this call wrote the commit; False
        when an identical commit already existed (the idempotent failover
        race).  A different decision at the same-or-newer epoch raises."""
        cur = self.read_commit()
        if cur is not None:
            if cur.epoch > decision.epoch:
                raise ProtocolViolation(
                    f"commit epoch moving backwards: {decision.epoch} after "
                    f"{cur.epoch}"
                )
            if cur.epoch == decision.epoch:
                if cur.fingerprint != decision.fingerprint:
                    raise ProtocolViolation(
                        f"two decisions at epoch {decision.epoch}: committed "
                        f"{cur.fingerprint}, proposed {decision.fingerprint}"
                    )
                return False  # already sealed: the idempotent no-op
        write_control_json(self.dir, self.commit_path, decision.to_payload())
        return True

    def read_commit(self) -> ControlDecision | None:
        doc = self._cached_slot(self.commit_path)
        if doc is None:
            return None
        try:
            return ControlDecision.from_payload(doc)
        except (ValueError, KeyError, TypeError):
            return None


@dataclasses.dataclass(frozen=True)
class CoordinationConfig:
    """Budgets, all lease-bounded so one protocol round can never outlive
    the membership machinery that supervises it.

    ``ack_timeout_s``: how long a proposal waits for acks before the
    coordinator excludes the missing ranks and re-proposes (default: one
    lease window — a rank that cannot ack within a lease would be
    classified dead anyway).  ``resolve_timeout_s``: how long a follower
    blocked at an apply boundary waits for the decision to resolve before
    raising :class:`CoordinationAbandoned` (default: 4 lease windows —
    enough for a coordinator death + successor takeover + re-propose).
    ``apply_margin_steps``: how far past the newest observed peer step the
    coordinator schedules the apply boundary.  ``poll_interval_s``: the
    sleep between polls while blocked at a boundary."""

    ack_timeout_s: float = 3.0
    resolve_timeout_s: float = 12.0
    apply_margin_steps: int = 2
    poll_interval_s: float = 0.05

    @classmethod
    def for_lease(cls, lease_s: float, **overrides) -> "CoordinationConfig":
        kw = dict(
            ack_timeout_s=lease_s,
            resolve_timeout_s=4.0 * lease_s,
        )
        kw.update(overrides)
        return cls(**kw)


class CoordinationHandle:
    """One rank's view of the control plane: follower duties always
    (ack proposals, surface commits, fence itself), coordinator duties
    whenever this rank is the lowest-rank healthy member.

    ``membership``: a :class:`~flextree_tpu_torch.runtime.MembershipView` (or
    any callable returning ``{rank: state_str}``) — the same source
    ``fit`` polls; ``None`` pins this rank as the sole coordinator (the
    single-process degenerate case, where the protocol reduces to a
    journal).  The handle never spawns threads: drive it with
    :meth:`gate` (one call per step) and, for event-driven proposals,
    :meth:`propose`.

    The flight record carries every transition: ``coord_propose``,
    ``coord_ack``, ``coord_commit``, ``coord_repropose``,
    ``coord_failover``, ``coord_fence``, ``coord_apply`` — rendered as
    the dedicated coordination lane of the merged timeline
    (``obs/timeline.py``).
    """

    def __init__(
        self,
        dir_or_ledger,
        rank: int,
        *,
        membership: Any = None,
        cfg: CoordinationConfig | None = None,
        on_fence: Callable | None = None,
        _sleep=time.sleep,
    ):
        self.ledger = (
            dir_or_ledger
            if isinstance(dir_or_ledger, CoordLedger)
            else CoordLedger(dir_or_ledger)
        )
        self.rank = int(rank)
        self.membership = membership
        self.cfg = cfg or CoordinationConfig()
        self.on_fence = on_fence
        self._sleep = _sleep
        # follower-drift channel: when set (FeedbackController wires its
        # detector's summary here), every ack this rank writes carries the
        # current drift-window summary under "drift" — the coordinator
        # reads the pooled view via peer_drift() before proposing
        self.drift_provider: Callable[[], dict] | None = None
        self._applied_epoch = -1
        self._acked_epoch = -1
        # follower-side boundary promise: (epoch, apply_step) of the
        # newest proposal this rank acked that has not resolved yet
        # (+ the wall stamp of the ack, for the no-boundary abandon check)
        self._pending: tuple[int, int | None] | None = None
        self._pending_wall = 0.0
        # commit observed but held back until its apply boundary
        self._held: ControlDecision | None = None
        self._was_coordinator: bool | None = None
        self.applied: list[int] = []  # epochs applied, in order (audit)

    # ---- membership --------------------------------------------------------

    def _statuses(self) -> dict[int, str] | None:
        m = self.membership
        if m is None:
            return None
        if hasattr(m, "poll"):
            return {r: s.state for r, s in m.poll().items()}
        return dict(m())

    def _alive_ranks(self) -> tuple[int, ...]:
        """Non-dead ranks (self always counts: our own beat may be stale
        to our own reader thread, but we are demonstrably running)."""
        statuses = self._statuses()
        if statuses is None:
            return (self.rank,)
        alive = {r for r, st in statuses.items() if st != "dead"}
        alive.add(self.rank)
        return tuple(sorted(alive))

    def _healthy_ranks(self) -> tuple[int, ...]:
        statuses = self._statuses()
        if statuses is None:
            return (self.rank,)
        healthy = {r for r, st in statuses.items() if st == "healthy"}
        healthy.add(self.rank)
        return tuple(sorted(healthy))

    @property
    def is_coordinator(self) -> bool:
        """Coordinator = the lowest-rank healthy member.  Rank 0 while it
        lives; the failover successor after."""
        return self.rank == min(self._healthy_ranks())

    def suggest_apply_step(self) -> int | None:
        """A step boundary comfortably ahead of every peer: the newest
        step any beat reports plus ``apply_margin_steps`` — far enough
        that the commit lands before anyone reaches it, so the whole
        group flips plans at ONE boundary.  ``None`` when the membership
        source carries no step info (apply at first observation)."""
        m = self.membership
        if m is None or not hasattr(m, "poll"):
            return None
        steps = [
            s.step for s in m.poll().values()
            if getattr(s, "step", None) is not None and s.step >= 0
        ]
        if not steps:
            return None
        return max(steps) + max(1, self.cfg.apply_margin_steps)

    # ---- proposing (coordinator side) --------------------------------------

    def propose(
        self, kind: str, payload: dict, *, apply_step: int | None = None
    ) -> int | None:
        """Publish a proposal (coordinator only; followers get ``None`` —
        their observation is not authority).  Returns the control epoch.
        A proposal already in flight wins: one decision at a time, the
        new observation re-fires on a later tick once the slot clears."""
        if not self.is_coordinator:
            return None
        inflight = self.ledger.read_proposal()
        committed = self.ledger.read_commit()
        committed_epoch = committed.epoch if committed is not None else -1
        if inflight is not None and inflight[0].epoch > committed_epoch:
            return None  # a decision is mid-handshake: never interleave two
        if committed_epoch > self._applied_epoch:
            # a sealed decision this rank has not applied yet: apply what
            # is committed before deciding anew (a proposal here would
            # race its own gate and duplicate the in-flight decision)
            return None
        epoch = self.ledger.next_epoch()
        decision = ControlDecision(
            epoch=epoch,
            kind=kind,
            payload=payload,
            participants=self._alive_ranks(),
            coordinator=self.rank,
            apply_step=apply_step,
            wall=_wall(),
        )
        deadline = _wall() + self.cfg.ack_timeout_s
        try:
            self.ledger.publish_proposal(decision, deadline)
        except ProtocolViolation:
            # lost a propose race (divergent membership views made two
            # ranks coordinator for a beat, or a publish landed between
            # our epoch read and our write): back off — the caller
            # retries on a later tick against the slot's winner.  A
            # crash here would turn a benign split-second overlap into
            # a dead healthy rank.
            return None
        self._record(
            "coord_propose", epoch=epoch, decision=kind,
            participants=sorted(decision.participants),
            apply_step=apply_step, fingerprint=decision.fingerprint,
        )
        log.warning(
            "coord: rank %d proposed epoch %d (%s) to %s, apply_step=%s",
            self.rank, epoch, kind, sorted(decision.participants), apply_step,
        )
        # the proposer's own ack, immediately — it is a participant too
        self._ack(decision)
        return epoch

    # ---- the per-step gate -------------------------------------------------

    def gate(self, step: int) -> ControlDecision | None:
        """One protocol tick.  Returns a committed decision this rank must
        apply NOW (at this step boundary), else ``None``.  Blocks —
        bounded by ``resolve_timeout_s`` — when this rank promised (acked)
        a boundary at-or-before ``step`` and the decision has not resolved:
        proceeding would run the boundary step on the old plan while acked
        peers run the new one."""
        decision = self._poll(step)
        if decision is not None:
            return decision
        pending = self._pending
        if pending is None:
            return None
        p_epoch, p_apply = pending
        if p_apply is None:
            # no named boundary: the promise doesn't bind any step, so
            # keep stepping — but an acked decision that NOBODY resolves
            # (no commit, no re-proposal, no driver) within the resolve
            # budget still means the control plane is dead, and the
            # failure model promises a loud typed exit, not an
            # indefinitely wedged handshake
            if _wall() - self._pending_wall > self.cfg.resolve_timeout_s:
                raise CoordinationAbandoned(
                    f"rank {self.rank} acked control epoch {p_epoch} "
                    f"(no apply boundary) and nothing resolved it within "
                    f"{self.cfg.resolve_timeout_s:.1f}s — no healthy peer "
                    "left to drive the decision"
                )
            return None
        if step < p_apply:
            # not at the boundary yet: keep stepping, keep polling
            return None
        deadline = _wall() + self.cfg.resolve_timeout_s
        while _wall() < deadline:
            decision = self._poll(step)
            if decision is not None:
                return decision
            if self._pending is None or self._pending[0] != p_epoch:
                # resolved without an apply for us: superseded (we acked a
                # newer proposal — loop back to honor ITS boundary) or the
                # commit excluded us (fenced inside _poll)
                return self.gate(step)
            self._sleep(self.cfg.poll_interval_s)
        raise CoordinationAbandoned(
            f"rank {self.rank} acked control epoch {p_epoch} but no commit, "
            f"re-proposal or successor appeared within "
            f"{self.cfg.resolve_timeout_s:.1f}s — no healthy peer left to "
            "resolve the decision"
        )

    def mark_applied(self, decision: ControlDecision) -> None:
        """The caller applied ``decision`` — advance the fence.  Applied
        epochs strictly increase per rank, so a replayed commit can never
        double-apply (the chaos floors count ``coord_apply`` events per
        (rank, epoch))."""
        if decision.epoch <= self._applied_epoch:
            raise ProtocolViolation(
                f"rank {self.rank} double-apply: epoch {decision.epoch} "
                f"after {self._applied_epoch}"
            )
        self._applied_epoch = decision.epoch
        self.applied.append(decision.epoch)
        if self._pending is not None and self._pending[0] <= decision.epoch:
            self._pending = None
        self._record(
            "coord_apply", epoch=decision.epoch, decision=decision.kind,
            fingerprint=decision.fingerprint,
        )

    @property
    def applied_epoch(self) -> int:
        return self._applied_epoch

    @property
    def phase(self) -> str:
        """Where the in-flight handshake stands from this rank's view —
        the field every guaranteed failure dump attaches so a postmortem
        can say WHICH phase the fault interrupted: ``"commit"`` (sealed
        but unapplied here), ``"ack_wait"`` (we acked, unresolved),
        ``"propose"`` (proposal observed, not acked), ``"idle"``."""
        if self._held is not None:
            return "commit"
        committed = self.ledger.read_commit()
        ce = committed.epoch if committed is not None else -1
        if ce > self._applied_epoch:
            return "commit"
        prop = self.ledger.read_proposal()
        if prop is not None and prop[0].epoch > ce:
            if max(self._acked_epoch, self._applied_epoch) >= prop[0].epoch:
                return "ack_wait"
            return "propose"
        return "idle"

    # ---- internals ---------------------------------------------------------

    def _record(self, kind: str, **fields) -> None:
        from ..obs import record_event

        record_event(kind, coord_rank=self.rank, **fields)

    def peer_drift(self, min_epoch: int | None = None) -> dict[int, dict]:
        """{rank: drift-window summary} from every OTHER rank's newest
        ack — the pooled cross-rank skew view the feedback controller's
        propose decision consumes.  Summaries are only as fresh as each
        rank's last ack (a group with no prior decision has none yet —
        the first proposal is decided from the coordinator's own view).

        ``min_epoch`` drops summaries attached to acks for OLDER epochs:
        an ack is written when a rank *observes* a proposal — before the
        apply resets its detector — so after a replan commits at epoch E,
        every surviving ack's drift describes the PRE-refit world.
        Pooling those would immediately re-trigger the drift that was
        just corrected; the controller passes ``applied_epoch + 1`` so
        only summaries written since the last applied decision count."""
        out: dict[int, dict] = {}
        for rank, doc in self.ledger.read_ack_docs().items():
            if rank == self.rank:
                continue
            if min_epoch is not None:
                try:
                    if int(doc.get("epoch", -1)) < min_epoch:
                        continue
                except (TypeError, ValueError):
                    continue
            drift = doc.get("drift")
            if isinstance(drift, dict) and drift:
                out[rank] = drift
        return out

    def _ack(self, decision: ControlDecision) -> None:
        extra = None
        if self.drift_provider is not None:
            try:
                summary = self.drift_provider()
            except Exception:  # noqa: BLE001 — telemetry never blocks an ack
                summary = None
            if summary:
                extra = {"drift": summary}
        self.ledger.ack(self.rank, decision.epoch, extra=extra)
        self._acked_epoch = decision.epoch
        self._pending = (decision.epoch, decision.apply_step)
        self._pending_wall = _wall()
        self._record(
            "coord_ack", epoch=decision.epoch, decision=decision.kind,
            apply_step=decision.apply_step,
        )

    def _fence(self, committed: ControlDecision) -> None:
        self._record(
            "coord_fence", epoch=committed.epoch, decision=committed.kind,
            participants=sorted(committed.participants),
        )
        log.error(
            "coord: rank %d FENCED — epoch %d (%s) committed to %s without "
            "us (we missed the ack window); exiting rather than training on "
            "a stale plan",
            self.rank, committed.epoch, committed.kind,
            sorted(committed.participants),
        )
        from ..obs import dump_current

        dump_current(
            "coord_fence", epoch=committed.epoch, kind=committed.kind,
            coord_phase="commit",
        )
        if self.on_fence is not None:
            self.on_fence(committed)
        raise EpochFenced(
            f"rank {self.rank} excluded from committed control epoch "
            f"{committed.epoch} ({committed.kind}); participants "
            f"{sorted(committed.participants)}"
        )

    def _poll(self, step: int) -> ControlDecision | None:
        """One non-blocking protocol scan: follower duties, then
        coordinator duties."""
        # -- commits first: the commit is the authority
        held = self._held
        if held is None:
            committed = self.ledger.read_commit()
            if committed is not None and committed.epoch > self._applied_epoch:
                if self.rank not in committed.participants:
                    self._fence(committed)  # raises
                self._held = held = committed
        if held is not None:
            if held.apply_step is None or step >= held.apply_step:
                self._held = None
                return held
        # -- proposals: ack anything newer than what we acked
        prop = self.ledger.read_proposal()
        if prop is not None:
            decision, deadline = prop
            if (
                decision.epoch > max(self._acked_epoch, self._applied_epoch)
                and self.rank in decision.participants
            ):
                self._ack(decision)
        # -- coordinator duties (incl. failover takeover)
        self._drive(prop)
        return None

    def _drive(self, prop) -> None:
        """Advance an in-flight proposal: commit it when every ack is in,
        exclude-and-re-propose past the deadline, take over from a dead
        coordinator."""
        if prop is None:
            # nothing in flight: skip the membership poll entirely (the
            # idle-path cost of gate() stays two control-file reads).
            # None = "leadership unknown"; the takeover edge below treats
            # it as not-previously-coordinator, which is exactly right —
            # inheriting a dead proposer's decision IS a failover.
            self._was_coordinator = None
            return
        decision, deadline = prop
        committed = self.ledger.read_commit()
        if committed is not None and committed.epoch >= decision.epoch:
            return  # nothing in flight
        # one membership scan per drive tick: statuses feed both the
        # who-is-coordinator question and the missing-rank classification
        statuses = self._statuses()
        if statuses is None:
            healthy = {self.rank}
            statuses = {}
        else:
            healthy = {
                r for r, st in statuses.items() if st == "healthy"
            } | {self.rank}
        if self.rank != min(healthy):
            self._was_coordinator = False
            return
        # the CURRENT coordinator drives ANY in-flight proposal — its
        # owner is either us, dead, or demoted (a healthy owner ranked
        # below us would make us not-coordinator; a recovered straggler
        # ranked above us stopped driving the moment we became lowest
        # healthy).  Deferring to a live-but-demoted owner deadlocks the
        # slot: it won't drive (not coordinator) and neither would we.
        if decision.coordinator != self.rank and not self._was_coordinator:
            # takeover edge — announce once, then drive like any other
            self._record(
                "coord_failover", epoch=decision.epoch,
                dead_coordinator=decision.coordinator, decision=decision.kind,
                owner_state=statuses.get(decision.coordinator),
            )
            log.warning(
                "coord: rank %d taking over epoch %d from coordinator "
                "rank %d (%s)", self.rank, decision.epoch,
                decision.coordinator,
                statuses.get(decision.coordinator, "unknown"),
            )
        self._was_coordinator = True
        acks = self.ledger.read_acks()
        missing = [
            r for r in decision.participants
            if acks.get(r, -1) < decision.epoch
        ]
        if not missing:
            try:
                wrote = self.ledger.publish_commit(decision)
            except ProtocolViolation as e:
                # two drivers raced the non-CAS epoch floor (a
                # straggler-classified old coordinator still driving
                # beside us) and the slot sealed a DIFFERENT decision
                # first.  The sealed commit is the authority: back off,
                # re-read it next tick (deliver or fence) — crashing a
                # healthy rank over a lost race would turn a benign
                # split-second overlap into an outage.
                self._record(
                    "coord_commit_race", epoch=decision.epoch,
                    reason=str(e)[:200],
                )
                log.warning(
                    "coord: rank %d lost a commit race at epoch %d: %s",
                    self.rank, decision.epoch, e,
                )
                return
            if wrote:
                self._record(
                    "coord_commit", epoch=decision.epoch, decision=decision.kind,
                    participants=sorted(decision.participants),
                    fingerprint=decision.fingerprint,
                )
                log.warning(
                    "coord: rank %d committed epoch %d (%s)",
                    self.rank, decision.epoch, decision.kind,
                )
            return
        now = _wall()
        if now < deadline and not all(
            statuses.get(r) == "dead" for r in missing
        ):
            return  # inside the window and somebody may still ack: wait
        # deadline passed (or every missing rank is confirmed dead):
        # exclude the silent ranks and re-propose for the ones that acked
        survivors = tuple(
            sorted(
                r for r in decision.participants
                if acks.get(r, -1) >= decision.epoch or r == self.rank
            )
        )
        epoch = self.ledger.next_epoch()
        redo = ControlDecision(
            epoch=epoch,
            kind=decision.kind,
            payload=decision.payload,
            participants=survivors,
            coordinator=self.rank,
            apply_step=decision.apply_step,
            wall=now,
        )
        try:
            self.ledger.publish_proposal(redo, now + self.cfg.ack_timeout_s)
        except ProtocolViolation:
            # lost a re-propose race (a demoted-but-running old
            # coordinator published first): the next tick re-reads the
            # winner from the slot and acks it like any follower
            return
        self._record(
            "coord_repropose", epoch=epoch, prev_epoch=decision.epoch,
            decision=decision.kind, excluded=sorted(missing),
            participants=sorted(survivors),
        )
        log.warning(
            "coord: rank %d re-proposed epoch %d (was %d): ranks %s missed "
            "the ack window and are excluded",
            self.rank, epoch, decision.epoch, sorted(missing),
        )
        self._ack(redo)


def apply_spec_override(plan, spec, n: int):
    """Override ``plan``'s topology with the broadcast FT_TOPO spec when
    they disagree — ONE definition shared by the shrink, replan and
    resize commit paths, so a rank whose local calibration skews must
    still run the group's plan (and a future spec-grammar change cannot
    make two apply sites read the same commit differently).  Ring specs
    normalize (``"ring"`` ≡ ``"1"``)."""
    if not spec:
        return plan
    spec = str(spec).strip()
    spec = "1" if spec == "ring" else spec
    if plan.to_ft_topo() == spec:
        return plan
    from ..schedule.stages import Topology

    log.warning(
        "coord: local replan picked %s but the committed plan is %s — "
        "following the group", plan.to_ft_topo(), spec,
    )
    return dataclasses.replace(plan, topology=Topology.resolve(n, spec))


def committed_shrink_plan(payload: dict, nbytes: int):
    """Reconstruct the group-wide survivor plan from a committed shrink
    payload: every rank replans locally for the broadcast survivor count,
    then the broadcast topo spec OVERRIDES the local winner."""
    from ..planner.choose import replan_for_survivors

    n_alive = int(payload["alive"])
    configured = payload.get("configured")
    plan = replan_for_survivors(
        n_alive, nbytes, configured=int(configured) if configured else None
    )
    return apply_spec_override(plan, payload.get("topo"), n_alive)
