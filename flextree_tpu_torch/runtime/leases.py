"""Chip-lease protocol: arbiter-published grants on the heartbeat dir.

The port's copy of ``flextree_tpu/runtime/leases.py``, the same file
format: a ledger or an ack written by either package reads in the other.

The heartbeat directory already carries the runtime's only cross-process
truths — per-rank liveness beats, atomically replaced, wall-stamped.
Leases ride the same transport: the **arbiter** (``flextree_tpu_torch.arbiter``)
is the single writer of one ``lease_ledger.json`` naming, per holder
(``"train"`` / ``"serve"``), exactly which chips that holder may use at
which **epoch**; every holder polls the ledger and, when the epoch moved,
applies the new grant and writes an ``lease_ack_{holder}.json`` naming
the epoch it now runs under.  The handshake is the whole protocol:

1. the arbiter revokes chips from a holder by publishing epoch ``E`` with
   a smaller grant (the revoked chips are parked on the ``"arbiter"``
   holder — granted to nobody while in flight);
2. the holder sees ``E``, stops using the revoked chips (training:
   checkpoint-now + shrink-to-survivors rebuild — the SIGTERM-preemption
   path, arbiter-triggered), and **acks** ``E``;
3. only after the ack does the arbiter publish ``E+1`` granting those
   chips to the other holder — a chip is never promised to two holders,
   because the grant that takes it away is acknowledged before the grant
   that hands it on exists.

Every write is atomic (tmp + ``os.replace``, the beat-file discipline),
so a reader never sees a torn ledger; a mid-rewrite crash leaves the
previous epoch, which is always a consistent assignment.  The files are
human-readable JSON — ``cat $FT_HB_DIR/lease_ledger.json`` IS the
debugging story.

:class:`TrainLeaseClient` is training's side: the handle
``parallel.loop.fit(arbiter=...)`` polls every loop iteration (throttled
to ``poll_interval_s`` — a file read per step would be rude) and turns an
epoch move into a :class:`ResizeDirective` the loop applies through the
same checkpoint → rebuild → restore machinery the shrink path proved.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable

from ..utils.logging import get_logger
from .ctrlfile import read_control_json, write_control_json

__all__ = [
    "LEASE_FILE",
    "TRAIN",
    "SERVE",
    "ARBITER",
    "LeaseGrant",
    "LeaseLedger",
    "ResizeDirective",
    "ServeDirective",
    "ServeLeaseClient",
    "TrainLeaseClient",
]

log = get_logger("flextree.runtime")

LEASE_FILE = "lease_ledger.json"
_ACK_FMT = "lease_ack_{holder}.json"

# holder names: the two tenants plus the arbiter's own parking slot for
# chips mid-handoff (revoked from one holder, not yet granted to the other)
TRAIN, SERVE, ARBITER = "train", "serve", "arbiter"

# injection point for tests (patch this, not time.time): lease files are
# read across processes, so stamps are wall time like heartbeat beats
_wall = time.time


@dataclasses.dataclass(frozen=True)
class LeaseGrant:
    """One published ledger state: who holds which chips, at which epoch.

    ``grants`` maps holder → a sorted tuple of chip ids.  ``reason`` is
    forensic (what SLO reading drove the change); ``wall`` stamps when it
    was published."""

    epoch: int
    grants: dict
    wall: float
    reason: str = ""

    def chips(self, holder: str) -> tuple:
        return tuple(self.grants.get(holder, ()))

    def to_payload(self) -> dict:
        return {
            "epoch": self.epoch,
            "grants": {h: list(c) for h, c in sorted(self.grants.items())},
            "wall": self.wall,
            "reason": self.reason,
        }


class LeaseLedger:
    """The lease file pair on a heartbeat dir: single-writer publish
    (the arbiter), any-reader poll, per-holder acks.

    The ledger itself enforces only the mechanics (atomicity, epoch
    monotonicity, ack bookkeeping); *policy* — who loses chips when —
    lives in :class:`flextree_tpu_torch.arbiter.PoolArbiter`."""

    def __init__(self, dir: str):
        self.dir = dir
        os.makedirs(dir, exist_ok=True)

    @property
    def path(self) -> str:
        return os.path.join(self.dir, LEASE_FILE)

    def _ack_path(self, holder: str) -> str:
        return os.path.join(self.dir, _ACK_FMT.format(holder=holder))

    # ---- writer side (the arbiter) ----------------------------------------

    def publish(self, epoch: int, grants: dict, reason: str = "") -> LeaseGrant:
        """Atomically publish a new ledger state.  Epochs must strictly
        increase — a replayed or reordered publish is a protocol bug, not
        a race to smooth over."""
        cur = self.read()
        if cur is not None and epoch <= cur.epoch:
            raise ValueError(
                f"lease epoch must increase: {epoch} <= published {cur.epoch}"
            )
        seen: dict = {}
        for holder, chips in grants.items():
            for c in chips:
                if c in seen:
                    raise ValueError(
                        f"chip {c!r} granted to both {seen[c]!r} and "
                        f"{holder!r} at epoch {epoch}"
                    )
                seen[c] = holder
        grant = LeaseGrant(
            epoch=int(epoch),
            grants={h: tuple(sorted(c)) for h, c in grants.items()},
            wall=_wall(),
            reason=reason,
        )
        # CRC-trailered write (runtime.ctrlfile): a torn ledger must
        # parse-refuse on every reader, never half-parse as a grant
        write_control_json(self.dir, self.path, grant.to_payload())
        return grant

    # ---- reader side (every holder) ---------------------------------------

    def read(self) -> LeaseGrant | None:
        """The current ledger state (None before the first publish; a
        torn/garbage file parse-refuses to None too — the CRC trailer
        makes truncation at any byte offset detectable, and the replace
        discipline makes a mismatch transient)."""
        doc = read_control_json(self.path)
        if doc is None:
            return None
        try:
            return LeaseGrant(
                epoch=int(doc["epoch"]),
                grants={h: tuple(c) for h, c in doc["grants"].items()},
                wall=float(doc.get("wall", 0.0)),
                reason=str(doc.get("reason", "")),
            )
        except (ValueError, KeyError, TypeError, AttributeError):
            return None

    def ack(self, holder: str, epoch: int, control_epoch: int | None = None) -> None:
        """Record that ``holder`` now runs under ``epoch``'s grant.

        ``control_epoch`` (optional) names the coordination-protocol epoch
        the holder applied the grant under (``runtime.coordination``) —
        the fencing breadcrumb proving a multi-process tenant never acks
        a lease it did not group-apply."""
        payload = {"holder": holder, "epoch": int(epoch), "wall": _wall()}
        if control_epoch is not None:
            payload["control_epoch"] = int(control_epoch)
        write_control_json(self.dir, self._ack_path(holder), payload)

    def read_ack(self, holder: str) -> dict | None:
        """``holder``'s newest ack document, or None (never acked / torn
        — parse-refuses instead of raising on the arbiter thread).  One
        read serves both the epoch and the control-epoch stamp, so a
        caller never pairs fields from two different ack versions."""
        return read_control_json(self._ack_path(holder))

    def acked_epoch(self, holder: str) -> int:
        """The newest epoch ``holder`` acknowledged (-1: never acked)."""
        doc = self.read_ack(holder)
        try:
            return int(doc["epoch"]) if doc is not None else -1
        except (ValueError, KeyError, TypeError):
            return -1

    def acked_control_epoch(self, holder: str) -> int | None:
        """The coordination epoch stamped on ``holder``'s newest ack, when
        the tenant runs under the coordination protocol (None otherwise)."""
        doc = self.read_ack(holder)
        if doc is None:
            return None
        ce = doc.get("control_epoch")
        return int(ce) if ce is not None else None


@dataclasses.dataclass(frozen=True)
class ResizeDirective:
    """A grant change training has not applied yet: the new chip set and
    the ledger epoch to acknowledge once the rebuild lands.

    ``control_epoch`` names the coordination-protocol epoch that committed
    this resize (``runtime.coordination``) — set only when the tenant is a
    multi-process group, in which case the directive can ONLY come from a
    committed group decision and the lease ack is fenced on it.  ``topo``
    is the coordinator's replanned FT_TOPO spec for the new chip count,
    broadcast so every rank applies THE SAME plan (the same override the
    shrink commit carries)."""

    epoch: int
    chips: tuple
    reason: str = ""
    control_epoch: int | None = None
    topo: str | None = None

    @property
    def n(self) -> int:
        return len(self.chips)


class TrainLeaseClient:
    """Training's lease handle — what ``fit(arbiter=...)`` polls.

    ``on_resize(chips, plan)`` is the rebuild hook, the resize twin of
    ``Supervision.on_shrink``: return ``None`` to keep the current step
    (world-size-agnostic steps), a ``(step_fn, mesh, state_specs)``
    3-tuple, or the re-shard path's 5-tuple with checkpoint-layout
    converters for the new world.  ``configured`` is the full-inventory
    grant size (prices the replan; defaults to the largest grant seen).

    The client is deliberately dumb: it reports grant CHANGES and acks
    what the loop applied.  All sequencing safety lives in the ledger
    handshake — the arbiter cannot hand our revoked chips to serving
    until our ack exists, so a slow rebuild stretches the handoff instead
    of racing it.

    ``coordination`` (optional): a
    :class:`~flextree_tpu_torch.runtime.CoordinationHandle` when this tenant is
    a multi-process group.  A grant change then never becomes a directive
    directly — the group's coordinator PROPOSES a ``"resize"`` decision
    and every rank applies it through the committed control epoch
    (``fit``'s coordination gate), so no rank can resize alone.  The
    lease ack is fenced: :meth:`ack` refuses a directive that does not
    carry the committed control epoch, which is exactly "a cross-process
    tenant can never ack an epoch it didn't apply".
    """

    def __init__(
        self,
        ledger: LeaseLedger,
        *,
        holder: str = TRAIN,
        on_resize: Callable | None = None,
        initial_chips=None,
        configured: int | None = None,
        nbytes_hint: int = 4 << 20,
        poll_interval_s: float = 0.2,
        coordination=None,
        _mono=time.monotonic,
    ):
        self.ledger = ledger
        self.holder = holder
        self.on_resize = on_resize
        self.configured = configured
        self.nbytes_hint = nbytes_hint
        self.poll_interval_s = float(poll_interval_s)
        self.coordination = coordination
        self._proposed_lease_epoch = -1
        self._mono = _mono
        self._next_poll = 0.0
        self._applied_epoch = -1
        # the grant the step was BUILT for.  Pass it whenever you know it
        # (the builders do): with it, a first poll that reads a smaller
        # grant — an early revocation, or a restart mid-handoff against
        # the persistent heartbeat dir — is a resize directive like any
        # other.  Without it, the first observation is trusted as the
        # build world (convenience for tests and single-epoch runs).
        self._chips: tuple | None = (
            tuple(sorted(initial_chips)) if initial_chips is not None
            else None
        )

    def poll(self, step: int) -> ResizeDirective | None:
        """A pending grant change, or None.  Throttled file read; an
        epoch whose chip set matches what we already run is acked in
        place (e.g. the publish that granted OUR former chips to serving
        — our slice did not change again)."""
        now = self._mono()
        if now < self._next_poll:
            return None
        self._next_poll = now + self.poll_interval_s
        grant = self.ledger.read()
        if grant is None or grant.epoch <= self._applied_epoch:
            return None
        chips = grant.chips(self.holder)
        if self._chips is None:
            # first observation: adopt the current grant as the world we
            # were built for (the builder sized the mesh from it)
            self._adopt(grant.epoch, chips)
            return None
        if chips == self._chips:
            self._adopt(grant.epoch, chips)  # epoch moved, our slice didn't
            return None
        if self.configured is not None:
            self.configured = max(self.configured, len(chips))
        if self.coordination is not None:
            # group tenant: the observation is not authority.  The
            # coordinator turns it into a propose→ack→commit decision;
            # every rank (this one included) receives the directive from
            # the committed control epoch via fit's coordination gate.
            # Followers return straight away — building the payload
            # costs a planner solve, and only the coordinator's
            # proposal can land.
            if (
                self._proposed_lease_epoch < grant.epoch
                and self.coordination.is_coordinator
            ):
                payload = {
                    "lease_epoch": grant.epoch,
                    "chips": list(chips),
                    "reason": grant.reason,
                }
                if chips:
                    # broadcast the coordinator's replanned topology so
                    # every rank applies THE SAME plan (a skewed local
                    # calibration must not split the group — the same
                    # override the shrink commit carries)
                    from ..planner.choose import replan_for_survivors

                    configured = max(self.configured or len(chips), len(chips))
                    payload["topo"] = replan_for_survivors(
                        len(chips), self.nbytes_hint, configured=configured
                    ).to_ft_topo()
                proposed = self.coordination.propose(
                    "resize",
                    payload,
                    # one agreed boundary: on a shared-wire tenant a rank
                    # rebuilding to the new chip plan while a peer still
                    # steps the old one is a collective mismatch — the
                    # same reason coordinated replans name a boundary
                    apply_step=self.coordination.suggest_apply_step(),
                )
                if proposed is not None:
                    self._proposed_lease_epoch = grant.epoch
            return None
        return ResizeDirective(
            epoch=grant.epoch, chips=chips, reason=grant.reason
        )

    def _adopt(
        self, epoch: int, chips: tuple, control_epoch: int | None = None
    ) -> None:
        self._applied_epoch = epoch
        self._chips = chips
        if self.configured is None or len(chips) > self.configured:
            self.configured = len(chips)
        self.ledger.ack(self.holder, epoch, control_epoch=control_epoch)

    def ack(self, directive: ResizeDirective) -> None:
        """The loop applied ``directive`` (checkpointed, rebuilt,
        restored): acknowledge the epoch so the arbiter may hand the
        revoked chips on.

        Fenced under coordination: a group tenant's directive must carry
        the control epoch that committed it — an ack for a lease epoch
        this rank did not group-apply is refused loudly, never written."""
        if self.coordination is not None and directive.control_epoch is None:
            from .coordination import ProtocolViolation

            raise ProtocolViolation(
                f"lease epoch {directive.epoch} acked without a committed "
                "control epoch — a coordinated tenant may only ack resizes "
                "it applied through the group protocol"
            )
        self._adopt(
            directive.epoch, directive.chips,
            control_epoch=directive.control_epoch,
        )

    @property
    def chips(self) -> tuple:
        return self._chips or ()


@dataclasses.dataclass(frozen=True)
class ServeDirective:
    """A serving-grant change the fleet has not applied yet: the new chip
    set, split into what was gained and what was revoked relative to the
    fleet the manager currently runs.

    ``revoked`` chips carry the hard sequencing rule of the whole
    protocol: the manager must DRAIN the replicas on them (SIGTERM →
    drain-refusals → exit) before the epoch may be acked, because the ack
    is what releases those chips onward to training.  ``control_epoch``
    mirrors training's fencing: a coordinated (multi-process) serving
    tenant may only ack epochs it group-applied."""

    epoch: int
    chips: tuple
    added: tuple = ()
    revoked: tuple = ()
    reason: str = ""
    control_epoch: int | None = None

    @property
    def n(self) -> int:
        return len(self.chips)


class ServeLeaseClient:
    """Serving's lease handle — the :class:`TrainLeaseClient` twin.

    Where training's "apply" is a checkpoint → mesh rebuild → restore,
    serving's is a real-process fleet change: ``on_grant(chips)`` spawns
    a warmed ``replica_main.py`` process per gained chip (its endpoint
    file registers it with the front door), ``on_revoke(chips)``
    SIGTERM-drains the replicas on the revoked chips and returns only
    once the drain completed (every queued/in-flight request answered
    with a drain refusal the front door re-routes exactly-once).

    The ack is double-fenced:

    - **drain fence** — ``inflight`` (optional callable → the number of
      requests still in flight on the revoked replicas) is consulted at
      :meth:`ack`; a revocation acked while requests are in flight is a
      :class:`~flextree_tpu_torch.runtime.coordination.ProtocolViolation`,
      never a written ack.  This is the real-code twin of the lease
      model's ``serve-ack-before-drain`` mutation — the ledger handshake
      only protects chips if "acked" implies "no longer using them".
    - **control-epoch fence** — exactly like training's: a coordinated
      tenant's directive must carry the committed control epoch, or the
      ack is refused loudly.

    The client never spawns or signals anything itself — sequencing
    lives here, process mechanics live in the hooks — so tests can bind
    it to the protocol model with toy hooks and the chaos tool can
    bind the same object to real processes.
    """

    def __init__(
        self,
        ledger: LeaseLedger,
        *,
        holder: str = SERVE,
        on_grant: Callable | None = None,
        on_revoke: Callable | None = None,
        inflight: Callable | None = None,
        initial_chips=None,
        poll_interval_s: float = 0.2,
        coordination=None,
        _mono=time.monotonic,
    ):
        self.ledger = ledger
        self.holder = holder
        self.on_grant = on_grant
        self.on_revoke = on_revoke
        self.inflight = inflight
        self.poll_interval_s = float(poll_interval_s)
        self.coordination = coordination
        self._mono = _mono
        self._next_poll = 0.0
        self._applied_epoch = -1
        # the fleet the manager actually runs.  Pass it whenever you know
        # it (a restarted manager reconciling against live replica
        # processes does): with it, a first poll that reads a different
        # grant — a revoke published while we were down, a restart
        # mid-handoff — is a directive like any other.  Without it, the
        # first observation is trusted as the running fleet.
        self._chips: tuple | None = (
            tuple(sorted(initial_chips)) if initial_chips is not None
            else None
        )

    def poll(self) -> ServeDirective | None:
        """A pending grant change, or None.  Throttled file read; an
        epoch whose chip set matches the running fleet is acked in place
        (e.g. the publish that returned OUR former chips to training —
        our slice did not change again)."""
        now = self._mono()
        if now < self._next_poll:
            return None
        self._next_poll = now + self.poll_interval_s
        grant = self.ledger.read()
        if grant is None or grant.epoch <= self._applied_epoch:
            return None
        chips = grant.chips(self.holder)
        if self._chips is None:
            self._adopt(grant.epoch, chips)
            return None
        if chips == self._chips:
            self._adopt(grant.epoch, chips)  # epoch moved, our slice didn't
            return None
        cur = set(self._chips)
        new = set(chips)
        return ServeDirective(
            epoch=grant.epoch,
            chips=chips,
            added=tuple(sorted(new - cur)),
            revoked=tuple(sorted(cur - new)),
            reason=grant.reason,
        )

    def apply(self, directive: ServeDirective) -> None:
        """Drive one directive end to end in protocol order: drain the
        revoked replicas FIRST (the ack below is what releases their
        chips onward), then spawn onto the gained chips, then ack."""
        if directive.revoked and self.on_revoke is not None:
            self.on_revoke(directive.revoked)
        if directive.added and self.on_grant is not None:
            self.on_grant(directive.added)
        self.ack(directive)

    def _adopt(
        self, epoch: int, chips: tuple, control_epoch: int | None = None
    ) -> None:
        self._applied_epoch = epoch
        self._chips = chips
        self.ledger.ack(self.holder, epoch, control_epoch=control_epoch)

    def ack(self, directive: ServeDirective) -> None:
        """The fleet now matches ``directive``: acknowledge the epoch so
        the arbiter may hand the revoked chips on.  Refuses loudly — no
        ack is written — if requests are still in flight on a revocation
        (the drain fence) or, under coordination, if the directive does
        not carry the committed control epoch."""
        from .coordination import ProtocolViolation

        if self.coordination is not None and directive.control_epoch is None:
            raise ProtocolViolation(
                f"lease epoch {directive.epoch} acked without a committed "
                "control epoch — a coordinated tenant may only ack resizes "
                "it applied through the group protocol"
            )
        if directive.revoked and self.inflight is not None:
            n = int(self.inflight())
            if n > 0:
                raise ProtocolViolation(
                    f"lease epoch {directive.epoch} revokes chips "
                    f"{list(directive.revoked)} but {n} request(s) are "
                    "still in flight — acking now would release the chips "
                    "while replicas are mid-request (serve-ack-before-"
                    "drain); drain first"
                )
        self._adopt(
            directive.epoch, directive.chips,
            control_epoch=directive.control_epoch,
        )

    @property
    def chips(self) -> tuple:
        return self._chips or ()
