"""Heartbeat/lease membership: who is alive, who is slow, who is gone.

The port's copy of ``flextree_tpu/runtime/supervisor.py``; the beat file
is the JAX package's, so either package's :class:`MembershipView` reads
the other's beats.  Every process runs a :class:`Supervisor` daemon
thread that writes a small lease-stamped beat file (rank, pid, step
counter, step-duration EWMA) into a shared directory every
``interval_s``; any process reads the directory back through a
:class:`MembershipView` and classifies each peer:

- **healthy** — beat younger than ``straggler_s``;
- **straggler** — beat older than ``straggler_s`` but inside the
  ``lease_s`` budget (a SIGSTOP'd or badly stalled process: its
  heartbeat thread is frozen with it), or a healthy beat whose
  step-duration EWMA is ``ewma_factor``× the median of its peers (a
  slow-but-alive rank, the classic straggler);
- **dead** — lease expired: no beat for ``lease_s``.  A kill -9 leaves
  exactly this signature.

A file-per-rank directory works on one host and on any shared
filesystem; each write is atomic and CRC-trailered
(:mod:`.ctrlfile`), so a reader never sees a torn beat.  Classification
is pure arithmetic over (now - beat wall time), injectable for tests via
the module's ``_wall`` hook.  The thresholds ride env knobs
(``FT_LEASE``, ``FT_STRAGGLER``).  The serving replicas
(``serving.replica_main``) beat here and the front door
(``serving.frontdoor``) routes from the view.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass

from ..utils.logging import get_logger
from .ctrlfile import read_control_json, write_control_json

__all__ = [
    "HEALTHY",
    "STRAGGLER",
    "DEAD",
    "FT_LEASE_ENV",
    "FT_STRAGGLER_ENV",
    "SupervisorConfig",
    "Supervisor",
    "PeerStatus",
    "MembershipView",
]

log = get_logger("flextree.runtime")

HEALTHY, STRAGGLER, DEAD = "healthy", "straggler", "dead"

# env knobs: the lease budget in seconds (no beat for this long -> dead) and the
# straggler threshold (stale-but-leased, or EWMA-outlier)
FT_LEASE_ENV = "FT_LEASE"
FT_STRAGGLER_ENV = "FT_STRAGGLER"

# injection point for the tests (patch this, not time.time): beats are
# stamped with wall time because readers live in OTHER processes — a
# monotonic clock has no cross-process epoch
_wall = time.time

_BEAT_FMT = "hb_{rank:05d}.json"


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    return float(raw) if raw else default


@dataclass(frozen=True)
class SupervisorConfig:
    """One process's membership in a supervised group.

    ``rank``: this process's id in the group (any stable small int —
    process index at launch).  ``dir``: the shared heartbeat directory.
    ``interval_s`` must be comfortably under ``straggler_s`` (a healthy
    process misses classification windows otherwise); ``lease_s`` is the
    death budget — how long a silent peer is given before survivors
    replan around it.
    """

    rank: int
    dir: str
    interval_s: float = 0.25
    straggler_s: float = 1.0
    lease_s: float = 3.0
    ewma_factor: float = 3.0  # EWMA > factor x peer median -> straggler

    @classmethod
    def from_env(cls, rank: int, dir: str, **overrides) -> "SupervisorConfig":
        kw = dict(
            straggler_s=_env_float(FT_STRAGGLER_ENV, cls.straggler_s),
            lease_s=_env_float(FT_LEASE_ENV, cls.lease_s),
        )
        kw.update(overrides)
        return cls(rank=rank, dir=dir, **kw)


class Supervisor:
    """The per-process heartbeat emitter: a daemon thread owning one beat
    file.  The step loop feeds it progress via :meth:`record_step`; the
    thread publishes the latest (step, EWMA) every ``interval_s`` — so
    the step path's cost is two attribute stores, never an fsync.

    Context-manager friendly::

        with Supervisor(SupervisorConfig(rank=0, dir=hb)) as sup:
            for step in ...:
                ...
                sup.record_step(step, duration_s)
    """

    def __init__(self, cfg: SupervisorConfig):
        from ..utils.profiling import Ewma

        self.cfg = cfg
        self._step = 0
        self._ewma = Ewma()  # the shared EWMA definition, one alpha
        self._beats = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        os.makedirs(cfg.dir, exist_ok=True)

    # ---- producer side (the step loop) ------------------------------------

    def record_step(self, step: int, duration_s: float | None = None) -> None:
        """Publish step progress (and optionally its duration, folded into
        the straggler EWMA — ``profiling.Ewma``, the one definition both
        the beat payload and any host-side accounting share)."""
        self._step = int(step)
        if duration_s is not None:
            self._ewma.update(duration_s * 1e3)

    @property
    def _ewma_ms(self) -> float | None:
        return self._ewma.value

    # ---- the beat ---------------------------------------------------------

    @property
    def beat_path(self) -> str:
        return os.path.join(self.cfg.dir, _BEAT_FMT.format(rank=self.cfg.rank))

    def beat_now(self) -> None:
        """Write one beat immediately (atomic: tmp + replace)."""
        payload = {
            "rank": self.cfg.rank,
            "pid": os.getpid(),
            "step": self._step,
            "ewma_ms": self._ewma_ms,
            "wall": _wall(),
            "beats": self._beats,
        }
        from ..obs import record_event

        record_event(
            "heartbeat", hb_rank=self.cfg.rank, step=self._step,
            ewma_ms=self._ewma_ms, beats=self._beats,
        )
        # CRC-trailered write (runtime.ctrlfile): a truncated or torn beat
        # must parse-refuse on the reader, never half-parse as a fresh beat
        write_control_json(self.cfg.dir, self.beat_path, payload)
        self._beats += 1

    def _loop(self) -> None:
        while not self._stop.wait(self.cfg.interval_s):
            try:
                self.beat_now()
            except OSError as e:  # beat dir yanked: degrade loudly, once/loop
                log.warning("heartbeat write failed: %s", e)

    def start(self) -> "Supervisor":
        if self._thread is None:
            self.beat_now()  # first beat before the interval elapses
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="ft-heartbeat"
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    def __enter__(self) -> "Supervisor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


@dataclass(frozen=True)
class PeerStatus:
    """One peer's classification at poll time."""

    rank: int
    state: str  # HEALTHY | STRAGGLER | DEAD
    age_s: float  # seconds since its last beat
    step: int
    ewma_ms: float | None
    pid: int | None = None


class MembershipView:
    """The coordinator read side: poll the beat directory, classify peers.

    Stateless between polls except for remembering ranks ever seen, so a
    peer that dies *and its beat file is deleted* still reads as dead
    rather than silently vanishing from the roster.  ``configured``
    (optional) seeds the roster with ranks ``0..configured-1`` so a peer
    that never wrote a single beat — crashed before its first — is dead,
    not invisible.
    """

    def __init__(
        self,
        dir: str,
        *,
        straggler_s: float = 1.0,
        lease_s: float = 3.0,
        ewma_factor: float = 3.0,
        configured: int | None = None,
    ):
        self.dir = dir
        self.straggler_s = straggler_s
        self.lease_s = lease_s
        self.ewma_factor = ewma_factor
        self._seen: dict[int, dict] = {}
        self._last_states: dict[int, str] = {}  # lease-event edge detector
        # monotonic-per-rank wall guard: the newest wall stamp ever read
        # from each rank.  A beat whose wall moves BACKWARDS (NTP step,
        # clock skew across hosts) must not resurrect a lease-expired rank
        # or extend a live one — ages are computed against this watermark,
        # and the regression is a loud `clock_regression` flight event.
        self._max_wall: dict[int, float] = {}
        self._regressed: set[int] = set()  # event edge: once per episode
        if configured:
            for r in range(configured):
                self._seen.setdefault(r, {})

    @classmethod
    def for_config(cls, cfg: SupervisorConfig, configured=None) -> "MembershipView":
        return cls(
            cfg.dir,
            straggler_s=cfg.straggler_s,
            lease_s=cfg.lease_s,
            ewma_factor=cfg.ewma_factor,
            configured=configured,
        )

    def _read_beats(self) -> None:
        try:
            names = os.listdir(self.dir)
        except OSError:
            return
        from ..obs import record_event

        for name in names:
            if not (name.startswith("hb_") and name.endswith(".json")):
                continue
            beat = read_control_json(os.path.join(self.dir, name))
            if beat is None:
                continue  # torn/removed mid-read: next poll sees the replace
            try:
                rank, wall = int(beat["rank"]), float(beat["wall"])
            except (ValueError, KeyError, TypeError):
                continue
            watermark = self._max_wall.get(rank)
            if watermark is not None and wall < watermark:
                # clock regression: keep the watermark as the effective
                # stamp (never extend a lease from a stepped-back clock;
                # never resurrect an expired one), surface the episode
                # loudly ONCE until the clock catches back up
                if rank not in self._regressed:
                    self._regressed.add(rank)
                    record_event(
                        "clock_regression", peer=rank,
                        wall=wall, watermark=watermark,
                        regression_s=round(watermark - wall, 3),
                    )
                    log.warning(
                        "rank %d beat wall moved backwards by %.3fs "
                        "(NTP step / cross-host skew); holding its lease "
                        "age to the prior watermark",
                        rank, watermark - wall,
                    )
                beat = dict(beat, wall=watermark)
            else:
                self._max_wall[rank] = wall
                self._regressed.discard(rank)
            self._seen[rank] = beat

    def poll(self) -> dict[int, PeerStatus]:
        """Classify every known rank; see the module docstring for the
        healthy/straggler/dead rules."""
        self._read_beats()
        now = _wall()
        out: dict[int, PeerStatus] = {}
        ewma_by_rank = {
            r: b["ewma_ms"]
            for r, b in self._seen.items()
            if b and b.get("ewma_ms") is not None
        }

        def _peer_median(rank):
            # median of the OTHER ranks' EWMAs: including the candidate's
            # own beat makes the outlier test inert in small groups (in a
            # 2-rank world the upper median IS the slow rank's own value,
            # so `slow > factor * slow` can never fire)
            others = sorted(v for r, v in ewma_by_rank.items() if r != rank)
            return others[len(others) // 2] if others else None

        for rank, beat in sorted(self._seen.items()):
            if not beat:  # roster-seeded, never beat once
                out[rank] = PeerStatus(rank, DEAD, float("inf"), -1, None)
                continue
            age = max(0.0, now - beat["wall"])
            ewma = beat.get("ewma_ms")
            median = _peer_median(rank)
            if age > self.lease_s:
                state = DEAD
            elif age > self.straggler_s:
                state = STRAGGLER  # leased but stalled (SIGSTOP signature)
            elif (
                ewma is not None
                and median is not None
                and ewma > self.ewma_factor * median
            ):
                state = STRAGGLER  # alive but slow (EWMA outlier)
            else:
                state = HEALTHY
            out[rank] = PeerStatus(
                rank, state, age, int(beat.get("step", -1)), ewma,
                beat.get("pid"),
            )
        from ..obs import record_event

        for rank, status in out.items():
            prev = self._last_states.get(rank)
            if status.state != prev:
                self._last_states[rank] = status.state
                # classification EDGES only: a healthy 100-step run logs
                # one lease event per peer, not one per poll
                age = status.age_s
                record_event(
                    "lease", peer=rank, state=status.state, prev=prev,
                    age_s=round(age, 3) if age != float("inf") else None,
                    peer_step=status.step,
                )
        return out

    # convenience filters over one poll -------------------------------------

    def dead(self) -> list[int]:
        return [r for r, s in self.poll().items() if s.state == DEAD]

    def stragglers(self) -> list[int]:
        return [r for r, s in self.poll().items() if s.state == STRAGGLER]

    def alive_count(self) -> int:
        return sum(1 for s in self.poll().values() if s.state != DEAD)
