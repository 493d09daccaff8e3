"""Runtime supervision (the port's copies of ``flextree_tpu.runtime``):

- :mod:`.ctrlfile` — length+CRC32-trailered JSON control files (endpoint
  files, heartbeats, handoff documents, the lease ledger, the
  coordination slots), the same format as the JAX package's;
- :mod:`.supervisor` — heartbeat/lease membership: HEALTHY / STRAGGLER /
  DEAD;
- :mod:`.watchdog` — the step deadline: a hung call becomes a typed
  ``StepTimeout`` and its worker thread is abandoned;
- :mod:`.preemption` — the SIGTERM "checkpoint now" flag
  (``PreemptionGuard``) and the off-step-path checkpoint writer
  (``BackgroundSaver``) that ``parallel.loop.fit``'s supervision uses;
- :mod:`.leases` — the arbiter's chip-lease ledger and the training and
  serving lease clients (``fit(arbiter=TrainLeaseClient(...))``);
- :mod:`.coordination` — the epoch-consensus control plane
  (propose → ack → commit) that ``Supervision(coordination=)`` drives;
- :mod:`.coord_model`, :mod:`.lease_model` — the explicit-state models of
  those two protocols that ``analysis.protocol_check`` enumerates.

The closed-loop planner feedback the supervised run arms lives in
``planner.feedback``.
"""

from .coordination import (
    ControlDecision,
    CoordinationAbandoned,
    CoordinationConfig,
    CoordinationHandle,
    CoordLedger,
    EpochFenced,
    ProtocolViolation,
)
from .ctrlfile import control_trailer, read_control_json, write_control_json
from .leases import (
    ARBITER,
    SERVE,
    TRAIN,
    LeaseGrant,
    LeaseLedger,
    ResizeDirective,
    ServeDirective,
    ServeLeaseClient,
    TrainLeaseClient,
)
from .preemption import BackgroundSaver, PreemptionGuard
from .supervisor import (
    DEAD,
    FT_LEASE_ENV,
    HEALTHY,
    STRAGGLER,
    MembershipView,
    PeerStatus,
    Supervisor,
    SupervisorConfig,
)
from .watchdog import (
    FT_STEP_TIMEOUT_ENV,
    StepTimeout,
    StepWatchdog,
    step_timeout_from_env,
)

__all__ = [
    "control_trailer",
    "read_control_json",
    "write_control_json",
    "HEALTHY",
    "STRAGGLER",
    "DEAD",
    "SupervisorConfig",
    "Supervisor",
    "PeerStatus",
    "MembershipView",
    "FT_STEP_TIMEOUT_ENV",
    "StepTimeout",
    "StepWatchdog",
    "step_timeout_from_env",
    "PreemptionGuard",
    "BackgroundSaver",
    "FT_LEASE_ENV",
    "LeaseGrant",
    "LeaseLedger",
    "ResizeDirective",
    "ServeDirective",
    "ServeLeaseClient",
    "TrainLeaseClient",
    "TRAIN",
    "SERVE",
    "ARBITER",
    "ControlDecision",
    "CoordLedger",
    "CoordinationAbandoned",
    "CoordinationConfig",
    "CoordinationHandle",
    "EpochFenced",
    "ProtocolViolation",
]
