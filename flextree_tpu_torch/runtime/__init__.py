"""Runtime supervision (the port's copies of ``flextree_tpu.runtime``'s
parts that the serving tier and the supervised training run need):

- :mod:`.ctrlfile` — length+CRC32-trailered JSON control files (endpoint
  files, heartbeats, handoff documents), the same format as the JAX
  package's;
- :mod:`.supervisor` — heartbeat/lease membership: HEALTHY / STRAGGLER /
  DEAD;
- :mod:`.watchdog` — the step deadline: a hung call becomes a typed
  ``StepTimeout`` and its worker thread is abandoned;
- :mod:`.preemption` — the SIGTERM "checkpoint now" flag
  (``PreemptionGuard``) and the off-step-path checkpoint writer
  (``BackgroundSaver``) that ``parallel.loop.fit``'s supervision uses.

The closed-loop planner feedback the supervised run arms lives in
``planner.feedback``.  The JAX package's leases, arbiter and coordinated
control plane are not ported (ROADMAP.md, Queue 1: 'Checkpoint,
supervision and feedback plumbing').
"""

from .ctrlfile import control_trailer, read_control_json, write_control_json
from .preemption import BackgroundSaver, PreemptionGuard
from .supervisor import (
    DEAD,
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
]
