"""Runtime supervision (the port's copies of ``flextree_tpu.runtime``'s
JAX-free parts that the serving tier needs):

- :mod:`.ctrlfile` — length+CRC32-trailered JSON control files (endpoint
  files, heartbeats, handoff documents), the same format as the JAX
  package's;
- :mod:`.supervisor` — heartbeat/lease membership: HEALTHY / STRAGGLER /
  DEAD;
- :mod:`.watchdog` — the step deadline: a hung call becomes a typed
  ``StepTimeout`` and its worker thread is abandoned.

The leases, coordination and preemption guard of the JAX package come
with the port's supervision slice (ROADMAP Queue 1 item 9).
"""

from .ctrlfile import control_trailer, read_control_json, write_control_json
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
]
