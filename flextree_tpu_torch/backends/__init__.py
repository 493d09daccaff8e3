"""Execution backends for FlexTree schedules.

- ``simulator``: single-process NumPy oracle (message-granular, clamped
  tails), a copy of the JAX package's — also the chaos oracle: a
  ``FaultPlan`` injects transport faults and rank kills, and the mailbox
  detects or recovers every one.
- the device path is :mod:`flextree_tpu_torch.parallel.allreduce`.
"""

from .simulator import (
    Fault,
    FaultDetected,
    FaultEvent,
    FaultPlan,
    ScheduleViolation,
    StageTimeout,
    simulate_allreduce,
    simulate_ring_allreduce,
    simulate_tree_allreduce,
)

__all__ = [
    "simulate_allreduce",
    "simulate_ring_allreduce",
    "simulate_tree_allreduce",
    "Fault",
    "FaultPlan",
    "FaultEvent",
    "FaultDetected",
    "StageTimeout",
    "ScheduleViolation",
]
