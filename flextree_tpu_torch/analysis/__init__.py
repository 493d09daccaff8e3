"""Static analysis: the schedule model checker and the protocol checker.

The port's copy of part of ``flextree_tpu/analysis``: the
:class:`~.base.Violation` record, the message-program checks of
``schedule_check`` that ``schedule.ir.compile_ir`` runs before it lowers a
program, the phase-program checks of the standalone reduce-scatter and
all-gather that ZeRO-1 runs, and ``protocol_check``'s exhaustive
exploration of the coordination, lease, RPC and KV-migration models.
The JAX package's HLO and jit-hygiene lints are not ported (ROADMAP.md,
Queue 1: 'JAX-specific static analysis, last'); its concurrency lint
comes with item 9d.
"""

from .base import Violation, violations_to_json
from .protocol_check import default_models, explore, run_protocol_check
from .schedule_check import (
    build_phase_program,
    check_ir,
    check_ir_families,
    check_phase_program,
    check_program,
    check_split_schedules,
    default_ir_matrix,
    default_phase_matrix,
    program_from_ir,
)

__all__ = [
    "Violation",
    "violations_to_json",
    "build_phase_program",
    "check_ir",
    "check_ir_families",
    "check_phase_program",
    "check_program",
    "check_split_schedules",
    "default_ir_matrix",
    "default_phase_matrix",
    "program_from_ir",
    "default_models",
    "explore",
    "run_protocol_check",
]
