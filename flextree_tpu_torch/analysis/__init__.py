"""Static analysis: the schedule model checker.

The port's copy of the IR part of ``flextree_tpu/analysis``: the
:class:`~.base.Violation` record, the message-program checks of
``schedule_check`` that ``schedule.ir.compile_ir`` runs before it lowers a
program, and the phase-program checks of the standalone reduce-scatter
and all-gather that ZeRO-1 runs.  The JAX package's HLO, jit-hygiene,
protocol and concurrency lints are not ported (ROADMAP.md, Queue 1:
'JAX-specific static analysis, last').
"""

from .base import Violation, violations_to_json
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
]
